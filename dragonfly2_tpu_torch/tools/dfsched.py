"""dfsched: explain scheduler rulings: decomposition, exclusions, payoff.

Counterpart of ``dragonfly2_tpu/tools/dfsched.py``. Reads the decision
ledger (``scheduler/decision_ledger.py``) and answers "why did child X get
parent Y, what did the runner-up score, and how did the choice pay off":
every ``kind=decision`` row is rendered with its per-term score breakdown
next to each candidate's total, every filtered-out parent with its
exclusion reason, sticky-refresh kept/fresh marks, and, when outcome rows
are present, the pieces and bytes each chosen parent served plus the
observed edge bandwidth beside the predicted rank.

Sources:
  --records PATH   a records JSONL file (or the directory holding
                   download.jsonl; the rotated .1 half is read first):
                   decisions and their kind=piece / kind=edge outcome
                   rows, stitched offline;
  --scheduler H:P  the live /debug/decisions ring on the scheduler's
                   --debug-port (no outcome join).

``--replay learned`` re-scores every logged ruling under the learned
parent-quality model next to the heuristic and renders the choice flips
with both picks' per-term decompositions. The model comes from ``--model
blob.npz`` (a ``trainer/params_io.py`` blob) or, when omitted, a seeded
fit over the records themselves (``trainer/pipeline.py``) on
``--device`` (default: the first CUDA card; ``cpu`` names the CPU).

Usage:
    python -m dragonfly2_tpu_torch.tools.dfsched --records records/ <task_id>
    python -m dragonfly2_tpu_torch.tools.dfsched --records download.jsonl --stats
    python -m dragonfly2_tpu_torch.tools.dfsched --scheduler 127.0.0.1:65100
    python -m dragonfly2_tpu_torch.tools.dfsched --records records/ --child f3a9
    python -m dragonfly2_tpu_torch.tools.dfsched --records records/ \
        --replay learned [--model bandwidth_mlp.npz | --device cpu]

Exit codes: 0 ok, 1 fetch or IO failure, 2 usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..common.podscope import _fmt_bytes, _get_json
from ..scheduler.decision_ledger import stitch_outcomes
from ..scheduler.evaluator import SCORE_TERMS

EXIT_OK = 0
EXIT_IO = 1
EXIT_USAGE = 2

# rendered term columns, in weight-table order
_TERM_COLS = tuple(name for name, _ in SCORE_TERMS)
_TERM_HDR = {"piece": "piece", "upload_success": "upsucc",
             "free_upload": "free", "host_type": "host",
             "locality": "local"}


def load_rows(path: str) -> list[dict]:
    """Rows from a records JSONL file or a records dir (rotated .1 half
    first so decisions precede their outcomes in replay order)."""
    if os.path.isdir(path):
        base = os.path.join(path, "download.jsonl")
        paths = [p for p in (base + ".1", base) if os.path.exists(p)]
        if not paths:
            raise FileNotFoundError(f"no download.jsonl under {path}")
    else:
        paths = [path]
    rows: list[dict] = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue       # torn tail line of a live file
    return rows


def render_decision(d: dict, *, max_candidates: int = 10) -> str:
    """One ruling, human-readable. Pure function over a stitched (or raw)
    decision row so it is testable offline and reusable by dfdiag
    --decisions."""
    chosen = d.get("chosen") or []
    kept = set(d.get("kept") or [])
    fresh = set(d.get("fresh") or [])
    outcomes = d.get("outcomes") or {}
    edges = d.get("edges") or {}
    if d.get("decision_kind") == "quarantine":
        # a quarantine-ladder ruling: no candidate table — the host, the
        # transition, and the evidence ARE the ruling
        return (f"decision {d.get('decision_id', '?')} (quarantine)  "
                f"host {d.get('host_id', '?')[-28:]}: "
                f"{d.get('from_state', '?')} -> {d.get('to_state', '?')}"
                f"  [{d.get('why', '')}]"
                f"  evidence={d.get('corrupt_evidence', 0)}"
                f" reporters={len(d.get('reporters') or [])}"
                + ("  SELF-FLAGGED" if d.get("self_flagged") else ""))
    out = [f"decision {d.get('decision_id', '?')} "
           f"({d.get('decision_kind', '?')}, {d.get('evaluator', '?')})  "
           f"task {d.get('task_id', '?')[:16]}  "
           f"child {d.get('peer_id', '?')[-16:]}"]
    cands = d.get("candidates") or []
    if cands:
        hdr = (f"  {'':>2} {'rank':>4} {'peer':>18} {'total':>7} "
               + " ".join(f"{_TERM_HDR[c]:>6}" for c in _TERM_COLS))
        out.append(hdr)
        for c in cands[:max_candidates]:
            pid = c.get("peer_id", "")
            mark = "*" if pid in chosen else " "
            terms = c.get("terms") or {}
            line = (f"  {mark:>2} {c.get('rank', 0):>4} {pid[-18:]:>18} "
                    f"{c.get('total', 0.0):>7.4f} "
                    + " ".join(f"{terms.get(t, 0.0):>6.3f}"
                               for t in _TERM_COLS))
            notes = []
            if pid == (chosen[0] if chosen else None):
                notes.append("chosen (main)")
            elif pid in chosen:
                notes.append("chosen")
            if pid in kept:
                notes.append("kept")
            elif pid in fresh and pid in chosen:
                notes.append("fresh")
            sub = c.get("substituted")
            if sub:
                notes.append("/".join(f"{k}<-{v}" for k, v in sub.items()))
            if notes:
                line += "   " + ", ".join(notes)
            out.append(line)
        if len(cands) > max_candidates:
            out.append(f"     … +{len(cands) - max_candidates} more "
                       f"candidates")
    elif d.get("decision_kind") == "preempt":
        pre = d.get("preempted") or {}
        out.append(
            f"  preempted: {pre.get('victim_class', '?')} child "
            f"{pre.get('victim_peer_id', '?')[-16:]}"
            + (f" (tenant {pre['victim_tenant']})"
               if pre.get("victim_tenant") else "")
            + f" lost parent {pre.get('parent_id', '?')[-16:]} so this "
            f"{d.get('qos_class', 'critical')} child could schedule")
    else:
        out.append("  (no legal candidates — every parent filtered)")
    excl = d.get("excluded") or []
    if excl:
        out.append("  excluded: " + "; ".join(
            f"{e.get('peer_id', '')[-14:]} {e.get('reason', '?')}"
            for e in excl))
    if outcomes:
        rank_of = {c.get("peer_id"): c.get("rank")
                   for c in d.get("candidates") or []}
        for pid, o in sorted(outcomes.items(),
                             key=lambda kv: -kv[1]["pieces"]):
            mean = o["cost_ms"] / o["pieces"] if o["pieces"] else 0.0
            line = (f"  outcome: {pid[-16:]} served {o['pieces']} "
                    f"piece(s) / {_fmt_bytes(o['bytes'])}, "
                    f"mean {mean:.1f}ms/piece (predicted rank "
                    f"{rank_of.get(pid, '?')})")
            edge = edges.get(pid)
            if edge and edge.get("bandwidth_bps"):
                line += (f", observed edge "
                         f"{_fmt_bytes(edge['bandwidth_bps'])}/s")
            out.append(line)
        runner = next((c for c in d.get("candidates") or []
                       if c.get("peer_id") not in chosen), None)
        if runner is not None:
            served = outcomes.get(runner.get("peer_id"), {}).get("pieces", 0)
            out.append(f"  runner-up: {runner.get('peer_id', '')[-16:]} "
                       f"scored {runner.get('total', 0.0):.4f}, "
                       f"served {served} piece(s)")
    return "\n".join(out)


def replay_learned(rows: list[dict], infer) -> dict:
    """Heuristic-vs-learned counterfactual over raw record rows, reusing
    the ledger's replay machinery wholesale. Returns the summary plus one
    entry per choice FLIP carrying both picks' per-term decompositions
    and their scores under each evaluator — the data ``render_flip``
    draws and ``--json`` emits verbatim."""
    from ..scheduler.decision_ledger import (replay_decisions, replay_regret,
                                             rescore_candidate,
                                             rescore_decision)
    decisions = [r for r in rows
                 if r.get("kind") == "decision" and r.get("candidates")]
    summary = replay_decisions(rows, evaluators=("default", "ml"),
                               infer=infer)
    regret = replay_regret(rows, evaluators=("default", "ml"), infer=infer)
    flips = []
    for d in decisions:
        ranked_h = rescore_decision(d, "default")
        ranked_m = rescore_decision(d, "ml", infer)
        if not ranked_h or not ranked_m or ranked_h[0] == ranked_m[0]:
            continue
        cands = {c.get("peer_id", ""): c for c in d["candidates"]}
        picks = {}
        for who, pid in (("heuristic", ranked_h[0]), ("learned",
                                                      ranked_m[0])):
            c = cands[pid]
            terms = c.get("terms") or {}
            picks[who] = {
                "peer_id": pid,
                "terms": {t: round(float(terms.get(t, 0.0)), 4)
                          for t in _TERM_COLS},
                "score_heuristic": round(rescore_candidate(
                    c, "default", d.get("host_id", "")), 4),
                "score_learned": round(rescore_candidate(
                    c, "ml", d.get("host_id", ""), infer), 4),
            }
        flips.append({"decision_id": d.get("decision_id", ""),
                      "task_id": d.get("task_id", ""),
                      "peer_id": d.get("peer_id", ""), **picks})
    return {"decisions_scored": len(decisions), "summary": summary,
            "regret": regret, "flips": flips}


def render_flip(flip: dict) -> str:
    """One choice flip: both picks' logged per-term decomposition side by
    side with the deltas, then each pick's score under each evaluator."""
    h, m = flip["heuristic"], flip["learned"]
    out = [f"flip {flip['decision_id']}  task {flip['task_id'][:16]}  "
           f"child {flip['peer_id'][-16:]}: heuristic keeps "
           f"{h['peer_id'][-16:]}, learned promotes {m['peer_id'][-16:]}",
           f"  {'':>10} {'peer':>18} "
           + " ".join(f"{_TERM_HDR[t]:>6}" for t in _TERM_COLS)
           + f" {'score_h':>8} {'score_ml':>8}"]
    for who, pick in (("heuristic", h), ("learned", m)):
        out.append(
            f"  {who:>10} {pick['peer_id'][-18:]:>18} "
            + " ".join(f"{pick['terms'][t]:>6.3f}" for t in _TERM_COLS)
            + f" {pick['score_heuristic']:>8.4f}"
            f" {pick['score_learned']:>8.4f}")
    out.append(
        f"  {'delta':>10} {'':>18} "
        + " ".join(f"{m['terms'][t] - h['terms'][t]:>+6.3f}"
                   for t in _TERM_COLS)
        + f" {m['score_heuristic'] - h['score_heuristic']:>+8.4f}"
        f" {m['score_learned'] - h['score_learned']:>+8.4f}")
    return "\n".join(out)


def render_replay(rep: dict, model_desc: str, limit: int = 8) -> str:
    pair = rep["summary"]["pairs"]["default_vs_ml"]
    logged = rep["summary"]["logged_choice_agreement"]
    out = [f"replay: heuristic vs learned ({model_desc}) over "
           f"{rep['decisions_scored']} ruling(s)",
           f"  choice flips: {len(rep['flips'])} "
           f"({pair['choice_flip_rate']:.1%})   rank agreement: "
           f"{pair['rank_agreement']:.3f}   logged-choice agreement: "
           f"heuristic {logged['default']:.3f} / learned "
           f"{logged['ml']:.3f}"]
    reg = rep["regret"]
    if reg["decisions_judged"]:
        ev = reg["evaluators"]
        out.append(
            f"  observed-bandwidth regret over {reg['decisions_judged']} "
            f"judged ruling(s): heuristic "
            f"{ev['default']['mean_regret']:.4f} vs learned "
            f"{ev['ml']['mean_regret']:.4f}   best-pick rate: "
            f"{ev['default']['best_pick_rate']:.1%} vs "
            f"{ev['ml']['best_pick_rate']:.1%}")
    else:
        out.append("  (no outcome rows joined — regret needs "
                   "kind=piece rows beside the decisions)")
    for flip in rep["flips"][-limit:]:
        out.append("")
        out.append(render_flip(flip))
    if len(rep["flips"]) > limit:
        out.append(f"\n  … +{len(rep['flips']) - limit} more flip(s)")
    return "\n".join(out)


def render_stats(stitched: dict) -> str:
    cov = stitched["coverage"]
    decisions = stitched["decisions"]
    by_kind: dict[str, int] = {}
    excl: dict[str, int] = {}
    for d in decisions:
        by_kind[d.get("decision_kind", "?")] = \
            by_kind.get(d.get("decision_kind", "?"), 0) + 1
        for e in d.get("excluded") or []:
            excl[e.get("reason", "?")] = excl.get(e.get("reason", "?"), 0) + 1
    out = [f"decisions: {len(decisions)} "
           f"({', '.join(f'{k}={v}' for k, v in sorted(by_kind.items()))})",
           f"outcome join: {cov['joined']}/{cov['piece_rows']} piece rows "
           f"stitched to a logged decision ({cov['ratio']:.1%})"]
    if excl:
        out.append("exclusions: " + ", ".join(
            f"{r}={n}" for r, n in sorted(excl.items(), key=lambda kv: -kv[1])))
    return "\n".join(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dfsched",
        description="decision-ledger inspector: score decomposition, "
                    "exclusions, outcome joins")
    p.add_argument("task_id", nargs="?", default="",
                   help="task id (prefix ok); default: the task with the "
                   "most logged decisions")
    p.add_argument("--records", default="",
                   help="records JSONL file, or the scheduler records dir "
                   "holding download.jsonl")
    p.add_argument("--scheduler", default="",
                   help="scheduler --debug-port host:port serving "
                   "/debug/decisions (live ring; no outcome join)")
    p.add_argument("--child", default="",
                   help="filter to one child peer id (suffix ok)")
    p.add_argument("--limit", type=int, default=8,
                   help="newest-N decisions to render (default 8)")
    p.add_argument("--stats", action="store_true",
                   help="coverage + exclusion summary instead of rulings")
    p.add_argument("--replay", default="", choices=("", "learned"),
                   help="'learned': re-score every ruling under the "
                   "learned parent-quality model vs the heuristic and "
                   "render the choice flips with per-term deltas "
                   "(needs --records)")
    p.add_argument("--model", default="",
                   help="serialized model blob for --replay learned "
                   "(trainer/params_io.py artifact); omit to fit one "
                   "from the records themselves")
    p.add_argument("--seed", type=int, default=0,
                   help="fit seed when --replay learned fits from the "
                   "records (ignored with --model)")
    p.add_argument("--device", default=None,
                   help="torch device of the --replay learned fit "
                   "(default: the first CUDA card; 'cpu' names the CPU)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable JSON instead of rendered text")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="HTTP timeout for --scheduler fetches")
    return p


def _pick_task(decisions: list[dict], prefix: str) -> str:
    if prefix:
        return prefix
    counts: dict[str, int] = {}
    for d in decisions:
        tid = d.get("task_id", "")
        counts[tid] = counts.get(tid, 0) + 1
    return max(counts, key=counts.get) if counts else ""


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.replay:
            if not args.records:
                # the live ring would work too, but its rows lack the
                # joined outcomes the regret judgment needs — keep the
                # mode honest and file-fed
                print("dfsched: --replay needs --records PATH",
                      file=sys.stderr)
                return EXIT_USAGE
            rows = load_rows(args.records)
            from ..trainer.serving import make_mlp_infer
            if args.model:
                with open(args.model, "rb") as f:
                    infer = make_mlp_infer(f.read())
                desc = (f"model {getattr(infer, 'version', '?')} from "
                        f"{os.path.basename(args.model)}")
            else:
                from ..trainer.pipeline import train_decision_model
                fitted = train_decision_model(rows, seed=args.seed,
                                              use_mesh=False,
                                              device=args.device)
                if fitted is None:
                    print("dfsched: too few usable rows to fit a replay "
                          "model — pass --model blob.npz or more records",
                          file=sys.stderr)
                    return EXIT_IO
                infer = make_mlp_infer(fitted[0])
                desc = (f"model {fitted[1]['version']} fit from these "
                        f"records, seed {args.seed}")
            rep = replay_learned(rows, infer)
            if args.json:
                print(json.dumps({"model": desc, **rep}, indent=2))
            else:
                print(render_replay(rep, desc, limit=args.limit))
            return EXIT_OK
        if args.scheduler:
            # fetch the whole ring (bounded server-side at DEFAULT_RING_ROWS)
            # and slice locally: asking for only --limit rows would truncate
            # to the newest N across ALL tasks BEFORE the task/child filter
            # runs, under-filling the output exactly on a busy scheduler
            from ..scheduler.decision_ledger import DEFAULT_RING_ROWS
            snap = _get_json(
                f"http://{args.scheduler}/debug/decisions"
                f"?task={args.task_id}&peer={args.child}"
                f"&limit={max(args.limit, DEFAULT_RING_ROWS)}", args.timeout)
            stitched = {"decisions": snap.get("decisions") or [],
                        "coverage": {"piece_rows": 0, "joined": 0,
                                     "ratio": 1.0}}
            stats = snap.get("stats") or {}
        elif args.records:
            rows = load_rows(args.records)
            stitched = stitch_outcomes(rows)
            stats = {}
        else:
            print("dfsched: need --records PATH or --scheduler host:port",
                  file=sys.stderr)
            return EXIT_USAGE
        decisions = stitched["decisions"]
        task = _pick_task(decisions, args.task_id)
        picked = [d for d in decisions
                  if d.get("task_id", "").startswith(task)
                  and (not args.child
                       or d.get("peer_id", "").endswith(args.child))]
        if args.json:
            print(json.dumps({"coverage": stitched["coverage"],
                              "stats": stats,
                              "decisions": picked[-args.limit:]}, indent=2))
            return EXIT_OK
        if args.stats:
            if stats:
                print(f"ledger: {json.dumps(stats)}")
            print(render_stats(stitched))
            return EXIT_OK
        if not picked:
            print("dfsched: no decisions recorded"
                  + (f" for task {task[:16]}" if task else ""),
                  file=sys.stderr)
            return EXIT_OK
        for d in picked[-args.limit:]:
            print(render_decision(d))
            print()
        print(render_stats(stitched))
        return EXIT_OK
    except (OSError, ValueError) as exc:
        # unreachable scheduler / missing or torn file: one line, no
        # traceback — same CI contract as dfdiag
        print(f"dfsched: {type(exc).__name__}: {exc}", file=sys.stderr)
        return EXIT_IO


if __name__ == "__main__":
    sys.exit(main())
