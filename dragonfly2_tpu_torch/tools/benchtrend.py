"""benchtrend: one table over every committed BENCH_pr*.json.

Counterpart of ``dragonfly2_tpu/tools/benchtrend.py``, a copy: the
per-PR dfbench artifacts folded into one table, one row per artifact with
its headline metric(s) and whether its baseline ``schedule_digest`` still
matches BENCH_pr3's (the byte-identical purity spine every observer PR
gates on).

Usage:
    python -m dragonfly2_tpu_torch.tools.benchtrend [--dir REPO] [--json]

Exit codes: 0 when every row is clean; 1 when no artifact is found or a
file is torn or unreadable; 2 when a committed artifact's digest drifted
off BENCH_pr3's. Pure functions over the JSON files.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

_PR_RE = re.compile(r"BENCH_pr(\d+)\.json$")


def _headline(pr: int, d: dict) -> str:
    """One human line per artifact: the number the PR existed to move.
    Defensive: a key that moved in a later PR degrades to '?', never a
    crash — benchtrend must render the whole trajectory even when one
    artifact's schema drifted."""
    try:
        if pr == 3:
            return (f"{d.get('daemons')}d x {d.get('pieces')}p baseline, "
                    f"seed_served={d.get('seed_served_ratio', '?')}, "
                    f"makespan={d.get('wall_ms', '?')}ms")
        if pr == 4:
            r = d.get("p2p_served_ratio") or {}
            return ("scheds-down p2p ratio: " + ", ".join(
                f"{k}={v}" for k, v in sorted(r.items())))
        if pr == 5:
            imp = d.get("improvement") or {}
            lag = imp.get("max_loop_lag_ms") or {}
            return (f"max loop lag legacy={lag.get('legacy', '?')}ms vs "
                    f"zero_stall={lag.get('zero_stall', '?')}ms")
        if pr == 6:
            amp = d.get("amplification") or {}
            bn = d.get("baseline_bottleneck") or {}
            return (f"amplification baseline="
                    f"{amp.get('baseline', '?')} vs no_pex="
                    f"{amp.get('scheds_down_no_pex', '?')}, bottleneck "
                    f"{bn.get('src', '?')}->{bn.get('dst', '?')}")
        if pr == 8:
            return (f"{d.get('decision_rows', '?')} decision rows, "
                    f"ledger_pure={d.get('ledger_pure', '?')}")
        if pr == 9:
            g = (d.get("growth_factor") or {}).get("cold_relay", "?")
            return f"cold relay makespan growth x{g}"
        if pr == 10:
            return (f"origin after epoch0 "
                    f"{d.get('origin_bytes_after_first_epoch', '?')} B, "
                    f"alias_zero={d.get('alias_pull_zero_transfer', '?')}")
        if pr == 11:
            return (f"fg p99 ratio qos={d.get('fg_p99_ratio_qos', '?')}x "
                    f"vs no_qos={d.get('fg_p99_ratio_no_qos', '?')}x, "
                    f"holds_slo={d.get('fg_holds_slo', '?')}")
        if pr == 12:
            w = d.get("wasted_ratio") or {}
            return (f"wasted on={w.get('on', '?')} off={w.get('off', '?')}, "
                    f"pure={d.get('quarantine_pure', '?')}")
        if pr == 13:
            oc = (d.get("origin_copies") or {}).get("fed_hier") or {}
            return (f"hier_beats_naive={d.get('hier_beats_naive', '?')}, "
                    f"origin copies "
                    f"{oc.get(max(oc, default=''), '?') if oc else '?'}")
        if pr == 14:
            return (f"sharded speedup={d.get('speedup', '?')}x"
                    f"@{d.get('speedup_size', '?')}, "
                    f"tree_bounded={d.get('tree_bounded', '?')}")
        if pr == 16:
            rps = d.get("rulings_per_sec") or {}
            big = str((d.get("fleets") or ["?"])[-1])
            return (f"{rps.get(big, '?')}/s rulings @ {big}d, "
                    f"pure={d.get('profiler_pure', '?')}"
                    f"/{d.get('ctrl_profiler_pure', '?')}")
        if pr == 17:
            oh = d.get("origin_hits_after_restart") or {}
            return (f"origin hits durable={oh.get('durable', '?')} vs "
                    f"amnesia={oh.get('amnesia', '?')}, "
                    f"sticky={d.get('affinity_sticky', '?')}")
        if pr == 18:
            lat = d.get("detection_latency_intervals") or {}
            return (f"{len(d.get('detected_kinds') or [])}/6 kinds, "
                    f"worst latency "
                    f"{max(lat.values(), default='?')} intervals, "
                    f"fp={sum((d.get('false_positives') or {}).values())}, "
                    f"{d.get('bytes_per_announce', '?')} B/announce")
        if pr == 19:
            reg = d.get("regret") or {}
            return (f"regret learned={reg.get('learned', '?')} vs "
                    f"heuristic={reg.get('heuristic', '?')}, "
                    f"flip={d.get('flip_rate', '?')}, "
                    f"beats={d.get('learned_beats_heuristic', '?')}, "
                    f"deterministic={d.get('trained_deterministic', '?')}"
                    f"/{d.get('learned_deterministic', '?')}")
    except Exception:  # noqa: BLE001 - schema drift degrades, never crashes
        pass
    return "?"


def collect(repo_dir: str) -> list[dict]:
    """One row per BENCH_pr*.json, ordered by PR number. ``digest_vs_pr3``
    is True/False when the artifact carries a top-level
    ``schedule_digest`` (the purity spine), None when the bench predates
    or has no baseline leg. Raises on unparseable JSON — a torn
    committed artifact IS the finding."""
    files = sorted(glob.glob(os.path.join(repo_dir, "BENCH_pr*.json")),
                   key=lambda p: int(_PR_RE.search(p).group(1)))
    pr3_digest = ""
    rows = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        pr = int(_PR_RE.search(path).group(1))
        digest = d.get("schedule_digest") or ""
        if pr == 3:
            pr3_digest = digest
        rows.append({
            "pr": pr,
            "file": os.path.basename(path),
            "bench": d.get("bench") or "?",
            "headline": _headline(pr, d),
            "schedule_digest": digest,
            "digest_vs_pr3": (None if not digest or not pr3_digest
                              else digest == pr3_digest),
        })
    # files sort by PR already, but pr3 must have been seen before any
    # comparison — it is the lowest committed PR number by construction
    for r in rows:
        if r["schedule_digest"] and pr3_digest:
            r["digest_vs_pr3"] = r["schedule_digest"] == pr3_digest
    return rows


def render(rows: list[dict]) -> str:
    out = [f"{'pr':>4} {'bench':<20} {'=pr3':<5} headline"]
    for r in rows:
        gate = {True: "ok", False: "DRIFT", None: "-"}[r["digest_vs_pr3"]]
        out.append(f"{r['pr']:>4} {r['bench']:<20} {gate:<5} "
                   f"{r['headline']}")
    drift = [r["file"] for r in rows if r["digest_vs_pr3"] is False]
    out.append(f"{len(rows)} artifacts; "
               + (f"DIGEST DRIFT: {', '.join(drift)}" if drift
                  else "all digest gates reference pr3"))
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="benchtrend",
        description="fold every committed BENCH_pr*.json into one "
                    "perf-trajectory table")
    p.add_argument("--dir", default=".",
                   help="repo root holding the BENCH_pr*.json artifacts")
    p.add_argument("--json", action="store_true",
                   help="machine-readable rows instead of the table")
    args = p.parse_args(argv)
    try:
        rows = collect(args.dir)
    except (OSError, ValueError) as exc:
        print(f"benchtrend: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    if not rows:
        print(f"benchtrend: no BENCH_pr*.json under {args.dir}",
              file=sys.stderr)
        return 1
    print(json.dumps(rows, indent=2) if args.json else render(rows))
    # a committed artifact whose baseline digest drifted off pr3 is a
    # broken purity gate — exit non-zero so CI can hang the run on it
    return 2 if any(r["digest_vs_pr3"] is False for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
