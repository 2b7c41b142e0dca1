"""Scheduler decision ledger: every ruling, explained, joinable, replayable.

Counterpart of ``dragonfly2_tpu/scheduler/decision_ledger.py``.
``Scheduling._decide`` emits one ``kind=decision`` row per
``find_parents``/``refresh_parents`` call: the full candidate set with the
per-term score decomposition (``Evaluator.explain``), every filtered-out
parent with its exclusion reason, the chosen offer, and sticky-refresh
kept/fresh attribution. This module is everything downstream of that
emission:

* ``DecisionLedger`` — bounded in-memory ring for live inspection
  (``GET /debug/decisions`` on the scheduler's ``--debug-port``,
  ``add_decision_routes``) that also forwards rows into ``records.py``,
  where they interleave with the ``kind=piece`` / ``kind=edge`` outcome
  rows they join against;
* ``stitch_outcomes`` — the join: piece rows carry the child's newest
  ``decision_id`` (stamped at scoring time), edge rows join by
  (task, child, parent) keys;
* the counterfactual replay: re-score logged candidate sets under another
  evaluator (default vs ``nt`` vs ``ml``) entirely offline — rank
  agreement, choice-flip rates, a deterministic ``decision_digest`` and
  the observed-bandwidth regret of each evaluator's pick.

Everything below ``DecisionLedger`` is pure (no clock, no IO) so the
replay is deterministic.
"""

from __future__ import annotations

import hashlib
import json
import math
import time
from collections import Counter, deque

from .evaluator import SCORE_TERMS, rtt_locality_score, weighted_total

DEFAULT_RING_ROWS = 512

#: evaluators the offline replay can re-score a logged candidate set under
REPLAY_EVALUATORS = ("default", "nt", "ml")


class DecisionLedger:
    """Bounded ring of recent decision rows + forwarding into records.

    Attached as ``Scheduling.decision_sink`` by the scheduler bootstrap;
    ``records`` may be None (memory-only scheduler).
    """

    def __init__(self, records=None, max_rows: int = DEFAULT_RING_ROWS):
        self.records = records
        self._ring: deque = deque(maxlen=max_rows)
        self.decisions_total = 0
        self.by_kind: Counter = Counter()
        self.excluded_by_reason: Counter = Counter()

    def on_decision(self, row: dict) -> None:
        row = dict(row)
        row.setdefault("created_at", time.time())
        self._ring.append(row)
        self.decisions_total += 1
        self.by_kind[row.get("decision_kind", "")] += 1
        for ex in row.get("excluded") or []:
            self.excluded_by_reason[ex.get("reason", "")] += 1
        if self.records is not None:
            self.records.on_decision(row)

    def stats(self) -> dict:
        """Compact counters: is the pod herding onto an exclusion reason,
        and how many rulings has it taken."""
        return {
            "total": self.decisions_total,
            "by_kind": dict(self.by_kind),
            "excluded_by_reason": dict(self.excluded_by_reason),
            "ring": len(self._ring),
        }

    def state_bytes(self) -> int:
        """Bytes of ledger state (the ring and its counters) for
        ``/debug/ctrl``; a deep sizeof walk, at snapshot cadence only."""
        from ..common.sizeof import deep_sizeof
        seen: set = set()
        return sum(deep_sizeof(o, seen) for o in (
            self._ring, self.by_kind, self.excluded_by_reason))

    def snapshot(self, task_id: str = "", peer_id: str = "",
                 limit: int = 64) -> dict:
        """Newest-last slice of the ring (``task_id`` prefix, ``peer_id``
        suffix, at most ``limit`` rows)."""
        rows = [r for r in self._ring
                if (not task_id or r.get("task_id", "").startswith(task_id))
                and (not peer_id or r.get("peer_id", "").endswith(peer_id))]
        return {"stats": self.stats(),
                "decisions": rows[-max(limit, 1):]}


def add_decision_routes(router, ledger: DecisionLedger) -> None:
    """``GET /debug/decisions`` (``?task=`` prefix, ``?peer=`` suffix,
    ``?limit=``), on the scheduler launcher's ``--debug-port`` server next
    to ``/debug/cluster``."""

    async def decisions(_params, query):
        try:
            limit = int(query.get("limit", "64"))
        except ValueError:
            return 400, "limit must be an integer"
        return 200, ledger.snapshot(task_id=query.get("task", ""),
                                    peer_id=query.get("peer", ""),
                                    limit=limit)

    router.add_get("/debug/decisions", decisions)


# ------------------------------------------------------------- outcome join

def stitch_outcomes(rows: list[dict]) -> dict:
    """Join ``kind=piece`` / ``kind=edge`` outcome rows to the decision
    that caused them.

    Primary key: the ``decision_id`` stamped on each piece row at scoring
    time. Fallback (rows from a scheduler restarted mid-task, or edge rows
    which aggregate a whole flight): the child's newest decision whose
    ``chosen`` set names the serving parent. Returns the decision rows
    (in input order) annotated with ``outcomes``/``edges`` per parent,
    plus the join-coverage numbers the e2e acceptance gates on (≥95% of
    piece rows must stitch)."""
    decisions: dict[str, dict] = {}
    order: list[dict] = []
    by_child: dict[tuple, list[dict]] = {}
    for r in rows:
        if r.get("kind") != "decision":
            continue
        d = dict(r)
        d["outcomes"] = {}
        d["edges"] = {}
        decisions[d.get("decision_id", "")] = d
        order.append(d)
        by_child.setdefault((d.get("task_id"), d.get("peer_id")),
                            []).append(d)

    def newest_naming(task_id, child_id, parent_id):
        for d in reversed(by_child.get((task_id, child_id), [])):
            if parent_id in (d.get("chosen") or []):
                return d
        return None

    piece_rows = joined = 0
    for r in rows:
        kind = r.get("kind")
        if kind == "piece":
            piece_rows += 1
            parent_id = r.get("parent_peer_id", "")
            d = decisions.get(r.get("decision_id", ""))
            if d is None:
                d = newest_naming(r.get("task_id"), r.get("peer_id"),
                                  parent_id)
            if d is None:
                continue
            joined += 1
            o = d["outcomes"].setdefault(
                parent_id, {"pieces": 0, "bytes": 0, "cost_ms": 0.0})
            o["pieces"] += 1
            o["bytes"] += r.get("piece_length", 0) or 0
            o["cost_ms"] += float(r.get("cost_ms", 0) or 0)
        elif kind == "edge":
            d = newest_naming(r.get("task_id"), r.get("dst_peer_id"),
                              r.get("src_peer_id", ""))
            if d is not None:
                d["edges"][r.get("src_peer_id", "")] = {
                    "bytes": r.get("bytes", 0),
                    "pieces": r.get("pieces", 0),
                    "bandwidth_bps": r.get("bandwidth_bps", 0),
                }
    return {
        "decisions": order,
        "coverage": {
            "piece_rows": piece_rows,
            "joined": joined,
            "ratio": round(joined / piece_rows, 4) if piece_rows else 1.0,
        },
    }


# ------------------------------------------------------ counterfactual replay

def synthetic_rtt_us(child_host_id: str, parent_host_id: str) -> float:
    """Deterministic stand-in RTT for replaying ``nt`` over decision rows
    that carry no measured ``rtt_us`` (the probe store had no data, or the
    rows come from the fakepod sim): log-uniform over 50us (ICI
    neighborhood) .. 10ms (congested WAN), a pure hash of the directed
    host pair — the same pair always replays the same link."""
    h = hashlib.sha256(
        f"{child_host_id}->{parent_host_id}".encode()).digest()
    frac = int.from_bytes(h[:8], "big") / 2.0 ** 64
    return 50.0 * (10_000.0 / 50.0) ** frac


# Deterministic stand-in for a served parent-quality model (logistic over
# trainer/features.PARENT_FEATURES). Weighted toward piece coverage and
# locality, penalizing concurrent upload load — a plausible learned shape
# that genuinely disagrees with the heuristic on loaded parents, so the
# replay's rank-agreement columns measure something until ROADMAP item 1's
# trained model is passed in instead (``infer=`` hooks it in verbatim).
_STANDIN_W = (1.2, 0.8, 0.5, 0.4, 1.6, 0.02, -0.08)
_STANDIN_B = -1.0


def standin_ml_infer(rows: list[list[float]]) -> list[float]:
    out = []
    for row in rows:
        z = _STANDIN_B + sum(w * x for w, x in zip(_STANDIN_W, row))
        out.append(1.0 / (1.0 + math.exp(-z)))
    return out


def rescore_candidate(cand: dict, evaluator_name: str,
                      child_host_id: str, infer=None) -> float:
    """One candidate's score under ``evaluator_name``, from the logged
    decomposition alone — no live Peer state needed."""
    terms = cand.get("terms") or {}
    if evaluator_name == "default":
        # rows logged by the nt evaluator carry the RTT-substituted score
        # in terms["locality"] — replaying "default" over them must
        # restore the static locality (features[4] in the trainer layout)
        # or the "default vs nt" comparison degenerates to nt-vs-itself
        if "locality" in (cand.get("substituted") or {}):
            feats = cand.get("features")
            if feats and len(feats) >= 5:
                terms = dict(terms, locality=feats[4])
        return weighted_total(terms)
    if evaluator_name == "nt":
        rtt_us = cand.get("rtt_us")
        if rtt_us is None:
            rtt_us = synthetic_rtt_us(child_host_id,
                                      cand.get("host_id", ""))
        subbed = dict(terms)
        subbed["locality"] = rtt_locality_score(float(rtt_us))
        return weighted_total(subbed)
    if evaluator_name == "ml":
        feats = cand.get("features")
        if feats:
            return float((infer or standin_ml_infer)([feats])[0])
        return weighted_total(terms)
    raise ValueError(f"unknown replay evaluator {evaluator_name!r} "
                     f"(known: {REPLAY_EVALUATORS})")


def rescore_decision(row: dict, evaluator_name: str,
                     infer=None) -> list[str]:
    """Candidate peer ids ranked best-first under ``evaluator_name``.
    Ties break on peer id so the ranking — and the digest over it — is a
    pure function of the row."""
    scored = [(rescore_candidate(c, evaluator_name,
                                 row.get("host_id", ""), infer),
               c.get("peer_id", ""))
              for c in row.get("candidates") or []]
    scored.sort(key=lambda t: (-t[0], t[1]))
    return [pid for _, pid in scored]


def rank_agreement(a: list[str], b: list[str]) -> float:
    """Pairwise concordance over the common candidates of two rankings
    (1.0 = identical order, 0.0 = fully reversed)."""
    in_b = {pid: i for i, pid in enumerate(b)}
    common = [pid for pid in a if pid in in_b]
    n = len(common)
    if n < 2:
        return 1.0
    concordant = pairs = 0
    for i in range(n):
        for j in range(i + 1, n):
            pairs += 1
            if in_b[common[i]] < in_b[common[j]]:
                concordant += 1
    return concordant / pairs


def replay_decisions(rows: list[dict],
                     evaluators: tuple = REPLAY_EVALUATORS,
                     infer=None) -> dict:
    """Re-score every logged candidate set under each evaluator and
    compare the rankings — the offline A/B core. Returns per-pair
    mean rank agreement + top-choice flip rate, each evaluator's agreement
    with the logged chosen parent, and a deterministic
    ``decision_digest`` over the full ranking table (same rows + same
    evaluators ⇒ byte-identical digest)."""
    decisions = [r for r in rows
                 if r.get("kind") == "decision" and r.get("candidates")]
    rankings: dict[str, dict[str, list[str]]] = {
        name: {d.get("decision_id", ""): rescore_decision(d, name, infer)
               for d in decisions}
        for name in evaluators}
    pairs = {}
    for i, a in enumerate(evaluators):
        for b in evaluators[i + 1:]:
            agree = []
            flips = 0
            for d in decisions:
                did = d.get("decision_id", "")
                ra, rb = rankings[a][did], rankings[b][did]
                agree.append(rank_agreement(ra, rb))
                if ra and rb and ra[0] != rb[0]:
                    flips += 1
            n = len(decisions)
            pairs[f"{a}_vs_{b}"] = {
                "rank_agreement": round(sum(agree) / n, 4) if n else 1.0,
                "choice_flip_rate": round(flips / n, 4) if n else 0.0,
            }
    logged_choice = {}
    for name in evaluators:
        hits = with_choice = 0
        for d in decisions:
            chosen = d.get("chosen") or []
            ranked = rankings[name][d.get("decision_id", "")]
            if not chosen or not ranked:
                continue
            with_choice += 1
            if ranked[0] == chosen[0]:
                hits += 1
        logged_choice[name] = (round(hits / with_choice, 4)
                               if with_choice else 1.0)
    digest = hashlib.sha256(json.dumps(
        rankings, sort_keys=True).encode()).hexdigest()
    return {
        "decisions_scored": len(decisions),
        "evaluators": list(evaluators),
        "pairs": pairs,
        "logged_choice_agreement": logged_choice,
        "decision_digest": digest,
    }


def replay_regret(rows: list[dict],
                  evaluators: tuple = ("default", "ml"),
                  infer=None) -> dict:
    """Observed-bandwidth regret of each evaluator's counterfactual top
    pick, judged by what the logged outcomes actually measured.

    For every decision whose ``kind=piece`` outcome rows cover at least
    two candidates, each evaluator's ranking (``rescore_decision`` — the
    same pure replay math as ``replay_decisions``) nominates its best
    candidate *among those with measured outcomes*; the regret of that
    pick is its shortfall against the best observed bandwidth for the
    ruling, relative: ``(best_bps - picked_bps) / best_bps``. Restricting
    the pick to measured candidates keeps the judgment honest — an
    unmeasured candidate has no observed bandwidth to be judged by.

    Returns per-evaluator mean regret, mean chosen bandwidth, and the
    fraction of rulings where the evaluator picked the observed-best
    parent outright. ``decisions_judged`` counts rulings with a usable
    counterfactual (≥2 measured candidates); single-outcome rulings
    carry no signal and are skipped, not silently averaged in.
    """
    decisions = {r.get("decision_id", ""): r for r in rows
                 if r.get("kind") == "decision" and r.get("candidates")}
    # (decision_id, parent) -> [bytes, seconds] accumulated over pieces
    flow: dict[tuple, list] = {}
    for r in rows:
        if r.get("kind") != "piece" or not r.get("decision_id"):
            continue
        if r["decision_id"] not in decisions:
            continue
        key = (r["decision_id"], r.get("parent_peer_id", ""))
        agg = flow.setdefault(key, [0, 0.0])
        agg[0] += int(r.get("piece_length", 0) or 0)
        agg[1] += float(r.get("cost_ms", 0) or 0) / 1e3
    per = {name: {"regret": [], "bps": [], "best_picks": 0}
           for name in evaluators}
    judged = 0
    for did, d in decisions.items():
        observed = {}
        for c in d.get("candidates") or []:
            pid = c.get("peer_id", "")
            agg = flow.get((did, pid))
            if agg and agg[1] > 0:
                observed[pid] = agg[0] / agg[1]
        if len(observed) < 2:
            continue
        judged += 1
        best = max(observed.values())
        for name in evaluators:
            ranked = rescore_decision(d, name, infer)
            pick = next((pid for pid in ranked if pid in observed), None)
            if pick is None:    # unreachable: observed ⊆ candidates
                continue
            bps = observed[pick]
            per[name]["bps"].append(bps)
            per[name]["regret"].append((best - bps) / best if best else 0.0)
            if bps == best:
                per[name]["best_picks"] += 1
    out = {"decisions_judged": judged, "evaluators": {}}
    for name in evaluators:
        r = per[name]["regret"]
        b = per[name]["bps"]
        out["evaluators"][name] = {
            "mean_regret": round(sum(r) / len(r), 4) if r else 0.0,
            "mean_chosen_bandwidth_bps": round(sum(b) / len(b), 1)
            if b else 0.0,
            "best_pick_rate": round(per[name]["best_picks"] / judged, 4)
            if judged else 0.0,
        }
    return out


# drift guard: the replay rebuilds totals from SCORE_TERMS — a new term in
# the evaluator that never lands here would silently mis-replay
if tuple(n for n, _ in SCORE_TERMS) != (
        "piece", "upload_success", "free_upload", "host_type", "locality"):
    raise RuntimeError("decision replay expects the 5-term evaluator "
                       "decomposition; update rescore_candidate with "
                       "evaluator.SCORE_TERMS together")
