"""Parent evaluator: scores candidate parents for a downloading peer.

Counterpart of the heuristic half of ``dragonfly2_tpu/scheduler/
evaluator.py`` (reference ``scheduler/scheduling/evaluator/
evaluator_base.go:28-46``): a weighted sum of piece progress 0.2, upload
success 0.2, free upload slots 0.15, host type 0.15 and fabric locality
0.30 (the reference's IDC + location weights, computed from pod
coordinates: LOCAL > ICI > DCN > WAN), and the ``IsBadNode`` Z-score
outlier ejection (``evaluator.go:93``). ``make_evaluator("ml")`` gives
the learned ``evaluator_ml.MLEvaluator`` behind this heuristic floor, and
``make_evaluator("nt", topo_store=...)`` the ``RTTEvaluator``, whose
locality term comes from the probes' measured (or imputed) RTT. The
plugin evaluator is not ported: ``make_evaluator`` refuses it rather than
scoring with the heuristic under its name.
"""

from __future__ import annotations

import statistics

from ..idl.messages import HostType, LinkType
from ..tpu.topology import (LINK_BANDWIDTH_SCORE, LINK_TIER_NAMES, classify,
                            ici_hops, link_type)
from .resource import Peer

# weight structure per evaluator_base.go:28-46, with IDC+location mass
# reassigned to fabric locality
W_PIECE = 0.20
W_UPLOAD_SUCCESS = 0.20
W_FREE_UPLOAD = 0.15
W_HOST_TYPE = 0.15
W_LOCALITY = 0.30

# (term name, weight) in evaluate()'s exact summation order: a total
# rebuilt from these is bit-identical to evaluate() only when the order
# matches
SCORE_TERMS = (
    ("piece", W_PIECE),
    ("upload_success", W_UPLOAD_SUCCESS),
    ("free_upload", W_FREE_UPLOAD),
    ("host_type", W_HOST_TYPE),
    ("locality", W_LOCALITY),
)

BAD_NODE_Z = 3.0                 # reference uses 3-sigma piece-cost outliers


def weighted_total(terms: dict) -> float:
    """Weighted sum over SCORE_TERMS in declaration order (== the order
    ``evaluate`` adds them, so a rebuilt total is bit-identical)."""
    total = 0.0
    for name, weight in SCORE_TERMS:
        total += weight * terms[name]
    return total


def rtt_locality_score(rtt_us: float) -> float:
    """Measured-RTT locality mapping of the offline decision replay's
    ``nt`` column: <=50us (ICI neighborhood) ~1.0, 10ms ~0.1 (reference
    ``evaluator_network_topology.go:30-57``)."""
    return max(0.05, min(1.0, 50.0 / max(rtt_us, 50.0) + 0.05))


class Evaluator:
    """``default`` algorithm: rule-based weighted sum."""

    def evaluate(self, child: Peer, parent: Peer, *,
                 total_piece_count: int) -> float:
        return weighted_total(self._term_scores(
            child, parent, total_piece_count=total_piece_count))

    def _term_scores(self, child: Peer, parent: Peer, *,
                     total_piece_count: int) -> dict:
        return {
            "piece": self._piece_score(parent, total_piece_count),
            "upload_success": parent.host.upload_success_ratio(),
            "free_upload": self._free_upload_score(parent),
            "host_type": self._host_type_score(parent),
            "locality": self._locality_score(child, parent),
        }

    def explain(self, child: Peer, parent: Peer, *,
                total_piece_count: int) -> dict:
        """Per-term score decomposition: ``{"terms": {name: raw score},
        "total": float, "link_tier": str, "cross_pod": bool}``, where
        ``total`` is bit-identical to ``evaluate()`` on the same state
        (same terms, same summation order)."""
        terms = self._term_scores(child, parent,
                                  total_piece_count=total_piece_count)
        lc = classify(child.host.msg.topology, parent.host.msg.topology,
                      same_host=child.host.id == parent.host.id)
        return {"terms": terms, "total": weighted_total(terms),
                "link_tier": LINK_TIER_NAMES[lc.link],
                "cross_pod": lc.dcn_hops > 0}

    # -- individual scores --------------------------------------------

    @staticmethod
    def _piece_score(parent: Peer, total_piece_count: int) -> float:
        if total_piece_count > 0:
            return len(parent.finished_pieces) / total_piece_count
        return 1.0 if parent.finished_pieces else 0.0

    @staticmethod
    def _free_upload_score(parent: Peer) -> float:
        limit = parent.host.upload_limit
        return parent.host.free_upload_slots() / limit if limit else 0.0

    @staticmethod
    def _host_type_score(parent: Peer) -> float:
        # seed classes beat normal peers (they hold full content and serve
        # nothing else); reference orders super > strong > weak > normal
        return {HostType.SUPER_SEED: 1.0, HostType.STRONG_SEED: 0.9,
                HostType.WEAK_SEED: 0.8, HostType.NORMAL: 0.5}.get(
                    parent.host.msg.type, 0.5)

    @staticmethod
    def _locality_score(child: Peer, parent: Peer) -> float:
        same_host = child.host.id == parent.host.id
        lt = link_type(child.host.msg.topology, parent.host.msg.topology,
                       same_host=same_host)
        score = LINK_BANDWIDTH_SCORE[lt]
        if lt == LinkType.ICI:
            # tie-break same-slice parents by torus distance: every hop is
            # wired bandwidth, but fewer hops = less contention
            a, b = child.host.msg.topology, parent.host.msg.topology
            hops = ici_hops(a, b)
            if hops < (1 << 16):
                score -= min(0.05, 0.005 * hops)
        return score

    # -- bad node ------------------------------------------------------

    @staticmethod
    def is_bad_node(peer: Peer) -> bool:
        """Z-score ejection on recent piece costs (evaluator.go:93+)."""
        costs = peer.piece_costs_ms
        if len(costs) < 4:
            return False
        mean = statistics.fmean(costs)
        stdev = statistics.pstdev(costs)
        if stdev == 0:
            return False
        return (costs[-1] - mean) / stdev > BAD_NODE_Z


class RTTEvaluator(Evaluator):
    """``nt`` algorithm: replaces the static locality score with measured
    RTT when the probe store has data for the pair
    (reference ``evaluator_network_topology.go:30-57``)."""

    def __init__(self, topo_store):
        self.topo = topo_store

    def _locality_score(self, child: Peer, parent: Peer) -> float:  # type: ignore[override]
        rtt_us = self.topo.avg_rtt_us(child.host.id, parent.host.id)
        if rtt_us is None:
            return Evaluator._locality_score(child, parent)
        return rtt_locality_score(rtt_us)

    def explain(self, child: Peer, parent: Peer, *,
                total_piece_count: int) -> dict:
        out = super().explain(child, parent,
                              total_piece_count=total_piece_count)
        rtt_us = self.topo.avg_rtt_us(child.host.id, parent.host.id)
        if rtt_us is not None:
            # the locality term above already carries the RTT-derived
            # score; record that it was measured, and the measurement, so
            # the offline replay can re-map it instead of synthesizing one
            out["substituted"] = {"locality": "rtt"}
            out["rtt_us"] = rtt_us
        return out


def make_evaluator(algorithm: str, *, topo_store=None) -> Evaluator:
    if algorithm == "nt" and topo_store is not None:
        return RTTEvaluator(topo_store)
    if algorithm == "ml":
        # no model at boot: a bound one replaces the heuristic floor
        from .evaluator_ml import MLEvaluator
        return MLEvaluator()
    if algorithm != "default":
        raise ValueError(f"evaluator algorithm {algorithm!r} is not "
                         "available; this package has the 'default' "
                         "heuristic, 'ml', and 'nt' over a topology store")
    return Evaluator()
