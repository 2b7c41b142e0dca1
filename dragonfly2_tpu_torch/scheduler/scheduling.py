"""Scheduling core: pick parents for a peer.

Counterpart of ``dragonfly2_tpu/scheduler/scheduling.py`` (reference
``scheduler/scheduling/scheduling.go``: ``FindCandidateParents`` :385 and
``filterCandidateParents`` :500-570 — blocklist, same-peer, DAG-cycle,
bad-node and free-upload-slot checks) on the exact path: no quarantine,
federation, shard affinity, relay-tree shaping, QoS preemption or
decision ledger. The candidate pool is shuffled with ``rng`` (the module
``random`` by default, as in the reference), so a caller that passes a
seeded ``random.Random`` gets the reference's choices for the same seed.
"""

from __future__ import annotations

import logging
import random

from ..common.metrics import REGISTRY
from ..idl.messages import HostType, PeerAddr, PeerPacket
from ..tpu.topology import link_type
from .config import CANDIDATE_PARENT_LIMIT, FILTER_PARENT_LIMIT
from .evaluator import Evaluator
from .resource import Peer

log = logging.getLogger("df.sched.core")

_filter_excluded = REGISTRY.counter(
    "df_sched_filter_excluded_total",
    "candidate parents excluded by the scheduling filter", ("reason",))


class Scheduling:
    def __init__(self, evaluator: Evaluator, *,
                 rng: random.Random | None = None):
        self.evaluator = evaluator
        self.rng = rng if rng is not None else random

    def filter_candidates(self, child: Peer) -> list[Peer]:
        """All legal parents for ``child``, pre-scoring. The pool is
        sampled in random order (reference ``LoadRandomPeers``,
        ``scheduling.go:511``) so children do not herd onto the same
        first-N candidates."""
        task = child.task
        pool = list(task.peers.values())
        self.rng.shuffle(pool)
        # one reachability sweep per ruling: a parent downstream of the
        # child would close a cycle
        cycle_blocked = task.dag.descendants(child.id)
        out: list[Peer] = []
        for parent in pool:
            full = len(out) >= FILTER_PARENT_LIMIT
            if full and any(p.has_content() for p in out):
                break
            if full and not parent.has_content():
                # truncated but holderless so far: keep scanning for a
                # content holder only
                continue
            if parent.id == child.id:
                continue
            if parent.stream_gone and not parent.is_done():
                # mid-download peer whose report stream died: almost
                # certainly a dead process
                self._trace(child, parent, "stream-gone")
                continue
            if child.is_blocked(parent.id):
                self._trace(child, parent, "blocklist")
                continue
            if not parent.has_content() and parent.is_done():
                # finished-but-empty (failed) peers serve nothing; running
                # pieceless siblings stay in — their sync stream is how a
                # child hears a sibling's first piece
                continue
            # a parent this child already holds keeps its edge (and slot)
            if (parent.host.free_upload_slots() <= 0
                    and parent.id not in child.last_offer_ids):
                self._trace(child, parent, "no-slots")
                continue
            if self.evaluator.is_bad_node(parent):
                self._trace(child, parent, "bad-node")
                continue
            if parent.id in cycle_blocked:
                self._trace(child, parent, "cycle")
                continue
            out.append(parent)
        return out

    @staticmethod
    def _trace(child: Peer, parent: Peer, reason: str) -> None:
        """One exclusion: counted always, logged only at DEBUG."""
        _filter_excluded.labels(reason).inc()
        if log.isEnabledFor(logging.DEBUG):
            log.debug("filter %s: parent %s excluded (%s)",
                      child.id[-12:], parent.id[-12:], reason)

    @staticmethod
    def _ensure_holder(scored: list[Peer], top: list[Peer]) -> list[Peer]:
        """Keep >= 1 content holder in the offer when one exists: an offer
        of pieceless siblings only would leave the child subscribed to
        peers that may never announce."""
        if any(p.has_content() for p in top):
            return top
        holder = next((p for p in scored if p.has_content()), None)
        if holder is None:
            return top
        return [*top[:-1], holder] if top else [holder]

    def find_parents(self, child: Peer) -> list[Peer]:
        return self._decide(child, "find")

    def refresh_parents(self, child: Peer) -> list[Peer]:
        """Sticky variant of ``find_parents`` for mid-download re-offers:
        current parents that are still legal stay, the best newcomers fill
        the remaining candidate slots."""
        return self._decide(child, "refresh")

    def _decide(self, child: Peer, decision_kind: str) -> list[Peer]:
        """Filter, score (stable sort, best first), choose."""
        candidates = self.filter_candidates(child)
        if not candidates:
            return []
        total = child.task.total_piece_count
        scored = sorted(
            candidates,
            key=lambda p: self.evaluator.evaluate(
                child, p, total_piece_count=total),
            reverse=True)
        limit = CANDIDATE_PARENT_LIMIT
        if decision_kind == "refresh":
            prev = child.last_offer_ids
            kept = [p for p in scored if p.id in prev]
            fresh = [p for p in scored if p.id not in prev]
            return self._ensure_holder(scored, (kept + fresh)[:limit])
        return self._ensure_holder(scored, scored[:limit])

    def build_packet(self, child: Peer, parents: list[Peer]) -> PeerPacket:
        def addr(p: Peer) -> PeerAddr:
            same_host = p.host.id == child.host.id
            return PeerAddr(
                peer_id=p.id, ip=p.host.msg.ip,
                rpc_port=p.host.msg.port,
                download_port=p.host.msg.download_port,
                link=link_type(child.host.msg.topology, p.host.msg.topology,
                               same_host=same_host),
                is_seed=p.host.msg.type != HostType.NORMAL)
        main = addr(parents[0]) if parents else None
        return PeerPacket(
            task_id=child.task.id, src_peer_id=child.id,
            parallel_count=4, main_peer=main,
            candidate_peers=[addr(p) for p in parents[1:]])
