"""Scheduling core: pick parents for a peer.

Counterpart of ``dragonfly2_tpu/scheduler/scheduling.py`` (reference
``scheduler/scheduling/scheduling.go``: ``FindCandidateParents`` :385 and
``filterCandidateParents`` :500-570 — blocklist, same-peer, DAG-cycle,
bad-node and free-upload-slot checks) with the reference's relay-tree
shaping (``relay_fanout`` > 0, ``_relay_shape``; 0, the default, is the
exact path), the quarantine registry's exclusion (``quarantine``:
``quarantine.QuarantineRegistry``, hosts it rules not offerable are
excluded as ``quarantined``, probation hosts pass within their probe
budget) and the federation's (``federation``: ``federation.
PodFederation``, a cross-pod parent only for the child pod's elected
seeds, else ``cross-pod``). Both ``None`` (the defaults) skip every
lookup: the rulings are the exact path without them. QoS: the relay
fan-out cap is per class (``class_fanout_caps``; without caps a ``bulk``
child gets half of ``relay_fanout``), and ``preempt_for`` lets a waiting
``critical`` child evict one ``bulk`` child's edge from a slot-full
content holder (``qos_preemption``), ruled under ``preempt`` with a
``decision_kind=preempt`` row. The ``sharded`` arm
(``shard_affinity.ShardAffinity``) rules sharded registers' tree-fetch
subsets and never touches parent scoring; unlike the reference, its swap
partners are exempt from the DAG-cycle exclusion, since two replicas that
swap shards must each be the other's parent. The
candidate pool is shuffled with ``rng`` (the module ``random`` by
default, as in the reference), so a caller that passes a seeded
``random.Random`` gets the reference's choices for the same seed.

``decision_sink`` is the decision ledger's hook: armed, every ruling emits
one ``kind=decision`` row (candidates with their per-term decomposition
and scoring-time feature rows, exclusions, the chosen offer) and stamps
``decision_id`` on the child. It observes only: the ranking key is
``explain()["total"]``, bit-identical to ``evaluate()``, and the rng is
never touched, so the offer is the same armed or not. The ruling
profiler (``common/phasetimer.py``) times each ruling (``find``,
``refresh``, ``shard``) and its ``filter`` (with ``dag-walk`` inside),
``exclusion`` (the quarantine and federation lookups, one sample per
ruling, fired only when either is armed), ``score``, ``relay`` and
``emit`` phases under the same purity contract, and each ``preempt``
probe.
"""

from __future__ import annotations

import logging
import random
import time

from ..common import phasetimer
from ..common.metrics import REGISTRY
from ..idl.messages import HostType, PeerAddr, PeerPacket
from ..tpu.topology import link_type
from .config import SchedulerConfig
from .evaluator import Evaluator
from .resource import Peer

log = logging.getLogger("df.sched.core")

_filter_excluded = REGISTRY.counter(
    "df_sched_filter_excluded_total",
    "candidate parents excluded by the scheduling filter", ("reason",))
_preemptions = REGISTRY.counter(
    "df_sched_preempt_total",
    "bulk-class parent edges evicted so a waiting critical child could "
    "be scheduled (QoS preemption; each ruling rides the decision "
    "ledger)", ("cls",))

# The filter's exclusion-reason vocabulary: every reason ``_trace`` fires
# is one of these (counted in ``df_sched_filter_excluded_total`` and named
# in the decision rows' ``excluded`` entries).
EXCLUSION_REASONS = ("stream-gone", "blocklist", "no-slots", "bad-node",
                     "cycle", "quarantined", "cross-pod")


class Scheduling:
    def __init__(self, cfg: SchedulerConfig, evaluator: Evaluator,
                 quarantine=None, federation=None, sharded=None, *,
                 rng: random.Random | None = None):
        # the fan-out limits and QoS switches are read from ``cfg`` at
        # each ruling, so a later change to the config reaches the next
        self.cfg = cfg
        self.evaluator = evaluator
        self.rng = rng if rng is not None else random
        # quarantine registry (scheduler/quarantine.py); None skips every
        # lookup, the exact filter path without it
        self.quarantine = quarantine
        # cross-pod federation view (scheduler/federation.py); None skips
        # every lookup, the exact single-pod filter path
        self.federation = federation
        # shard-affinity arm; None = no shard rulings, every daemon
        # fetches its whole requested set from the tree
        self.sharded = sharded
        # decision ledger hook: callable(row dict), one kind=decision row
        # per find/refresh ruling; None skips all ledger work
        self.decision_sink = None
        self._decision_seq = 0

    def shard_assignment(self, child: Peer,
                         requested: list[str]) -> list[str] | None:
        """Sharded-task register hook: the disjoint tree-fetch subset of
        ``requested`` ruled for this peer (``decision_kind=shard`` rides
        the affinity's own ledger sink). None while the arm is disabled
        — the daemon then treats every requested shard as tree-class."""
        if self.sharded is None or not requested:
            return None
        with phasetimer.ruling("shard"):
            return self.sharded.assign(
                task_id=child.task.id, peer_id=child.id,
                host_id=child.host.id,
                topology=child.host.msg.topology, requested=requested)

    def filter_candidates(self, child: Peer,
                          excluded: list | None = None) -> list[Peer]:
        """All legal parents for ``child``, pre-scoring. The pool is
        sampled in random order (reference ``LoadRandomPeers``,
        ``scheduling.go:511``) so children do not herd onto the same
        first-N candidates."""
        task = child.task
        pool = list(task.peers.values())
        self.rng.shuffle(pool)
        # one reachability sweep per ruling: a parent downstream of the
        # child would close a cycle
        with phasetimer.phase("dag-walk"):
            cycle_blocked = task.dag.descendants(child.id)
        # the per-candidate quarantine/federation lookups accumulate one
        # local delta and record ONE ``exclusion`` sample per ruling
        armed = phasetimer.ARMED
        excl_s = 0.0
        out: list[Peer] = []
        for parent in pool:
            full = len(out) >= self.cfg.filter_parent_limit
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
                self._trace(child, parent, "stream-gone", excluded)
                continue
            if child.is_blocked(parent.id):
                self._trace(child, parent, "blocklist", excluded)
                continue
            if not parent.has_content() and parent.is_done():
                # finished-but-empty (failed) peers serve nothing; running
                # pieceless siblings stay in — their sync stream is how a
                # child hears a sibling's first piece
                continue
            # a parent this child already holds keeps its edge (and slot)
            if (parent.host.free_upload_slots() <= 0
                    and parent.id not in child.last_offer_ids):
                self._trace(child, parent, "no-slots", excluded)
                continue
            if (self.evaluator.is_bad_node(parent)
                    and not self._swap_partners(child, parent)):
                self._trace(child, parent, "bad-node", excluded)
                continue
            if self.quarantine is not None:
                t0 = time.perf_counter() if armed else 0.0
                offerable = self.quarantine.offerable(parent.host.id,
                                                      child.id)
                if armed:
                    excl_s += time.perf_counter() - t0
                if not offerable:
                    # pod-wide quarantine (hard corrupt evidence or a
                    # self-flag): out of offers, relay shaping and every
                    # downstream choice until probation walks it back
                    self._trace(child, parent, "quarantined", excluded)
                    continue
            if self.federation is not None:
                t0 = time.perf_counter() if armed else 0.0
                allowed = self.federation.allows(child, parent)
                if armed:
                    excl_s += time.perf_counter() - t0
                if not allowed:
                    # a parent in another pod serves only this pod's
                    # elected seeds; everyone else takes the bytes off
                    # the pod seed's in-pod tree
                    self._trace(child, parent, "cross-pod", excluded)
                    continue
            if (parent.id in cycle_blocked
                    and not self._swap_partners(child, parent)):
                self._trace(child, parent, "cycle", excluded)
                continue
            out.append(parent)
        if armed and (self.quarantine is not None
                      or self.federation is not None):
            phasetimer.record("exclusion", excl_s)
        return out

    def _swap_partners(self, child: Peer, parent: Peer) -> bool:
        """Co-located replicas requesting a shard in common feed each
        other by swap, so neither the DAG's cycle rule nor a bad-node
        blip (one slow piece among a partner's last 20) drops one from the
        other's offer: a child that loses its partner refetches every
        swap piece from the seed once the swap hold ends. The edge that
        closes a cycle stays out of the DAG (``Task.set_parents`` skips
        it), only the offer carries it."""
        return self.sharded is not None and self.sharded.swap_partners(
            child.task.id, child.host.id, child.host.msg.topology,
            parent.host.id, parent.host.msg.topology)

    @staticmethod
    def _trace(child: Peer, parent: Peer, reason: str,
               excluded: list | None) -> None:
        """One exclusion: counted always, kept for the decision row when
        the ledger is armed, logged only at DEBUG."""
        _filter_excluded.labels(reason).inc()
        if excluded is not None:
            excluded.append((parent, reason))
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

    def _relay_shape(self, child: Peer,
                     scored: list[Peer]) -> tuple[list[Peer], dict | None]:
        """Relay-chain shaping (``relay_fanout`` > 0): demote parents
        already feeding ``relay_fanout`` direct children behind under-cap
        candidates. Score order is kept within each partition, so the
        choice among legal relays stays the evaluator's; parents this
        child already holds keep their edge (the cap shapes new edges and
        never tears down working ones). Returns the reshaped order and the
        decision row's note (None when nothing was capped)."""
        fanout = self.cfg.relay_fanout
        # per-class slot cap: bulk children claim fewer of a parent's
        # relay slots, leaving breadth near the seed for the foreground
        # classes; without caps a bulk child gets half the fan-out
        cls = getattr(child, "qos_class", "standard")
        if self.cfg.class_fanout_caps:
            fanout = int(self.cfg.class_fanout_caps.get(cls, fanout))
        elif cls == "bulk":
            fanout = max(1, fanout // 2)
        dag = child.task.dag
        mine = child.last_offer_ids
        under: list[Peer] = []
        over: list[Peer] = []
        counts: dict[str, int] = {}
        for p in scored:
            n = len(dag.children(p.id)) if p.id in dag else 0
            counts[p.id] = n
            if n >= fanout and p.id not in mine:
                over.append(p)
            else:
                under.append(p)
        if not over:
            return scored, None
        note = {"fanout": fanout,
                "capped": [p.id for p in over],
                "child_counts": {p.id: counts[p.id] for p in over}}
        return under + over, note

    def preempt_for(self, child: Peer) -> Peer | None:
        """Bulk preemption: a waiting ``critical`` child found no content
        holder because every holder's upload slots are taken; evict one
        ``bulk`` child's edge from the first such holder, so the next
        ``find_parents`` sees a free slot. The victim keeps its other
        parents and its pieces, and a later refresh re-offers it whatever
        is legal then. Returns the victim (the caller pushes it its
        shrunk offer, so its engine drops the edge) or None."""
        if (not self.cfg.qos_preemption
                or getattr(child, "qos_class", "standard") != "critical"):
            return None
        with phasetimer.ruling("preempt"):
            return self._preempt_scan(child)

    def _preempt_scan(self, child: Peer) -> Peer | None:
        task = child.task
        dag = task.dag
        # holders with no free slot; the victim edge is the bulk child that
        # joined the parent last (it has sunk the least into the edge)
        for parent in task.peers.values():
            if (parent.id == child.id or not parent.has_content()
                    or parent.host.free_upload_slots() > 0
                    or parent.id not in dag):
                continue
            victims = [
                task.peers[cid] for cid in dag.children(parent.id)
                if cid in task.peers
                and getattr(task.peers[cid], "qos_class",
                            "standard") == "bulk"
                and not task.peers[cid].is_done()]
            if not victims:
                continue
            victim = max(victims, key=lambda p: p.created_at)
            keep = [pid for pid in dag.parents(victim.id)
                    if pid != parent.id]
            task.set_parents(victim.id, keep)
            victim.last_offer_ids = set(keep)
            _preemptions.labels("bulk").inc()
            log.info("preempt: bulk child %s lost parent %s so critical "
                     "%s can schedule", victim.id[-12:], parent.id[-12:],
                     child.id[-12:])
            if self.decision_sink is not None:
                self._decision_seq += 1
                self.decision_sink({
                    "kind": "decision",
                    "decision_id": (f"d{self._decision_seq:08d}."
                                    f"{child.id[-12:]}"),
                    "decision_kind": "preempt",
                    "task_id": task.id,
                    "peer_id": child.id,
                    "host_id": child.host.id,
                    "qos_class": getattr(child, "qos_class", "standard"),
                    "tenant": getattr(child, "tenant", ""),
                    "candidates": [],
                    "excluded": [],
                    "chosen": [],
                    "preempted": {
                        "victim_peer_id": victim.id,
                        "victim_class": "bulk",
                        "victim_tenant": getattr(victim, "tenant", ""),
                        "parent_id": parent.id,
                        "victim_parents_kept": keep,
                    },
                })
            return victim
        return None

    def find_parents(self, child: Peer) -> list[Peer]:
        return self._decide(child, "find")

    def refresh_parents(self, child: Peer) -> list[Peer]:
        """Sticky variant of ``find_parents`` for mid-download re-offers:
        current parents that are still legal stay, the best newcomers fill
        the remaining candidate slots."""
        return self._decide(child, "refresh")

    def _decide(self, child: Peer, decision_kind: str) -> list[Peer]:
        """Filter, score (stable sort, best first), choose; with the sink
        armed, rank by ``explain()["total"]`` (== ``evaluate()``) and emit
        the ruling's decision row."""
        with phasetimer.ruling(decision_kind):
            sink = self.decision_sink
            excluded: list | None = [] if sink is not None else None
            with phasetimer.phase("filter"):
                candidates = self.filter_candidates(child, excluded)
            total = child.task.total_piece_count
            explained: list[tuple[Peer, dict]] = []
            relay_note: dict | None = None
            prev_offer = set(child.last_offer_ids)
            if not candidates:
                offer: list[Peer] = []
            else:
                with phasetimer.phase("score"):
                    if sink is None:
                        scored = sorted(
                            candidates,
                            key=lambda p: self.evaluator.evaluate(
                                child, p, total_piece_count=total),
                            reverse=True)
                    else:
                        explained = [(p, self.evaluator.explain(
                            child, p, total_piece_count=total))
                            for p in candidates]
                        explained.sort(key=lambda pe: pe[1]["total"],
                                       reverse=True)
                        scored = [p for p, _ in explained]
                if self.cfg.relay_fanout > 0:
                    with phasetimer.phase("relay"):
                        scored, relay_note = self._relay_shape(child, scored)
                limit = self.cfg.candidate_parent_limit
                if decision_kind == "refresh":
                    kept = [p for p in scored if p.id in prev_offer]
                    fresh = [p for p in scored if p.id not in prev_offer]
                    offer = self._ensure_holder(scored,
                                                (kept + fresh)[:limit])
                else:
                    offer = self._ensure_holder(scored, scored[:limit])
            if sink is not None:
                with phasetimer.phase("emit"):
                    self._emit_decision(child, decision_kind, explained,
                                        excluded or [], offer, prev_offer,
                                        total, relay_note=relay_note)
            return offer

    def _emit_decision(self, child: Peer, decision_kind: str,
                       explained: list, excluded: list, offer: list[Peer],
                       prev_offer: set, total: int,
                       relay_note: dict | None = None) -> None:
        self._decision_seq += 1
        decision_id = f"d{self._decision_seq:08d}.{child.id[-12:]}"
        candidates = []
        for rank, (p, ex) in enumerate(explained, 1):
            terms = ex["terms"]
            # the exact scoring-time feature row (trainer layout:
            # evaluator_ml.parent_feature_row), rebuilt from the terms
            # explain() already computed. features[4] stays the static
            # locality (the train/serve contract): where the nt evaluator
            # substituted a measured RTT, the base score is recomputed
            locality = terms["locality"]
            if "locality" in (ex.get("substituted") or {}):
                locality = Evaluator._locality_score(child, p)
            cand = {
                "peer_id": p.id,
                "host_id": p.host.id,
                "rank": rank,
                "total": ex["total"],
                "terms": terms,
                "features": [terms["piece"], terms["upload_success"],
                             terms["free_upload"], terms["host_type"],
                             locality, float(len(p.finished_pieces)),
                             float(p.host.concurrent_upload_count)],
            }
            for key in ("substituted", "rtt_us", "base_total", "link_tier",
                        "cross_pod"):
                if key in ex:
                    cand[key] = ex[key]
            candidates.append(cand)
        row = {
            "kind": "decision",
            "decision_id": decision_id,
            "decision_kind": decision_kind,
            "task_id": child.task.id,
            "peer_id": child.id,
            "host_id": child.host.id,
            "qos_class": child.qos_class,
            "tenant": child.tenant,
            "total_piece_count": total,
            "evaluator": type(self.evaluator).__name__,
            "candidates": candidates,
            "excluded": [{"peer_id": p.id, "host_id": p.host.id,
                          "reason": reason} for p, reason in excluded],
            "chosen": [p.id for p in offer],
        }
        if relay_note is not None:
            # which candidates the fan-out cap demoted, with their DAG
            # child counts: "why isn't the seed my parent" from the row
            row["relay"] = relay_note
        if self.federation is not None:
            # the child's pod, its elected seeds and whether it may cross
            # pods: federation fairness replayable from the row alone
            fed_note = self.federation.note(child)
            if fed_note is not None:
                row["federation"] = fed_note
        if decision_kind == "refresh":
            row["kept"] = [p.id for p in offer if p.id in prev_offer]
            row["fresh"] = [p.id for p in offer if p.id not in prev_offer]
        if offer:
            # join key for outcome rows: records.on_piece stamps each
            # piece row with the child's newest ruling
            child.last_decision_id = decision_id
        self.decision_sink(row)

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
