"""Scheduler shard affinity: disjoint tree-fetch assignment per replica.

Counterpart of ``dragonfly2_tpu/scheduler/shard_affinity.py``, the
``sharded=`` arm of ``Scheduling``. Many co-located replicas request the
same shard subset of a multi-GB checkpoint; at register, each peer's
requested shards are split DISJOINTLY across the co-located replicas
requesting them (bounded-load rendezvous hashing,
``common.sharding.split_affinity``). The peer fetches only its assigned
subset from the tree and the rest arrives by P2P swap from its partners
(the daemon's swap hold; tree fallback bounded by
``daemon.piece_dispatcher.SWAP_HOLD_S`` when a partner dies).

Co-location = same pod (``tpu.topology.pod_id``); pod-less hosts group
under "". Every change of a peer's assignment is one
``decision_kind=shard`` ledger row. The reference's ruling profiler
(``phasetimer.ruling("shard")``), debug view and state-store export have
no counterpart in the port.

One addition: ``swap_partners`` names the peers the scheduling filter
lets feed each other although the pair closes a cycle in the task's DAG.
The scheduler service re-rules a group's earlier members through
``assign`` when a later one registers.
"""

from __future__ import annotations

import logging

from ..common.metrics import REGISTRY
from ..common.sharding import split_affinity
from ..tpu.topology import pod_id

log = logging.getLogger("df.sched.shards")

_assignments = REGISTRY.counter(
    "df_shard_assignments_total",
    "shard-affinity rulings, by outcome (assigned = a disjoint subset "
    "ruled, solo = the peer is its group's only requester so it fetches "
    "everything)", ("result",))


class ShardAffinity:
    """Per-(task, group) shard-request membership + disjoint assignment.

    The split is a pure function of {who requests which shards}, so a
    replay rules identically. A peer ruled before its replicas
    registered is ruled again (by the scheduler service) when they do.
    Rulings for a known peer are emitted only when its subset CHANGED, so
    the ledger sees churn, not cadence."""

    MAX_TASKS = 4096          # (task, group) memo bound

    def __init__(self, *, sink=None):
        self.sink = sink      # decision-ledger hook: callable(row dict)
        # (task_id, group) -> {host_id: requested shard names (ordered)}
        self._requests: dict[tuple[str, str], dict[str, list[str]]] = {}
        # (task_id, group, host_id) -> last emitted assignment
        self._last: dict[tuple[str, str, str], list[str]] = {}
        self._seq = 0

    @staticmethod
    def group_of(topology) -> str:
        """The co-location group a peer swaps within: its pod; "" for
        pod-less hosts (one flat group)."""
        return pod_id(topology)

    def assign(self, *, task_id: str, peer_id: str, host_id: str,
               topology, requested: list[str]) -> list[str]:
        """Rule this peer's tree-fetch subset of ``requested``. Owners
        are rendezvous-hashed per shard over the HOSTS currently
        requesting that shard in the peer's group."""
        group = self.group_of(topology)
        key = (task_id, group)
        reqs = self._requests.get(key)
        if reqs is None:
            if len(self._requests) >= self.MAX_TASKS:
                oldest = next(iter(self._requests))
                del self._requests[oldest]
                self._last = {k: v for k, v in self._last.items()
                              if (k[0], k[1]) != oldest}
            reqs = self._requests[key] = {}
        reqs[host_id] = list(requested)
        # group shards by their REQUESTER SET and balance within each:
        # replicas requesting the same shards each get an exact 1/n
        # slice; shards requested by only some members are balanced
        # among exactly those
        by_sig: dict[tuple[str, ...], list[str]] = {}
        for name in requested:
            owners = tuple(sorted(hid for hid, names in reqs.items()
                                  if name in names))
            by_sig.setdefault(owners, []).append(name)
        mine: set[str] = set()
        for owners, group_names in by_sig.items():
            split = split_affinity(group_names, owners)
            mine.update(n for n, o in split.items() if o == host_id)
        assigned = [n for n in requested if n in mine]
        solo = len(reqs) == 1
        _assignments.labels("solo" if solo else "assigned").inc()
        memo_key = (task_id, group, host_id)
        if self._last.get(memo_key) != assigned:
            self._last[memo_key] = assigned
            self._emit(task_id=task_id, peer_id=peer_id, host_id=host_id,
                       group=group, requested=requested,
                       assigned=assigned, members=len(reqs))
        return assigned

    def _emit(self, *, task_id: str, peer_id: str, host_id: str,
              group: str, requested: list[str], assigned: list[str],
              members: int) -> None:
        log.info("shard affinity: %s gets %d/%d requested shards "
                 "(group %s, %d replicas)", host_id, len(assigned),
                 len(requested), group or "<flat>", members)
        if self.sink is None:
            return
        self._seq += 1
        self.sink({
            "kind": "decision",
            "decision_id": f"s{self._seq:08d}.{peer_id[-12:]}",
            "decision_kind": "shard",
            "task_id": task_id,
            "peer_id": peer_id,
            "host_id": host_id,
            "group": group,
            "group_members": members,
            "requested": list(requested),
            "assigned": list(assigned),
            "swap": [n for n in requested if n not in assigned],
            "candidates": [],
            "excluded": [],
            "chosen": list(assigned),
        })

    def state_bytes(self) -> int:
        """Bytes of shard-affinity state (request tables, assignment memos)
        for ``/debug/ctrl``; a deep sizeof walk, at snapshot cadence
        only."""
        from ..common.sizeof import deep_sizeof
        seen: set = set()
        return sum(deep_sizeof(o, seen)
                   for o in (self._requests, self._last))

    def drop_task(self, task_id: str) -> None:
        """Task GC (``Resource.on_task_evict``): request tables die with
        the task."""
        for key in [k for k in self._requests if k[0] == task_id]:
            del self._requests[key]
        self._last = {k: v for k, v in self._last.items()
                      if k[0] != task_id}

    def forget_host(self, host_id: str) -> None:
        """Host leave/GC: its shard requests stop anchoring ownership, so
        the next register of a surviving replica re-rules the dead host's
        shards onto the living. The daemon-side swap hold covers the
        window in between. Its assignment memos go too: a
        re-registration must emit a fresh ledger row even when it
        re-rules the identical subset."""
        for reqs in self._requests.values():
            reqs.pop(host_id, None)
        self._last = {k: v for k, v in self._last.items()
                      if k[2] != host_id}

    def swap_partners(self, task_id: str, a_host: str, a_topology,
                      b_host: str, b_topology) -> bool:
        """True when two hosts of one group request a shard in common:
        each may hold what the other is assigned to swap, so each must be
        allowed to feed the other."""
        group = self.group_of(a_topology)
        if group != self.group_of(b_topology):
            return False
        reqs = self._requests.get((task_id, group))
        if reqs is None or a_host not in reqs or b_host not in reqs:
            return False
        return not set(reqs[a_host]).isdisjoint(reqs[b_host])
