"""Cross-pod federation: per-pod seed election + DCN routing policy.

Counterpart of ``dragonfly2_tpu/scheduler/federation.py``: the same
ring walk, elections, decision rows and durable-state format. Dragonfly2's scheduler treats the
whole cluster as one flat peer pool, which at TPU scale recreates the
feeder-limited regime of the MLPerf-on-pods papers: every pod's daemons
independently cross the thin DCN links (or hammer the origin) while
4.8 TB/s of ICI sits idle. This module gives the scheduler the second
tree level: for each (task, pod) a small SEED SET is
elected by hash-ring over the pod's announced members — quarantine-aware,
exactly like ``SeedPeerClient._elect`` walks the origin-seed ring — and
only those seeds may take cross-pod parents. Everyone else stays inside
the pod, so the distribution chain is origin → pod-seed (one DCN copy
per pod) → in-pod ICI relay tree (the cut-through relay).

The view is fed from the announce plane (``observe_host`` on every
register/AnnounceHost, ``forget_host`` on leave — the same cadence the
quarantine registry rides), so elections are a pure deterministic
function of {task id, pod membership, quarantine state}. A seed that
dies (host leave / stream gone) or walks into quarantine is replaced by
the next clockwise ring member on the next ruling that needs it — the
mid-pull seed-kill chaos path — and every (re)election is emitted as a
``kind=decision`` row (``decision_kind="federation"``) so federation
fairness is offline-replayable like every other ruling.

Hosts with NO pod identity (``tpu.topology.pod_id`` == "", the plain
DCN peer fallback) are never restricted: a topology-less cluster runs
the exact pre-federation scoring path.
"""

from __future__ import annotations

import logging

from ..common.metrics import REGISTRY
from ..idl.messages import TopologyInfo
from ..rpc.balancer import HashRing
from ..tpu.topology import pod_id

log = logging.getLogger("df.sched.federation")

_pods_gauge = REGISTRY.gauge(
    "df_federation_pods",
    "pods (ICI bandwidth domains) currently known to the federation view")
_elections = REGISTRY.counter(
    "df_federation_elections_total",
    "per-pod seed-set elections, by outcome (elected = a fresh ruling, "
    "reelected = a dead/quarantined seed replaced mid-task, exhausted = "
    "every pod member unusable so the hashed members serve anyway)",
    ("result",))


def walk_ring(ring: HashRing, key: str, members: int, quarantine,
              n: int = 1) -> list[str]:
    """The shared quarantine-aware ring walk: the ``n`` first hashed
    members that are offerable, walking clockwise past QUARANTINED ones.
    With every member quarantined the hashed prefix still serves — a
    wholly quarantined membership beats no injection path at all
    (``SeedPeerClient._elect`` semantics, now shared with the per-pod
    election so both tiers of the tree skip poisoned roots the same
    way)."""
    cands = ring.pick_n(key, members)
    if quarantine is None:
        return cands[:n]
    ok = [hid for hid in cands if quarantine.offerable(hid)]
    return ok[:n] if ok else cands[:n]


class PodFederation:
    """The scheduler's pod view + per-task seed elections.

    Synchronous dict work on the scheduler loop; membership churns at
    announce cadence and elections are memoized per (task, pod), so
    nothing here rides the per-piece hot path."""

    MAX_ELECTIONS = 4096      # (task, pod) memo bound; see seeds_for

    def __init__(self, *, seeds_per_pod: int = 1, quarantine=None,
                 sink=None):
        self.seeds_per_pod = max(1, seeds_per_pod)
        self.quarantine = quarantine
        # decision-ledger hook: callable(row dict) per (re)election ruling
        self.sink = sink
        self._pod_of: dict[str, str] = {}          # host_id -> pod
        self._members: dict[str, set[str]] = {}    # pod -> host ids
        self._rings: dict[str, HashRing] = {}      # pod -> member ring
        self._elected: dict[tuple[str, str], list[str]] = {}
        self._result: dict[tuple[str, str], str] = {}   # last emitted kind
        self._seq = 0

    # -- membership (announce plane) -----------------------------------

    def observe_host(self, host_id: str,
                     topology: TopologyInfo | None) -> None:
        """Register/announce hook. Re-announcing the same coordinates is
        a no-op (pod id is a pure function of them), so elections stay
        sticky across the announce cadence; a host whose pod CHANGES
        (re-scheduled onto another slice) moves rings."""
        pod = pod_id(topology)
        prev = self._pod_of.get(host_id)
        if prev == pod:
            return
        if prev is not None:
            self._drop_member(host_id, prev)
        self._pod_of[host_id] = pod
        if pod:
            self._members.setdefault(pod, set()).add(host_id)
            ring = self._rings.get(pod)
            if ring is None:
                ring = self._rings[pod] = HashRing()
            ring.add(host_id)
        _pods_gauge.set(len(self._members))

    def forget_host(self, host_id: str) -> None:
        """Leave/GC/stream-gone hook: the host stops being electable NOW;
        tasks it was seeding re-elect on their next ruling."""
        pod = self._pod_of.pop(host_id, None)
        if pod:
            self._drop_member(host_id, pod)
        _pods_gauge.set(len(self._members))

    def _drop_member(self, host_id: str, pod: str) -> None:
        members = self._members.get(pod)
        if members is not None:
            members.discard(host_id)
            if not members:
                del self._members[pod]
                self._rings.pop(pod, None)
        ring = self._rings.get(pod)
        if ring is not None:
            ring.remove(host_id)

    def pod_of_host(self, host_id: str) -> str:
        return self._pod_of.get(host_id, "")

    # -- election ------------------------------------------------------

    def _usable(self, host_id: str, pod: str) -> bool:
        if host_id not in self._members.get(pod, ()):
            return False
        return self.quarantine is None or self.quarantine.offerable(host_id)

    def seeds_for(self, task_id: str, pod: str) -> list[str]:
        """The pod's elected seed set for this task — sticky while every
        elected seed stays usable, re-walked (and re-journaled) the
        moment one dies or walks into quarantine."""
        if not pod:
            return []
        key = (task_id, pod)
        cached = self._elected.get(key)
        if cached is not None and all(self._usable(h, pod) for h in cached) \
                and self._result.get(key) != "exhausted":
            # fast path: the election stands. An 'exhausted' memo whose
            # seeds became usable again falls through so the recovery is
            # re-classified (and journaled) instead of silently reusing
            # a ruling made under duress.
            return cached
        ring = self._rings.get(pod)
        members = self._members.get(pod, ())
        if ring is None or not members:
            self._elected.pop(key, None)
            return []
        elected = walk_ring(ring, task_id, len(members), self.quarantine,
                            n=self.seeds_per_pod)
        if self.quarantine is not None \
                and not any(self.quarantine.offerable(h) for h in elected):
            result = "exhausted"
        else:
            result = "reelected" if cached is not None else "elected"
        if cached is not None and elected == cached \
                and self._result.get(key) == result:
            # the re-walk landed on the same ruling IN THE SAME state
            # (the wholly-quarantined exhaustion fallback re-walks per
            # call): refresh the memo silently — re-emitting an
            # identical ruling per allows()/note() call would flood the
            # ledger and the counter at per-candidate rate. A CHANGED
            # classification over the same seeds (healthy -> exhausted,
            # or the recovery back) still emits: operators must see the
            # pod start/stop routing through a quarantined seed.
            self._elected[key] = elected
            return elected
        _elections.labels(result).inc()
        self._result[key] = result
        if len(self._elected) >= self.MAX_ELECTIONS:
            # bounded memo: tasks are GC'd by the resource plane, not
            # here — evict the oldest ruling (insertion-ordered dict);
            # a live task that loses its memo just re-elects the same
            # seeds (pure function of membership + quarantine state)
            oldest = next(iter(self._elected))
            self._elected.pop(oldest)
            self._result.pop(oldest, None)
        self._elected[key] = elected
        if cached is not None:
            log.info("federation: pod %s re-elected seeds %s for task %s "
                     "(was %s)", pod, elected, task_id[:12], cached)
        self._emit(task_id, pod, elected, cached, result)
        return elected

    def _emit(self, task_id: str, pod: str, elected: list[str],
              prev: list[str] | None, result: str) -> None:
        if self.sink is None:
            return
        self._seq += 1
        self.sink({
            "kind": "decision",
            "decision_id": f"f{self._seq:08d}.{pod[-12:]}",
            "decision_kind": "federation",
            "task_id": task_id,
            "pod": pod,
            "result": result,
            "elected": list(elected),
            "previous": list(prev) if prev is not None else None,
            "pod_members": len(self._members.get(pod, ())),
            "candidates": [],
            "excluded": [],
            "chosen": list(elected),
        })

    def drop_task(self, task_id: str) -> None:
        """Task GC (``Resource.on_task_evict``): elections die with the
        task."""
        for key in [k for k in self._elected if k[0] == task_id]:
            del self._elected[key]
            self._result.pop(key, None)

    # -- routing policy (scheduling filter) ----------------------------

    def allows(self, child, parent) -> bool:
        """May ``parent`` serve ``child``? Same pod (or either side
        pod-less): always. Cross-pod: only when the child is one of its
        pod's elected seeds — everyone else gets the bytes one in-pod
        hop later, off the pod seed's ICI tree, instead of opening one
        more DCN stream per child."""
        ctopo = child.host.msg.topology
        ptopo = parent.host.msg.topology
        cpod, ppod = pod_id(ctopo), pod_id(ptopo)
        if not cpod or not ppod or cpod == ppod:
            return True
        # READ-ONLY on purpose: re-observing the child here would
        # re-admit a host forget_host just evicted (a dead seed's OTHER
        # task rules between its two streams' death detections) — the
        # announce plane is the only admission path. A child the view
        # has not seen yet simply is not a seed, and joins the
        # electorate at its next announce.
        return child.host.id in self.seeds_for(child.task.id, cpod)

    def note(self, child) -> dict | None:
        """Per-ruling ledger annotation: the child's pod, its elected
        seed set, and whether this child IS one — why its candidate set
        does or does not cross the DCN, answerable from the row alone."""
        cpod = pod_id(child.host.msg.topology)
        if not cpod:
            return None
        seeds = self.seeds_for(child.task.id, cpod)
        return {"pod": cpod, "pod_seeds": seeds,
                "is_pod_seed": child.host.id in seeds}

    # -- debug ---------------------------------------------------------

    def state_bytes(self) -> int:
        """Bytes of federation state (pod membership, rings, election
        memos) for the /debug/ctrl bytes-per-peer accounting. Deep
        sizeof walk — snapshot cadence only, never on a ruling path."""
        from ..common.sizeof import deep_sizeof
        seen: set = set()
        return sum(deep_sizeof(o, seen) for o in (
            self._pod_of, self._members, self._rings,
            self._elected, self._result))

    def describe(self) -> dict:
        return {
            "seeds_per_pod": self.seeds_per_pod,
            "pods": {pod: sorted(members)
                     for pod, members in sorted(self._members.items())},
            "elections": {f"{tid[:12]}/{pod}": seeds
                          for (tid, pod), seeds in
                          sorted(self._elected.items())},
        }

    # -- durable state (scheduler/statestore.py) -------------------------

    def export_state(self) -> dict:
        """Seed elections + the pod map they stand on. ``pod_of`` IS
        persisted even though membership is announce-fed: ``seeds_for``
        destroys an election memo the moment its pod has no ring, so a
        restore that carried elections without the membership they were
        ruled over would discard every one of them on first query —
        exactly the re-election stampede durability exists to prevent.
        Hosts that died during the outage are evicted the normal way
        (host GC / leave → ``forget_host``) once the live view catches
        up."""
        return {
            "seq": self._seq,
            "pod_of": dict(self._pod_of),
            "elected": [[tid, pod, seeds]
                        for (tid, pod), seeds in self._elected.items()],
            "result": [[tid, pod, res]
                       for (tid, pod), res in self._result.items()],
        }

    def restore(self, state: dict) -> int:
        """Rebuild pods, rings, and election memos from
        :meth:`export_state` output — membership FIRST (rings must exist
        before any ``seeds_for`` runs), memos second, silently: a
        restored election that still stands emits no fresh ledger row."""
        for hid, pod in (state.get("pod_of") or {}).items():
            if pod and hid not in self._pod_of:
                self._pod_of[hid] = pod
                self._members.setdefault(pod, set()).add(hid)
                ring = self._rings.get(pod)
                if ring is None:
                    ring = self._rings[pod] = HashRing()
                ring.add(hid)
        restored = 0
        for tid, pod, seeds in (state.get("elected") or ()):
            self._elected[(tid, pod)] = list(seeds)
            restored += 1
        for tid, pod, res in (state.get("result") or ()):
            self._result[(tid, pod)] = res
        self._seq = max(self._seq, int(state.get("seq", 0)))
        _pods_gauge.set(len(self._members))
        return restored
