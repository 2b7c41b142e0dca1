"""dfbench: the deterministic fakepod simulator and its proofs.

Counterpart of ``dragonfly2_tpu/tools/dfbench.py``. A fan-out over a
simulated pod (2 slices x N/2 hosts plus a dedicated seed host) runs the
port's real scheduler stack under a virtual clock seeded by ``--seed``:
``Resource``/``Peer``, ``Scheduling.find_parents`` with the evaluator's
scoring and the upload-slot accounting of ``Task.set_parents``, the flight
recorder's ``TaskFlight.summarize`` stage math, podscope, the decision
ledger, the ``MLEvaluator``, ``ShardAffinity``, ``ShardTracker``, the
fleet pulse, and the storage stack's reload and span landing. The pieces
each daemon took from each parent hash into ``schedule_digest``; the same
seed gives the same bytes in both packages, so a digest that moves is a
scheduling change.

    python -m dragonfly2_tpu_torch.tools.dfbench --seed 7     # baseline
    python -m dragonfly2_tpu_torch.tools.dfbench --pr19 --device cpu --smoke

Points: the baseline (``--scenario``), ``--pr4`` (schedulers down, with
and without PEX), ``--pr5`` (data-plane replay and the span-landing
self-check), ``--pr6`` (podscope's pod numbers), ``--pr8``
(decision-ledger replay), ``--pr9`` (cold start, pull vs relay, at pod
sizes 64-256), ``--pr10`` (content-store churn), ``--pr12`` (a byzantine
holder, quarantine on vs off), ``--pr13`` (cross-pod federation, flat vs
hierarchical, and a pod seed killed mid-pull), ``--pr11`` (multi-tenant
QoS: a critical pull against a bulk herd on one uplink, split by the
shaper's ``class_shares`` and gated by the governor's ladder),
``--pr14`` (sharded rollout), ``--ctrl`` (the control-plane storm: a
cold register herd, a refresh storm, preemption and shard rulings
through ``Scheduling`` with the quarantine registry, the federation and
shard affinity armed, at 64 daemons and, unless ``--smoke``, 1,000, 5,000
and 10,000), ``--pr17`` (a scheduler crash, durable vs amnesiac),
``--pr18`` (the fleet pulse, with ``fleetpulse_pure``: the storm's
rulings with pulses ingested mid-storm equal those without) and
``--pr19`` (the learned loop: datagen, two seeded fits on ``--device``,
a learned leg). The result is printed, or written to ``--out`` when it
names a file; nothing is written by default.

The fit in ``--pr19`` is the only device work: ``--device`` defaults to
``cuda`` and raises without a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import heapq
import json
import math
import random
import shutil
import sys
import tempfile
import time

from ..common import digest as digestlib
from ..common import faultgate, phasetimer, podscope
from ..common.podscope import _pctl
from ..common.rate import class_shares
from ..common.sharding import ShardTracker, pieces_for_shards
from ..daemon import flight_recorder as fr
from ..daemon.flight_recorder import TaskFlight
from ..daemon.traffic_shaper import CLASS_WEIGHTS
from ..idl.base import dumps as idl_dumps
from ..idl.messages import Host as HostMsg
from ..idl.messages import (AnnounceHostRequest, HostType, LinkType,
                            PulseDigest, ShardInfo, TopologyInfo)
from ..scheduler.ctrl_debug import CtrlObservatory
from ..scheduler.decision_ledger import (DecisionLedger, replay_decisions,
                                         replay_regret)
from ..scheduler.evaluator import make_evaluator
from ..scheduler.evaluator_ml import MLEvaluator, parent_feature_row
from ..scheduler.federation import PodFederation
from ..scheduler.fleetpulse import FleetPulse
from ..scheduler.quarantine import QUARANTINED, QuarantineRegistry
from ..scheduler.resource import Peer, PeerState, Resource, Task
from ..scheduler.scheduling import Scheduling
from ..scheduler.shard_affinity import ShardAffinity
from ..scheduler.statestore import SchedulerStateStore
from ..storage import native
from ..storage.manager import StorageConfig, StorageManager
from ..storage.metadata import TaskMetadata
from ..storage.store import TaskStorage
from ..tpu.topology import LINK_TIER_NAMES, link_type
from ..trainer import pipeline, serving, training
from ..trainer.features import label_from_cost

# The reference simulator's model inputs: a modeled TPU pod's links (bytes
# per second, milliseconds) and its host-to-device rate. They are the
# virtual clock's constants, not the rates of any card; every committed
# digest depends on them.
LINK_BW_BPS = {LinkType.LOCAL: 20e9, LinkType.ICI: 8e9,
               LinkType.DCN: 1.5e9, LinkType.WAN: 0.3e9}
LINK_RTT_MS = {LinkType.LOCAL: 0.05, LinkType.ICI: 0.3,
               LinkType.DCN: 1.5, LinkType.WAN: 8.0}
HBM_BW_BPS = 5e9                 # host-buffer -> device DMA (modeled)
TTFB_QUEUE_FACTOR = 0.35         # parent-side queueing per active transfer
WIRE_SHARE_FACTOR = 0.15         # bandwidth dilution per active transfer
REFRESH_EVERY = 8                # pieces landed between parent refreshes
POLL_MS = 5.0                    # starved-worker re-poll (virtual)
PEX_CONVERGE_MS = 40.0           # modeled gossip round trip to membership

SCENARIOS = ("baseline", "scheds_down_no_pex", "scheds_down_pex")
# cold start: every daemon joins within COLD_JOIN_MS of t=0 against one
# pre-seeded host; ``cold_pull`` is store-and-forward, ``cold_relay``
# cut-through with the scheduler's relay fan-out cap
COLD_SCENARIOS = ("cold_pull", "cold_relay")
COLD_JOIN_MS = 2.0               # cold herd: all joins inside this window
COLD_REFRESH_MS = 25.0           # starvation-refresh throttle (cold sizes)
RELAY_FANOUT = 4                 # tree cap the cold_relay scheduler applies

STAGES = ("schedule", "first_byte", "wire", "hbm", "total")
_ROW_KEY = {"schedule": "queue_ms", "first_byte": "ttfb_ms",
            "wire": "wire_ms", "hbm": "hbm_ms", "total": "total_ms"}

class _Leecher:
    __slots__ = ("peer", "flight", "done", "inflight", "parents",
                 "schedule", "landed_at", "joined_ms", "done_ms",
                 "since_refresh", "pex_at", "timeline", "arrive",
                 "last_refresh", "relay_pulls")

    def __init__(self, peer, flight, joined_ms: float):
        self.peer = peer
        self.flight = flight
        self.done: set[int] = set()
        self.inflight: set[int] = set()
        self.parents: list = []
        self.schedule: list[list] = []     # [piece, parent_id] in order
        self.landed_at: dict[int, float] = {}
        self.joined_ms = joined_ms
        self.done_ms = 0.0
        self.since_refresh = 0
        self.pex_at = 0.0                  # when gossip membership converges
        # (t_wire_done, wire_ms, size) per landed piece: the data-plane
        # replay's input (collect_timeline); never in the rng path
        self.timeline: list[tuple[float, float, int]] = []
        # cut-through: per dispatched piece, when its first and last byte
        # land here; a child relaying off this leecher rides one hop-RTT
        # behind these
        self.arrive: dict[int, tuple[float, float]] = {}
        self.last_refresh = -1e9           # starvation-refresh throttle
        self.relay_pulls = 0               # pieces pulled cut-through


# pseudo-parent id of a back-source fetch (flight events carry parent "")
_ORIGIN_ID = "origin"


def _topo(slice_name: str, x: int, y: int) -> TopologyInfo:
    return TopologyInfo(slice_name=slice_name, ici_coords=(x, y),
                        zone="bench-zone")


def run_bench(*, seed: int = 7, daemons: int = 8, pieces: int = 64,
              piece_size: int = 4 << 20, parallelism: int = 4,
              scenario: str = "baseline",
              collect_timeline: bool = False,
              collect_podscope: bool = False,
              collect_decisions: bool = False,
              collect_outcomes: bool = False,
              evaluator=None,
              quarantine=None,
              origin_link: LinkType = LinkType.WAN) -> dict:
    """One simulated fan-out; returns the result dict, a pure function of
    the arguments. ``collect_timeline`` attaches each daemon's landings
    (the ``--pr5`` replay's input), ``collect_podscope`` per-daemon
    snapshots in the ``common/podscope.py`` shape (``--pr6``, ``--pr9``),
    ``collect_decisions`` the decision ledger's rows and
    ``collect_outcomes`` one ``kind=piece`` row per p2p transfer (the
    ``--pr19`` training data); none of them touches the rng, so the digest
    stays. ``evaluator`` swaps the scoring policy (default
    ``make_evaluator("default")``). ``quarantine``: an armed (possibly
    empty) ``QuarantineRegistry`` in the filter; an evidence-free one
    answers healthy for every candidate and leaves the digest as it is
    (``--pr12``'s purity gate)."""
    if scenario not in SCENARIOS + COLD_SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r} "
                         f"(known: {SCENARIOS + COLD_SCENARIOS})")
    cold = scenario in COLD_SCENARIOS
    relay_mode = scenario == "cold_relay"
    scheds_up = scenario == "baseline" or cold
    pex = scenario == "scheds_down_pex"

    rng = random.Random(seed)
    res = Resource()
    task = Task("bench" + "0" * 59, "bench://blob")
    task.set_content_info(pieces * piece_size, piece_size, pieces)
    # the filter's pool shuffle draws from its own stream seeded like the
    # sim's (the reference seeds the module rng for it)
    sched = Scheduling(
        make_evaluator("default") if evaluator is None else evaluator,
        rng=random.Random(seed),
        relay_fanout=RELAY_FANOUT if relay_mode else 0,
        quarantine=quarantine)
    decision_rows: list[dict] = []
    if collect_decisions:
        sched.decision_sink = decision_rows.append
    outcome_rows: list[dict] = []

    def mk_peer(name: str, slice_name: str, x: int, y: int,
                host_type: HostType = HostType.NORMAL, *,
                register: bool = True):
        host = res.store_host(HostMsg(
            id=f"{name}-host", ip="10.0.0.1", port=1, download_port=2,
            type=host_type, topology=_topo(slice_name, x, y)))
        if register:
            return res.get_or_create_peer(f"{name}-peer", task, host)
        # registered (added to the task and DAG) at join time, as a real
        # daemon is: offers only ever name peers that exist
        return Peer(f"{name}-peer", task, host)

    # dedicated seed host outside both slices, holding every piece
    seed_peer = mk_peer("seedh", "slice-seed", 9, 9, HostType.SUPER_SEED)
    seed_peer.transit(PeerState.RUNNING)
    seed_peer.finished_pieces = set(range(pieces))
    seed_peer.transit(PeerState.SUCCEEDED)

    # leechers interleaved across 2 slices on a 2-column grid, joining
    # staggered so late children see a live mesh
    leechers: list[_Leecher] = []
    for i in range(daemons):
        s = i % 2
        idx = i // 2
        peer = mk_peer(f"s{s}w{idx}", f"slice-{s}", idx % 2, idx // 2,
                       register=False)
        if cold:
            joined = (i * COLD_JOIN_MS / max(daemons, 1)) \
                * rng.uniform(0.8, 1.2)
        else:
            joined = i * 20.0 * rng.uniform(0.9, 1.1)
        # a ring sized to the run, so no early event is dropped
        flight = TaskFlight(task.id, peer.id, url="bench://blob",
                            max_events=5 * pieces + 8)
        flight.events.append((joined, fr.REGISTERED, -1, "", 0, 0.0))
        lc = _Leecher(peer, flight, joined)
        if not scheds_up:
            # gossip convergence: bootstrap names only the seed; one
            # jittered PEX round later the leecher knows the membership
            lc.pex_at = joined + PEX_CONVERGE_MS * rng.uniform(1.0, 2.0)
            flight.rung(fr.RUNG_PEX if pex else fr.RUNG_BACK_SOURCE)
        leechers.append(lc)

    by_peer_id = {lc.peer.id: lc for lc in leechers}
    active: dict[str, int] = {}        # parent peer id -> live transfers
    # distinct children each parent has served (cold scenarios): a parent
    # feeding RELAY_FANOUT children ranks behind under-cap holders, so the
    # tree fills breadth-first
    served_children: dict[str, set[str]] = {}

    def refresh_parents(lc: _Leecher, now: float = 0.0) -> None:
        if scheds_up:
            parents = sched.find_parents(lc.peer)
            lc.parents = parents
            lc.peer.last_offer_ids = {p.id for p in parents}
            task.set_parents(lc.peer.id, [p.id for p in parents])
            return
        if not pex:
            lc.parents = []            # no discovery path at all
            return
        # PEX: the seed (bootstrap) at once; every converged leecher once
        # this one has converged too
        parents = [seed_peer]
        if now >= lc.pex_at:
            parents += [o.peer for o in leechers
                        if o is not lc and now >= o.pex_at]
        lc.parents = parents

    def holds(parent, piece: int, now: float) -> bool:
        if parent is seed_peer:
            return True
        src = by_peer_id.get(parent.id)
        if src is None:
            return False
        t = src.landed_at.get(piece)
        if t is not None and t <= now:
            return True
        # cut-through: a piece the parent has dispatched is requestable
        return relay_mode and piece in src.arrive

    def landed_now(parent, piece: int, now: float) -> bool:
        if parent is seed_peer:
            return True
        src = by_peer_id.get(parent.id)
        if src is None:
            return False
        t = src.landed_at.get(piece)
        return t is not None and t <= now

    def pick(lc: _Leecher, now: float):
        """(piece, parent_or_None) for the next fetch, or None while
        starved: the lowest needed piece; among its holders the least
        loaded on the fastest link. A None parent is a back-source fetch."""
        for piece in range(pieces):
            if piece in lc.done or piece in lc.inflight:
                continue
            holders = [p for p in lc.parents if holds(p, piece, now)]
            if not holders:
                if not scheds_up and not pex:
                    return piece, None     # origin absorbs the pull
                continue
            lt = {p.id: link_type(lc.peer.host.msg.topology,
                                  p.host.msg.topology) for p in holders}
            if cold:
                # the dispatcher's rank: seeds strictly last, then (relay)
                # under-cap holders and earlier copies, then load and link
                def is_seed(p) -> int:
                    return 1 if p is seed_peer \
                        or p.host.msg.type != HostType.NORMAL else 0

                def capped(p) -> int:
                    kids = served_children.get(p.id)
                    if kids is None or lc.peer.id in kids:
                        return 0           # adopted children keep their edge
                    return 1 if len(kids) >= RELAY_FANOUT else 0

                def avail_ms(p) -> float:
                    # when this holder's copy lands: 0 = ready now
                    if landed_now(p, piece, now):
                        return 0.0
                    up = by_peer_id[p.id].arrive.get(piece)
                    return up[1] if up is not None else 1e12
                holders.sort(key=lambda p: (
                    is_seed(p),
                    capped(p) if relay_mode else 0,
                    avail_ms(p) if relay_mode else 0.0,
                    active.get(p.id, 0), int(lt[p.id]), p.id))
            else:
                holders.sort(key=lambda p: (active.get(p.id, 0),
                                            int(lt[p.id]), p.id))
            return piece, holders[0]
        return None

    # discrete events (time_ms, seq, kind, ...): ("worker", i) a worker of
    # leecher i is free; ("land", i, piece, pid, tw) a transfer's wire half
    # finished. A transfer holds its parent's ``active`` slot from dispatch
    # to wire-done, so contention builds when pulls overlap.
    events: list[tuple] = []
    seq = 0

    def push(t: float, *payload) -> None:
        nonlocal seq
        heapq.heappush(events, (t, seq, *payload))
        seq += 1

    for i, lc in enumerate(leechers):
        for _ in range(parallelism):
            push(lc.joined_ms, "worker", i)

    finished = 0
    while events and finished < len(leechers):
        now, _s, kind, i, *rest = heapq.heappop(events)
        lc = leechers[i]
        if kind == "land":
            piece, parent_id, t_wire = rest
            lc.inflight.discard(piece)
            lc.done.add(piece)
            lc.landed_at[piece] = t_wire
            lc.peer.finished_pieces.add(piece)
            active[parent_id] = max(0, active.get(parent_id, 0) - 1)
            lc.since_refresh += 1
            if len(lc.done) >= pieces:
                lc.flight.state = "success"
                if scheds_up:
                    lc.peer.transit(PeerState.SUCCEEDED)
                finished += 1
            elif lc.since_refresh >= REFRESH_EVERY:
                lc.since_refresh = 0
                refresh_parents(lc, now)
            continue
        # worker event
        if len(lc.done) + len(lc.inflight) >= pieces:
            continue                     # nothing left for this worker
        if scheds_up and lc.peer.id not in task.peers:
            # join: register once and take the first offer
            task.add_peer(lc.peer)
            lc.peer.transit(PeerState.RUNNING)
            refresh_parents(lc)
        if not lc.parents:
            refresh_parents(lc, now)
        got = pick(lc, now)
        if got is None:
            # starved: refresh the offer and re-poll in virtual time; cold
            # sizes throttle the refresh (COLD_REFRESH_MS)
            if not cold or now - lc.last_refresh >= COLD_REFRESH_MS:
                lc.last_refresh = now
                refresh_parents(lc, now)
            push(now + POLL_MS, "worker", i)
            continue
        piece, parent = got
        lc.inflight.add(piece)
        if parent is None:
            # schedulers down, no PEX: the origin serves the piece over
            # ``origin_link``, one contended egress for the whole pod
            lc.schedule.append([piece, _ORIGIN_ID])
            load = active.get(_ORIGIN_ID, 0)
            active[_ORIGIN_ID] = load + 1
            ttfb_ms = (LINK_RTT_MS[origin_link]
                       * (1.0 + TTFB_QUEUE_FACTOR * load)
                       * rng.uniform(0.9, 1.3))
            wire_ms = (piece_size / LINK_BW_BPS[origin_link] * 1000.0
                       * (1.0 + WIRE_SHARE_FACTOR * load)
                       * rng.uniform(0.9, 1.25))
            hbm_ms = piece_size / HBM_BW_BPS * 1000.0 * rng.uniform(0.95, 1.15)
            t_wire = now + ttfb_ms + wire_ms
            t_hbm = t_wire + hbm_ms
            lc.flight.events.append((t_wire, fr.WIRE_DONE, piece, "",
                                     piece_size, wire_ms))
            lc.flight.events.append((t_hbm, fr.HBM_DONE, piece, "",
                                     piece_size, 0.0))
            lc.done_ms = max(lc.done_ms, t_hbm)
            if collect_timeline:
                lc.timeline.append((t_wire, wire_ms, piece_size))
            push(t_wire, "land", i, piece, _ORIGIN_ID, t_wire)
            push(t_hbm, "worker", i)
            continue
        lc.schedule.append([piece, parent.id])
        if cold:
            served_children.setdefault(parent.id, set()).add(lc.peer.id)
        lt = link_type(lc.peer.host.msg.topology, parent.host.msg.topology)
        load = active.get(parent.id, 0)
        active[parent.id] = load + 1
        queue_ms = rng.uniform(0.1, 0.5)
        ttfb_ms = (LINK_RTT_MS[lt] * (1.0 + TTFB_QUEUE_FACTOR * load)
                   * rng.uniform(0.9, 1.3))
        wire_ms = (piece_size / LINK_BW_BPS[lt] * 1000.0
                   * (1.0 + WIRE_SHARE_FACTOR * load) * rng.uniform(0.9, 1.25))
        hbm_ms = piece_size / HBM_BW_BPS * 1000.0 * rng.uniform(0.95, 1.15)
        t_disp = now + queue_ms
        t_first = t_disp + ttfb_ms
        t_wire = t_first + wire_ms
        if relay_mode and parent is not seed_peer \
                and not landed_now(parent, piece, now):
            # cut-through hop: one hop-RTT behind the parent's own first
            # and last byte, never faster than this child's wire time
            up = by_peer_id[parent.id].arrive.get(piece)
            if up is not None:
                hop = LINK_RTT_MS[lt]
                t_first = max(t_first, up[0] + hop)
                t_wire = max(t_first + wire_ms, up[1] + hop)
                lc.relay_pulls += 1
        t_hbm = t_wire + hbm_ms
        if collect_outcomes:
            # one kind=piece row per p2p transfer, in the records schema:
            # the child's newest decision_id, the scoring-time features and
            # the observed-bandwidth label (a readout, no rng draw)
            cost_ms = ttfb_ms + wire_ms
            outcome_rows.append({
                "kind": "piece",
                "task_id": task.id,
                "peer_id": lc.peer.id,
                "host_id": lc.peer.host.id,
                "decision_id": lc.peer.last_decision_id,
                "parent_peer_id": parent.id,
                "parent_host_id": parent.host.id,
                "piece_num": piece,
                "piece_length": piece_size,
                "cost_ms": cost_ms,
                "success": True,
                "fail_code": "",
                "features": parent_feature_row(
                    lc.peer, parent, total_piece_count=pieces),
                "label": label_from_cost(piece_size, cost_ms),
                "created_at": now,
            })
        lc.arrive[piece] = (t_first, t_wire)
        ev = lc.flight.events.append
        ev((now, fr.SCHEDULED, piece, parent.id, 0, 0.0))
        ev((t_disp, fr.DISPATCHED, piece, parent.id, 0, 0.0))
        ev((t_first, fr.FIRST_BYTE, piece, parent.id, 0, 0.0))
        ev((t_wire, fr.WIRE_DONE, piece, parent.id, piece_size, wire_ms))
        ev((t_hbm, fr.HBM_DONE, piece, "", piece_size, 0.0))
        lc.done_ms = max(lc.done_ms, t_hbm)
        if collect_timeline:
            lc.timeline.append((t_wire, wire_ms, piece_size))
        push(t_wire, "land", i, piece, parent.id, t_wire)
        push(t_hbm, "worker", i)         # worker busy through HBM staging

    result = _summarize(leechers, seed=seed, daemons=daemons, pieces=pieces,
                        piece_size=piece_size, parallelism=parallelism,
                        scenario=scenario)
    if cold:
        result["relay_pulled_pieces"] = sum(lc.relay_pulls
                                            for lc in leechers)
    if collect_timeline:
        result["timeline"] = {lc.peer.id: sorted(lc.timeline)
                              for lc in leechers}
    if collect_decisions:
        result["decisions"] = decision_rows
    if collect_outcomes:
        result["outcomes"] = outcome_rows
    if collect_podscope:
        # per-daemon snapshots in the podscope shape, on one shared
        # virtual epoch (started_at=0: the events' t_ms are absolute
        # virtual times). The seed rides along with no flight: podscope
        # reads a serve-only node as a root holder
        snaps = [{"addr": seed_peer.id, "flights": {}}]
        for lc in leechers:
            dump = lc.flight.timeline()
            dump["started_at"] = 0.0
            dump["summary"] = lc.flight.summarize()
            snaps.append({"addr": lc.peer.id, "flights": {task.id: dump}})
        result["podscope_snapshots"] = snaps
    return result


def _summarize(leechers, *, seed, daemons, pieces, piece_size,
               parallelism, scenario="baseline") -> dict:
    rows: list[dict] = []
    per_daemon = {}
    schedules = {}
    seed_pieces = 0
    total_pieces = 0
    bytes_p2p = bytes_source = 0
    for lc in leechers:
        summary = lc.flight.summarize()
        rows.extend(summary["piece_rows"])
        bytes_p2p += summary["bytes_p2p"]
        bytes_source += summary["bytes_source"]
        per_daemon[lc.peer.id] = {
            "pieces": summary["pieces"],
            "bytes": summary["bytes_p2p"] + summary["bytes_source"],
            "joined_ms": round(lc.joined_ms, 3),
            "done_ms": round(lc.done_ms, 3),
            "tail_ms": summary["tail_ms"],
            # the reference's health plane annotates summaries with SLO
            # breaches; this package's carry none (ROADMAP known
            # difference 26), so the key reads {}
            "slo_breaches": summary.get("slo_breaches", {}),
        }
        schedules[lc.peer.id] = lc.schedule
        total_pieces += len(lc.schedule)
        seed_pieces += sum(1 for _, p in lc.schedule
                           if p.startswith("seedh"))
    stage_latency = {}
    for stage in STAGES:
        vals = sorted(r[_ROW_KEY[stage]] for r in rows)
        stage_latency[stage] = {"p50": _pctl(vals, 0.50),
                                "p95": _pctl(vals, 0.95),
                                "p99": _pctl(vals, 0.99)}
    wall_ms = max((lc.done_ms for lc in leechers), default=0.0)
    total_bytes = sum(d["bytes"] for d in per_daemon.values())
    digest = hashlib.sha256(
        json.dumps(schedules, sort_keys=True).encode()).hexdigest()
    return {
        "bench": "dfbench-fakepod",
        "virtual_clock": True,
        "seed": seed,
        "scenario": scenario,
        "daemons": daemons,
        "pieces": pieces,
        "piece_size": piece_size,
        "parallelism": parallelism,
        "wall_ms": round(wall_ms, 3),
        "throughput_bps": (round(total_bytes / (wall_ms / 1000.0))
                           if wall_ms > 0 else 0),
        "stage_latency_ms": stage_latency,
        "seed_served_ratio": (round(seed_pieces / total_pieces, 4)
                              if total_pieces else 0.0),
        "p2p_served_ratio": (round(bytes_p2p / (bytes_p2p + bytes_source), 4)
                             if bytes_p2p + bytes_source else 0.0),
        "per_daemon": per_daemon,
        "schedule_digest": digest,
        "schedules": schedules,
    }


# ---------------------------------------------------------------- --pr5
# Data-plane replay: the baseline schedule replayed through two landing
# models. ``legacy`` hashes every piece on the event loop plus one
# to_thread hop per piece; ``zero_stall`` keeps only the network-chunk
# copy on the loop and one landing hop per span. Each daemon's landings
# serialize on its loop. The costs are the reference's modeled inputs.
LOOP_HASH_BPS = 2.5e9       # on-loop verify traversal
LOOP_MEMCPY_BPS = 12e9      # network-chunk copy into the piece buffer
LEGACY_LAND_MS = 0.15       # one to_thread hop per piece (legacy)
ZERO_STALL_LAND_MS = 0.05   # one landing hop per span (zero_stall)
BENCH_STALL_MS = 10.0       # loop-busy run length that counts as a stall

REPLAY_MODELS = ("legacy", "zero_stall")


def replay_dataplane(timelines: dict, model: str) -> dict:
    """Per-daemon landing serialization of a fixed schedule
    (``run_bench(collect_timeline=True)``) under one landing-cost model.
    Pure: never touches the sim's rng."""
    if model not in REPLAY_MODELS:
        raise ValueError(f"unknown replay model {model!r}")
    delays: list[float] = []      # per-piece landing delay (queue + cost)
    adj_wire: list[float] = []    # wire_ms + landing delay
    busy_runs: list[float] = []   # contiguous loop-busy stretches
    total_busy = 0.0
    total_span = 0.0
    for events in timelines.values():
        free_at = None
        run_start = None
        first_t = last_done = None
        for t, wire_ms, size in sorted(events):
            cost = size / LOOP_MEMCPY_BPS * 1e3
            if model == "legacy":
                cost += size / LOOP_HASH_BPS * 1e3 + LEGACY_LAND_MS
            else:
                cost += ZERO_STALL_LAND_MS
            if free_at is None or t >= free_at:
                if run_start is not None:
                    busy_runs.append(free_at - run_start)
                run_start = t
                start = t
            else:
                start = free_at
            done = start + cost
            free_at = done
            delays.append(done - t)
            adj_wire.append(wire_ms + (done - t))
            total_busy += cost
            first_t = t if first_t is None else first_t
            last_done = done
        if run_start is not None:
            busy_runs.append(free_at - run_start)
        if first_t is not None:
            total_span += max(last_done - first_t, 1e-9)
    delays.sort()
    adj_wire.sort()
    return {
        "loop_lag_ms": {"p50": _pctl(delays, 0.50),
                        "p95": _pctl(delays, 0.95),
                        "p99": _pctl(delays, 0.99)},
        "max_loop_lag_ms": round(max(busy_runs, default=0.0), 3),
        "loop_stalls": sum(1 for r in busy_runs if r > BENCH_STALL_MS),
        "loop_busy_fraction": (round(total_busy / total_span, 4)
                               if total_span else 0.0),
        "stage_latency_ms": {"wire": {"p50": _pctl(adj_wire, 0.50),
                                      "p95": _pctl(adj_wire, 0.95),
                                      "p99": _pctl(adj_wire, 0.99)}},
    }


def _selfcheck_span_landing() -> dict:
    """A two-piece span through ``TaskStorage.write_span`` must land in one
    pass and verify, and a corrupted piece must be refused without failing
    its groupmate. ``span_write`` names the traversal: ``native`` (fused
    pwrite and crc32c in the native library) or ``python``."""
    algo = digestlib.preferred_piece_algo()
    path = ("native" if algo == "crc32c" and native.available()
            else "python")
    ok = False
    try:
        with tempfile.TemporaryDirectory() as d:
            blob = bytes(range(256)) * 1024            # 2 x 128 KiB pieces
            half = len(blob) // 2
            spec = [(0, 0, half, digestlib.for_bytes(algo, blob[:half])),
                    (1, half, half, digestlib.for_bytes(algo, blob[half:]))]
            ts = TaskStorage(f"{d}/good", TaskMetadata(
                task_id="bench-selfcheck-good", url="bench://selfcheck"))
            metas, corrupt = ts.write_span(spec, blob)
            ok = (len(metas) == 2 and not corrupt
                  and ts.read_piece(0) == blob[:half]
                  and ts.read_piece(1) == blob[half:])
            bad = bytearray(blob)
            bad[3] ^= 0xFF                             # corrupt piece 0 only
            ts2 = TaskStorage(f"{d}/bad", TaskMetadata(
                task_id="bench-selfcheck-bad", url="bench://selfcheck"))
            metas2, corrupt2 = ts2.write_span(spec, bytes(bad))
            ok = ok and corrupt2 == [0] and [m.num for m in metas2] == [1]
    except Exception:  # noqa: BLE001 - the gate wants a verdict, not a trace
        ok = False
    return {"span_write": path, "per_piece_fallback": not ok}


def _run_pr5(args) -> dict:
    """One baseline sim replayed through both landing models, plus the
    span-landing self-check."""
    base = run_bench(seed=args.seed, daemons=args.daemons,
                     pieces=args.pieces, piece_size=args.piece_size,
                     parallelism=args.parallelism, collect_timeline=True)
    timeline = base.pop("timeline")
    del base["schedules"]
    models = {m: replay_dataplane(timeline, m) for m in REPLAY_MODELS}
    return {
        "bench": "dfbench-dataplane",
        "seed": args.seed,
        "daemons": args.daemons,
        "pieces": args.pieces,
        "piece_size": args.piece_size,
        "parallelism": args.parallelism,
        "schedule_digest": base["schedule_digest"],
        "baseline": base,
        "models": models,
        "improvement": {
            "wire_p95_ms": {m: models[m]["stage_latency_ms"]["wire"]["p95"]
                            for m in REPLAY_MODELS},
            "max_loop_lag_ms": {m: models[m]["max_loop_lag_ms"]
                                for m in REPLAY_MODELS},
            "loop_stalls": {m: models[m]["loop_stalls"]
                            for m in REPLAY_MODELS},
        },
        "landing": _selfcheck_span_landing(),
    }


def _run_pr6(args) -> dict:
    """Podscope's pod numbers (pod makespan, distribution-tree depth,
    origin amplification, per-edge bandwidth percentiles) per scenario,
    over the same runs as the earlier points: the baseline's
    ``schedule_digest`` stays BENCH_pr3's. The baseline's amplification
    is 1.0 (the content crossed the origin uplink once); the outage
    without PEX shows N daemons' worth."""
    scenarios = {}
    for sc in SCENARIOS:
        r = run_bench(**_bench_kw(args), scenario=sc, collect_podscope=True)
        report = podscope.aggregate(r.pop("podscope_snapshots"))
        task_report = next(iter(report["tasks"].values()))
        scenarios[sc] = {
            "schedule_digest": r["schedule_digest"],
            "wall_ms": r["wall_ms"],
            "p2p_served_ratio": r["p2p_served_ratio"],
            "podscope": podscope.bench_summary(task_report),
        }
    base = scenarios["baseline"]["podscope"]
    return {
        "bench": "dfbench-podscope",
        "seed": args.seed,
        "daemons": args.daemons,
        "pieces": args.pieces,
        "piece_size": args.piece_size,
        "parallelism": args.parallelism,
        "schedule_digest": scenarios["baseline"]["schedule_digest"],
        "scenarios": scenarios,
        "pod_makespan_ms": {sc: scenarios[sc]["podscope"]["makespan_ms"]
                            for sc in SCENARIOS},
        "tree_depth": {sc: scenarios[sc]["podscope"]["depth"]
                       for sc in SCENARIOS},
        "amplification": {sc: scenarios[sc]["podscope"]["amplification"]
                          for sc in SCENARIOS},
        "edge_bandwidth_p95_bps":
            {sc: scenarios[sc]["podscope"]["edge_bandwidth_bps"]["p95"]
             for sc in SCENARIOS},
        "baseline_bottleneck": base["bottleneck"],
    }


def _bench_kw(args) -> dict:
    return dict(seed=args.seed, daemons=args.daemons, pieces=args.pieces,
                piece_size=args.piece_size, parallelism=args.parallelism)


def _run_pr8(args) -> dict:
    """Decision-ledger purity and counterfactual replay: a ledger-armed
    run of the baseline seed must rule the same schedule, and its logged
    candidate sets re-scored offline under ``default``, ``nt`` and ``ml``
    give the rank agreements and the ``decision_digest``."""
    base = run_bench(**_bench_kw(args))
    led = run_bench(collect_decisions=True, **_bench_kw(args))
    decisions = led["decisions"]
    replay = replay_decisions(decisions)
    return {
        "bench": "dfbench-decisions",
        "seed": args.seed,
        "daemons": args.daemons,
        "pieces": args.pieces,
        "piece_size": args.piece_size,
        "parallelism": args.parallelism,
        "schedule_digest": base["schedule_digest"],
        "ledger_pure": (base["schedule_digest"]
                        == led["schedule_digest"]),
        "decision_rows": len(decisions),
        "decisions_with_candidates": replay["decisions_scored"],
        "excluded_rows": sum(len(d.get("excluded") or [])
                             for d in decisions),
        "cross_evaluator": replay["pairs"],
        "logged_choice_agreement": replay["logged_choice_agreement"],
        "decision_digest": replay["decision_digest"],
    }


def datagen_rows(args) -> list[dict]:
    """The ``--pr19`` training data: the decision rows and per-transfer
    outcome rows of one baseline run."""
    gen = run_bench(collect_decisions=True, collect_outcomes=True,
                    **_bench_kw(args))
    return gen["decisions"] + gen["outcomes"]


def _run_pr19(args) -> dict:
    """The learned loop on one seed. A cold ``MLEvaluator`` and the
    outcome tap must leave the baseline schedule as it is; two seeded
    fits on ``args.device`` must give the same blob; the model replays
    against the heuristic over the logged rows (flip rate, regret); and
    two learned legs served by the two blobs must rule the same schedule
    and decisions. ``fit`` (device, seconds) is read from the wall clock."""
    device = training.resolve_device(args.device)   # no CUDA card: raises
    kw = _bench_kw(args)
    base = run_bench(**kw)
    disarmed = run_bench(evaluator=MLEvaluator(infer=None), **kw)
    gen = run_bench(collect_decisions=True, collect_outcomes=True, **kw)
    rows = gen["decisions"] + gen["outcomes"]
    fit = pipeline.train_decision_model(rows, seed=args.seed, device=device)
    refit = pipeline.train_decision_model(rows, seed=args.seed,
                                          device=device)
    if fit is None or refit is None:
        raise RuntimeError("pr19: datagen run produced too few trainable "
                           "rows — grow --daemons/--pieces")
    blob, metrics = fit
    infer = serving.make_mlp_infer(blob)
    replay = replay_decisions(gen["decisions"],
                              evaluators=("default", "ml"), infer=infer)
    regret = replay_regret(rows, evaluators=("default", "ml"), infer=infer)
    learned = run_bench(evaluator=MLEvaluator(infer=infer),
                        collect_decisions=True, **kw)
    learned2 = run_bench(evaluator=MLEvaluator(infer=serving.make_mlp_infer(
        refit[0])), collect_decisions=True, **kw)
    l_digest = replay_decisions(learned["decisions"])["decision_digest"]
    l2_digest = replay_decisions(learned2["decisions"])["decision_digest"]
    reg = regret["evaluators"]
    return {
        "bench": "dfbench-learned",
        "seed": args.seed,
        "daemons": args.daemons,
        "pieces": args.pieces,
        "piece_size": args.piece_size,
        "parallelism": args.parallelism,
        "schedule_digest": base["schedule_digest"],
        "ml_disarmed_pure": (base["schedule_digest"]
                             == disarmed["schedule_digest"]),
        "outcomes_pure": (base["schedule_digest"]
                          == gen["schedule_digest"]),
        "decision_rows": len(gen["decisions"]),
        "outcome_rows": len(gen["outcomes"]),
        "model": {k: metrics.get(k)
                  for k in ("version", "rows", "supervision",
                            "first_epoch_loss", "final_loss",
                            "schema_version", "feature_dim")},
        "fit": {"device": str(device),
                "seconds": [metrics["train_seconds"],
                            refit[1]["train_seconds"]]},
        "trained_deterministic": (refit[1]["version"]
                                  == metrics["version"]),
        "flip_rate": replay["pairs"]["default_vs_ml"]["choice_flip_rate"],
        "rank_agreement": replay["pairs"]["default_vs_ml"]
        ["rank_agreement"],
        "logged_choice_agreement": replay["logged_choice_agreement"],
        "decisions_judged": regret["decisions_judged"],
        "regret": {"heuristic": reg["default"]["mean_regret"],
                   "learned": reg["ml"]["mean_regret"]},
        "best_pick_rate": {"heuristic": reg["default"]["best_pick_rate"],
                           "learned": reg["ml"]["best_pick_rate"]},
        "mean_chosen_bandwidth_bps": {
            "heuristic": reg["default"]["mean_chosen_bandwidth_bps"],
            "learned": reg["ml"]["mean_chosen_bandwidth_bps"]},
        "learned_beats_heuristic": (reg["ml"]["mean_regret"]
                                    < reg["default"]["mean_regret"]),
        "learned_schedule_digest": learned["schedule_digest"],
        "learned_decision_digest": l_digest,
        "learned_deterministic": (
            learned["schedule_digest"] == learned2["schedule_digest"]
            and l_digest == l2_digest),
        "wall_ms": {"heuristic": base["wall_ms"],
                    "learned": learned["wall_ms"]},
        "seed_served_ratio": {"heuristic": base["seed_served_ratio"],
                              "learned": learned["seed_served_ratio"]},
    }


# Multi-tenant QoS under contention: a ``critical`` foreground pull shares
# one feeder uplink with a ``bulk`` herd. A fluid-flow event simulation on
# a virtual clock: between events every active transfer moves at its
# granted rate, which comes from the daemon shaper's own split
# (``common/rate.class_shares`` over ``traffic_shaper.CLASS_WEIGHTS``)
# with QoS on, and from a plain per-transfer fair share with it off. Bulk
# admission follows the governor's ladder (``daemon/qos.py``):
# ``bulk_active_limit`` concurrent, a bounded queue and wait, shed with
# retry; the queued and shed counts ride the result.

QOS_UPLINK_BPS = 1.5e9          # the shared DCN feeder link
QOS_BULK_ACTIVE_LIMIT = 4       # governor gate in the modeled daemon
QOS_QUEUE_LIMIT = 8
QOS_QUEUE_WAIT_MS = 400.0
QOS_SHED_RETRY_MS = 250.0
QOS_FG_THINK_MS = (1.0, 3.0)    # foreground inter-piece think (jittered)


def run_qos_bench(*, seed: int = 7, fg_pieces: int = 32,
                  bulk_workers: int = 12, piece_size: int = 4 << 20,
                  qos: bool = True, contended: bool = True) -> dict:
    """One contended (or solo-foreground) run; returns per-class piece
    latencies and the shed and queue counts. A pure function of its
    arguments: virtual clock, seeded rng, no globals."""
    rng = random.Random(seed)
    # transfer: [cls, remaining_bytes, size, t_start, worker]
    active: list[list] = []
    fg_latencies: list[float] = []
    bulk_latencies: list[float] = []
    bulk_done_bytes = 0
    counters = {"queued": 0, "shed": 0, "bulk_started": 0}
    fg_started = 0
    t = 0.0

    def rates() -> dict[int, float]:
        """bytes/ms granted to each active transfer at this instant."""
        if not active:
            return {}
        if not qos:
            share = QOS_UPLINK_BPS / len(active) / 1000.0
            return {id(tr): share for tr in active}
        demand: dict[str, float] = {}
        for tr in active:
            demand[tr[0]] = demand.get(tr[0], 0.0) + 1.0
        shares = class_shares(QOS_UPLINK_BPS, CLASS_WEIGHTS, demand)
        return {id(tr): shares[tr[0]] / demand[tr[0]] / 1000.0
                for tr in active}

    # event heap: (t_ms, seq, kind, payload)
    events: list[tuple] = []
    seq = 0

    def push(at: float, kind: str, payload=None) -> None:
        nonlocal seq
        heapq.heappush(events, (at, seq, kind, payload))
        seq += 1

    bulk_queue: list[tuple[float, int]] = []   # (enqueued_at, worker)

    def bulk_size() -> int:
        return int(piece_size * rng.uniform(0.9, 1.1))

    def try_start_bulk(worker: int, now: float) -> None:
        counters_active = sum(1 for tr in active if tr[0] == "bulk")
        if qos and counters_active >= QOS_BULK_ACTIVE_LIMIT:
            if len(bulk_queue) >= QOS_QUEUE_LIMIT:
                # shed: the worker backs off for the governor's hint
                counters["shed"] += 1
                push(now + QOS_SHED_RETRY_MS, "bulk_want", worker)
                return
            counters["queued"] += 1
            bulk_queue.append((now, worker))
            push(now + QOS_QUEUE_WAIT_MS, "bulk_deadline", worker)
            return
        size = bulk_size()
        counters["bulk_started"] += 1
        active.append(["bulk", float(size), size, now, worker])

    def drain_bulk_queue(now: float) -> None:
        while bulk_queue and sum(
                1 for tr in active if tr[0] == "bulk") \
                < QOS_BULK_ACTIVE_LIMIT:
            enq, worker = bulk_queue.pop(0)
            if now - enq > QOS_QUEUE_WAIT_MS:
                counters["shed"] += 1
                push(now + QOS_SHED_RETRY_MS, "bulk_want", worker)
                continue
            size = bulk_size()
            counters["bulk_started"] += 1
            active.append(["bulk", float(size), size, now, worker])

    push(0.0, "fg_want", None)
    if contended:
        for w in range(bulk_workers):
            push(rng.uniform(0.0, 2.0), "bulk_want", w)

    SAFETY_MS = 600_000.0
    while fg_started < fg_pieces or any(tr[0] == "critical"
                                        for tr in active):
        if t > SAFETY_MS:
            break
        # next discrete event vs next transfer completion under current
        # rates (fluid advance between events)
        grant = rates()
        next_done = None
        for tr in active:
            r = grant[id(tr)]
            eta = t + (tr[1] / r if r > 0 else SAFETY_MS)
            if next_done is None or eta < next_done[0]:
                next_done = (eta, tr)
        next_event = events[0][0] if events else None
        if next_done is not None and (next_event is None
                                      or next_done[0] <= next_event):
            # advance the fluid to the completion moment
            dt = next_done[0] - t
            for tr in active:
                tr[1] = max(0.0, tr[1] - grant[id(tr)] * dt)
            t = next_done[0]
            tr = next_done[1]
            active.remove(tr)
            cls, _rem, size, t0, worker = tr
            if cls == "critical":
                fg_latencies.append(t - t0)
                if fg_started < fg_pieces:
                    push(t + rng.uniform(*QOS_FG_THINK_MS),
                         "fg_want", None)
            else:
                bulk_latencies.append(t - t0)
                bulk_done_bytes += size
                if contended:
                    push(t, "bulk_want", worker)
            drain_bulk_queue(t)
            continue
        if next_event is None:
            break
        # advance the fluid to the event moment, then apply it
        dt = next_event - t
        for tr in active:
            tr[1] = max(0.0, tr[1] - grant.get(id(tr), 0.0) * dt)
        t = next_event
        _at, _s, kind, payload = heapq.heappop(events)
        if kind == "fg_want":
            if fg_started < fg_pieces:
                fg_started += 1
                size = int(piece_size * rng.uniform(0.95, 1.05))
                active.append(["critical", float(size), size, t, -1])
        elif kind == "bulk_want":
            try_start_bulk(payload, t)
        elif kind == "bulk_deadline":
            # a queued admission whose bounded wait expired: shed
            for i, (enq, worker) in enumerate(bulk_queue):
                if worker == payload and t - enq >= QOS_QUEUE_WAIT_MS:
                    bulk_queue.pop(i)
                    counters["shed"] += 1
                    push(t + QOS_SHED_RETRY_MS, "bulk_want", worker)
                    break

    fg_sorted = sorted(fg_latencies)
    bulk_sorted = sorted(bulk_latencies)
    makespan = t
    return {
        "qos": qos,
        "contended": contended,
        "fg_pieces_done": len(fg_latencies),
        "fg_pieces_requested": fg_pieces,
        "fg_latency_ms": {"p50": _pctl(fg_sorted, 0.50),
                          "p99": _pctl(fg_sorted, 0.99)},
        "bulk_latency_ms": {"p50": _pctl(bulk_sorted, 0.50),
                            "p99": _pctl(bulk_sorted, 0.99)},
        "bulk_pieces_done": len(bulk_latencies),
        "bulk_throughput_bps": (round(bulk_done_bytes
                                      / (makespan / 1000.0))
                                if makespan > 0 else 0),
        "bulk_queued": counters["queued"],
        "bulk_shed": counters["shed"],
        "makespan_ms": round(makespan, 3),
        # zero starved foreground pieces is the no-deadlock acceptance
        "fg_starved": fg_pieces - len(fg_latencies),
    }


def _run_pr11(args) -> dict:
    """Multi-tenant QoS under contention. The baseline sim keeps its
    ``schedule_digest`` (no class machinery touches the scheduler). Gates:
    the foreground ``critical`` p99 with QoS on stays within 1.5x of its
    uncontended p99, while the same herd without QoS blows it out by an
    order of magnitude; bulk throughput degrades (below the no-QoS
    free-for-all) instead of the pod deadlocking (no starved foreground
    piece, sheds counted)."""
    base = run_bench(**_bench_kw(args))
    # the full shape over-subscribes the governor's gate (16 workers
    # against 4 active and 8 queued) so the point walks the whole ladder,
    # shed included; the smoke shape stays inside the queue
    shape = dict(seed=args.seed,
                 fg_pieces=8 if args.smoke else 32,
                 bulk_workers=6 if args.smoke else 16,
                 piece_size=(256 << 10) if args.smoke else (4 << 20))
    uncontended = run_qos_bench(**shape, qos=True, contended=False)
    contended_no_qos = run_qos_bench(**shape, qos=False, contended=True)
    contended_qos = run_qos_bench(**shape, qos=True, contended=True)
    base_p99 = max(uncontended["fg_latency_ms"]["p99"], 1e-9)
    ratio_qos = round(contended_qos["fg_latency_ms"]["p99"] / base_p99, 4)
    ratio_no_qos = round(
        contended_no_qos["fg_latency_ms"]["p99"] / base_p99, 4)
    scenarios = {"uncontended": uncontended,
                 "contended_no_qos": contended_no_qos,
                 "contended_qos": contended_qos}
    qos_digest = hashlib.sha256(json.dumps(
        scenarios, sort_keys=True).encode()).hexdigest()
    return {
        "bench": "dfbench-qos",
        "seed": args.seed,
        "fg_pieces": shape["fg_pieces"],
        "bulk_workers": shape["bulk_workers"],
        "piece_size": shape["piece_size"],
        "uplink_bps": QOS_UPLINK_BPS,
        # the scheduler sim the QoS plane never touches
        "schedule_digest": base["schedule_digest"],
        "scenarios": scenarios,
        "fg_p99_ratio_qos": ratio_qos,
        "fg_p99_ratio_no_qos": ratio_no_qos,
        "fg_holds_slo": ratio_qos <= 1.5,
        "bulk_degrades": (contended_qos["bulk_throughput_bps"]
                          < contended_no_qos["bulk_throughput_bps"]),
        "bulk_shed": contended_qos["bulk_shed"],
        "bulk_queued": contended_qos["bulk_queued"],
        "fg_starved": contended_qos["fg_starved"],
        "qos_digest": qos_digest,
    }


def _run_pr9(args) -> dict:
    """Cold-start makespan against pod size, store-and-forward against
    cut-through relay (the scheduler's ``relay_fanout`` armed for the
    relay runs), each run's distribution tree read by
    ``podscope.aggregate``. A plain baseline run rides along as the
    relay-disabled digest gate."""
    sizes = [8, 16] if args.smoke else [64, 128, 256]
    base = run_bench(**_bench_kw(args))
    scenarios: dict[str, dict] = {sc: {} for sc in COLD_SCENARIOS}
    for sc in COLD_SCENARIOS:
        for n in sizes:
            r = run_bench(**(_bench_kw(args) | {"daemons": n}),
                          scenario=sc, collect_podscope=True)
            report = podscope.aggregate(r.pop("podscope_snapshots"))
            task_report = next(iter(report["tasks"].values()))
            scenarios[sc][str(n)] = {
                "wall_ms": r["wall_ms"],
                "makespan_ms": task_report["makespan_ms"],
                "depth": task_report["depth"],
                "seed_served_ratio": r["seed_served_ratio"],
                "relay_pulled_pieces": r.get("relay_pulled_pieces", 0),
                "edges": len(task_report["edges"]),
                "schedule_digest": r["schedule_digest"],
            }
    mk = {sc: {str(n): scenarios[sc][str(n)]["makespan_ms"]
               for n in sizes} for sc in COLD_SCENARIOS}
    depth = {sc: {str(n): scenarios[sc][str(n)]["depth"]
                  for n in sizes} for sc in COLD_SCENARIOS}
    pod_growth = sizes[-1] / sizes[0]
    growth = {sc: round(mk[sc][str(sizes[-1])]
                        / max(mk[sc][str(sizes[0])], 1e-9), 3)
              for sc in COLD_SCENARIOS}
    return {
        "bench": "dfbench-coldstart",
        "seed": args.seed,
        "pieces": args.pieces,
        "piece_size": args.piece_size,
        "parallelism": args.parallelism,
        "pod_sizes": sizes,
        "schedule_digest": base["schedule_digest"],
        "scenarios": scenarios,
        "cold_makespan_ms": mk,
        "tree_depth": depth,
        "pod_growth_factor": pod_growth,
        # makespan(max N) / makespan(min N): below pod_growth is sublinear
        "growth_factor": growth,
        "sublinear": growth["cold_relay"] < pod_growth,
        "relay_beats_pull": all(
            mk["cold_relay"][str(n)] < mk["cold_pull"][str(n)]
            for n in sizes),
        "log2_max_pod": round(math.log2(sizes[-1]), 2),
    }


# --------------------------------------------------------------- --pr10
# Content-store churn: rolling restarts and hot-model pulls under alias
# URLs (same content, new task ids) through the storage stack (the
# manager, the content store, reload and re-verify) in a temporary
# directory. The measured quantities are bytes, so no clock is needed.

CHURN_RETAIN_EPOCHS = 2     # task turnover: aliases older than this leave


def run_churn_bench(*, seed: int = 7, daemons: int = 4, epochs: int = 4,
                    pieces: int = 8, piece_size: int = 64 << 10,
                    restart_fraction: float = 0.34,
                    dedupe: bool = True) -> dict:
    """One churn run: per-epoch byte accounting and disk curves. Each
    epoch every daemon pulls the seeded content under a fresh alias URL;
    between epochs a rotating third of the daemons restart (their
    ``StorageManager`` rebuilt over the surviving directory, then
    ``verify_reloaded``). A piece comes from the local content store
    (``placed``), else from any daemon holding it (``p2p``), else the
    ``origin``. ``dedupe=False`` keys the store by task id, the baseline."""
    rng = random.Random(seed)
    content = rng.randbytes(pieces * piece_size)
    algo = digestlib.preferred_piece_algo()
    piece_digests = [
        digestlib.for_bytes(algo, content[i * piece_size:(i + 1) * piece_size])
        for i in range(pieces)]
    content_digest = "sha256:" + hashlib.sha256(content).hexdigest()

    def task_id(epoch: int) -> str:
        # alias URL per epoch -> distinct task id over identical bytes
        return hashlib.sha256(
            f"churn://model?epoch={epoch}&seed={seed}".encode()).hexdigest()

    epoch_rows: list[dict] = []
    with tempfile.TemporaryDirectory(prefix="dfbench-pr10-") as root:
        def make_mgr(i: int) -> StorageManager:
            return StorageManager(StorageConfig(
                data_dir=f"{root}/d{i}", gc_interval_s=3600,
                dedupe_enabled=dedupe, reload_verify=True))

        mgrs = [make_mgr(i) for i in range(daemons)]
        n_restart = max(1, int(daemons * restart_fraction))
        for epoch in range(epochs):
            restarted: list[int] = []
            if epoch > 0:
                # rolling restart: process state lost, disk reloaded
                for k in range(n_restart):
                    i = (epoch * n_restart + k) % daemons
                    restarted.append(i)
                    mgrs[i] = make_mgr(i)
                    mgrs[i].verify_reloaded()
            tid = task_id(epoch)
            origin_b = p2p_b = placed_b = 0
            alias_transfer_b = 0
            for i in range(daemons):
                mgr = mgrs[i]
                md = TaskMetadata(
                    task_id=tid, url=f"churn://model?epoch={epoch}",
                    content_length=len(content),
                    total_piece_count=pieces, piece_size=piece_size,
                    digest=content_digest)
                ts = mgr.register_task(md)
                for num in range(pieces):
                    if num in ts.md.pieces:
                        continue
                    off = num * piece_size
                    dg = piece_digests[num]
                    if mgr.castore is not None and mgr.castore.place_piece(
                            ts, num, off, piece_size, dg):
                        placed_b += piece_size
                        continue
                    data = content[off:off + piece_size]
                    holder = next(
                        (j for j in range(daemons) if j != i
                         and (mgrs[j].castore is not None
                              and mgrs[j].castore.find_piece(
                                  dg, piece_size) is not None
                              or tid in {t.md.task_id
                                         for t in mgrs[j].tasks()
                                         if num in t.md.pieces})),
                        None)
                    ts.write_piece(num, off, data, dg)
                    if holder is not None:
                        p2p_b += piece_size
                    else:
                        origin_b += piece_size
                    if epoch > 0:
                        alias_transfer_b += piece_size
                ts.mark_done(success=True, digest=content_digest)
            # task turnover: shared bytes must live until the last alias
            if epoch >= CHURN_RETAIN_EPOCHS:
                old = task_id(epoch - CHURN_RETAIN_EPOCHS)
                for mgr in mgrs:
                    mgr.delete_task(old)
            logical = physical = 0
            for mgr in mgrs:
                lo, ph = mgr.usage()
                logical += lo
                physical += ph
            epoch_rows.append({
                "epoch": epoch,
                "restarted": restarted,
                "origin_bytes": origin_b,
                "p2p_bytes": p2p_b,
                "placed_bytes": placed_b,
                "alias_transfer_bytes": alias_transfer_b,
                "logical_bytes": logical,
                "physical_bytes": physical,
            })
    content_size = len(content)
    # the digest covers the seeded content's identity and the byte
    # accounting; the per-piece digest algorithm enters neither
    digest = hashlib.sha256(json.dumps(
        {"content": content_digest, "rows": epoch_rows},
        sort_keys=True).encode()).hexdigest()
    return {
        "seed": seed,
        "daemons": daemons,
        "epochs": epochs,
        "pieces": pieces,
        "piece_size": piece_size,
        "content_bytes": content_size,
        "dedupe": dedupe,
        "per_epoch": epoch_rows,
        "origin_bytes_total": sum(r["origin_bytes"] for r in epoch_rows),
        "origin_bytes_after_first_epoch": sum(
            r["origin_bytes"] for r in epoch_rows if r["epoch"] > 0),
        "alias_transfer_bytes": sum(
            r["alias_transfer_bytes"] for r in epoch_rows),
        "max_physical_bytes_per_daemon": max(
            r["physical_bytes"] for r in epoch_rows) // daemons,
        "max_logical_bytes_per_daemon": max(
            r["logical_bytes"] for r in epoch_rows) // daemons,
        "churn_digest": digest,
    }


def _run_pr10(args) -> dict:
    """Content-addressed storage under churn against the task-id-keyed
    baseline, with a plain baseline sim as the scheduler digest gate.
    Acceptance: no origin bytes after the first epoch, alias pulls move
    no bytes, and disk stays about one content copy per daemon."""
    base = run_bench(**_bench_kw(args))
    shape = dict(seed=args.seed,
                 daemons=3 if args.smoke else 4,
                 epochs=2 if args.smoke else 4,
                 pieces=4 if args.smoke else 8,
                 piece_size=(16 << 10) if args.smoke else (64 << 10))
    cas = run_churn_bench(**shape, dedupe=True)
    cold = run_churn_bench(**shape, dedupe=False)
    content = cas["content_bytes"]
    return {
        "bench": "dfbench-castore",
        "seed": args.seed,
        "daemons": shape["daemons"],
        "epochs": shape["epochs"],
        "pieces": shape["pieces"],
        "piece_size": shape["piece_size"],
        "content_bytes": content,
        "schedule_digest": base["schedule_digest"],
        "cas": cas,
        "baseline": cold,
        "origin_bytes_after_first_epoch":
            cas["origin_bytes_after_first_epoch"],
        "alias_transfer_bytes": cas["alias_transfer_bytes"],
        "warm_restart_zero_origin":
            cas["origin_bytes_after_first_epoch"] == 0,
        "alias_pull_zero_transfer": cas["alias_transfer_bytes"] == 0,
        "disk_bounded": cas["max_physical_bytes_per_daemon"]
            <= int(content * 1.25),
        "disk_saving_vs_baseline": round(
            1.0 - cas["max_physical_bytes_per_daemon"]
            / max(cold["max_physical_bytes_per_daemon"], 1), 4),
        "baseline_origin_bytes_after_first_epoch":
            cold["origin_bytes_after_first_epoch"],
        "churn_digest": cas["churn_digest"],
    }


# --------------------------------------------------------------- --pr14
# Sharded-checkpoint rollout: ``positions x replicas`` hosts of one pod
# each need their position's shards. ``roll_naive`` pulls the whole file
# per host; ``roll_sharded`` splits each position group's request across
# its replicas (``ShardAffinity``), fetches the host's share from the tree
# and swaps the rest in the pod, with ``ShardTracker`` turning landings
# into per-shard ready times. ``kill_owner`` kills one host halfway
# through its tree share: its group falls back to the tree after the
# swap hold.

ROLLOUT_SCENARIOS = ("roll_naive", "roll_sharded")
ROLLOUT_SHARDS = 32          # named shards per checkpoint
ROLLOUT_SWAP_HOLD_MS = 60.0  # modeled swap hold before tree fallback


class _ReferenceFilter(Scheduling):
    """``Scheduling`` with the reference's filter: swap partners are held
    to the cycle and bad-node rules like any other parent. The port exempts
    them (ROADMAP known difference 13), which moves the sharded rollout's
    schedules at 4x4 and 8x8 hosts."""

    def _swap_partners(self, child, parent) -> bool:
        return False


def run_rollout_bench(*, seed: int = 7, positions: int = 4,
                      replicas: int = 4, shards: int = ROLLOUT_SHARDS,
                      pieces: int = 128, piece_size: int = 1 << 20,
                      parallelism: int = 4, sharded: bool = True,
                      kill_owner: bool = False,
                      partner_exemption: bool = True) -> dict:
    """One rollout fan-out: time-to-ready-arrays makespan, per-shard
    percentiles and per-tier bytes. ``shards`` must divide by
    ``positions`` and ``pieces`` by ``shards``. ``partner_exemption=False``
    rules with the reference's filter (``_ReferenceFilter``)."""
    if shards % positions or pieces % shards:
        raise ValueError("need positions | shards | pieces divisibility")
    rng = random.Random(seed)

    content = pieces * piece_size
    shard_size = content // shards
    manifest = [ShardInfo(name=f"s{i:03d}", range_start=i * shard_size,
                          range_size=shard_size) for i in range(shards)]
    by_name = {s.name: s for s in manifest}
    per_pos = shards // positions
    requested_of_pos = {
        p: [f"s{i:03d}" for i in range(p * per_pos, (p + 1) * per_pos)]
        for p in range(positions)}

    res = Resource()
    task = Task("roll" + "0" * 60, "bench://rollout")
    task.set_content_info(content, piece_size, pieces)
    affinity = ShardAffinity() if sharded else None
    sched = (Scheduling if partner_exemption else _ReferenceFilter)(
        make_evaluator("default"), rng=random.Random(seed),
        sharded=affinity, relay_fanout=RELAY_FANOUT)

    # dedicated seed outside the pod (DCN link): the tree's root
    seed_host = res.store_host(HostMsg(
        id="rollseed-host", ip="10.0.0.1", port=1, download_port=2,
        type=HostType.SUPER_SEED, topology=_topo("slice-seed", 9, 9)))
    seed_peer = res.get_or_create_peer("rollseed-peer", task, seed_host)
    seed_peer.transit(PeerState.RUNNING)
    seed_peer.finished_pieces = set(range(pieces))
    seed_peer.transit(PeerState.SUCCEEDED)

    leechers: list[_Leecher] = []
    pos_of: dict[str, int] = {}
    for p in range(positions):
        for r in range(replicas):
            idx = p * replicas + r
            host = res.store_host(HostMsg(
                id=f"p{p}r{r}-host", ip="10.0.0.1", port=1,
                download_port=2, topology=_topo("roll-pod", idx % 8,
                                                idx // 8)))
            peer = Peer(f"p{p}r{r}-peer", task, host)
            joined = (idx * COLD_JOIN_MS / max(positions * replicas, 1)) \
                * rng.uniform(0.8, 1.2)
            lc = _Leecher(peer, None, joined)
            pos_of[peer.id] = p
            leechers.append(lc)

    by_peer_id = {lc.peer.id: lc for lc in leechers}
    # the fleet is known up front: every request registers before the
    # first assignment is read (two passes; the second sees the whole
    # membership, so the split is disjoint per group from t=0)
    requested: dict[str, list[str]] = {}
    needed: dict[str, set[int]] = {}
    tree_nums: dict[str, set[int]] = {}
    trackers: dict[str, ShardTracker] = {}
    if sharded:
        for _pass in range(2):
            for lc in leechers:
                p = pos_of[lc.peer.id]
                names = requested_of_pos[p]
                assigned = affinity.assign(
                    task_id=task.id, peer_id=lc.peer.id,
                    host_id=lc.peer.host.id,
                    topology=lc.peer.host.msg.topology, requested=names)
                requested[lc.peer.id] = names
                mine = [by_name[n] for n in assigned]
                tree_nums[lc.peer.id] = pieces_for_shards(
                    mine, piece_size, pieces)
    else:
        for lc in leechers:
            requested[lc.peer.id] = [s.name for s in manifest]
            tree_nums[lc.peer.id] = set(range(pieces))
    for lc in leechers:
        names = requested[lc.peer.id]
        trackers[lc.peer.id] = ShardTracker(manifest, names)
        needed[lc.peer.id] = pieces_for_shards(
            [by_name[n] for n in names], piece_size, pieces)

    active: dict[str, int] = {}
    served_children: dict[str, set[str]] = {}
    dead: set[str] = set()
    dcn_bytes = ici_bytes = 0
    tree_bytes_by_peer: dict[str, int] = {}
    fallback_pieces = 0
    shard_ready_ms: list[float] = []     # every (host, shard) ready time
    victim: _Leecher | None = None
    kill_ms: float | None = None

    def refresh_parents(lc: _Leecher, now: float = 0.0) -> None:
        parents = sched.find_parents(lc.peer)
        lc.parents = parents
        lc.peer.last_offer_ids = {p.id for p in parents}
        task.set_parents(lc.peer.id, [p.id for p in parents])

    def landed_now(src: _Leecher, piece: int, now: float) -> bool:
        t = src.landed_at.get(piece)
        return t is not None and t <= now

    def holds(parent, piece: int, now: float) -> bool:
        if parent is seed_peer:
            return True
        src = by_peer_id.get(parent.id)
        if src is None or parent.id in dead:
            return False
        # cut-through: an in-flight piece is pullable
        return landed_now(src, piece, now) or piece in src.arrive

    def swap_holders(lc: _Leecher, piece: int, now: float) -> list:
        """Same-pod holders of a swap-class piece: the position group's
        living replicas."""
        out = []
        for other in leechers:
            if other is lc or other.peer.id in dead:
                continue
            if pos_of[other.peer.id] != pos_of[lc.peer.id]:
                continue
            if landed_now(other, piece, now) or piece in other.arrive:
                out.append(other.peer)
        return out

    def pick(lc: _Leecher, now: float):
        """(piece, parent, is_fallback) or None while starved. Tree-class
        pieces ride the scheduler's offer (the cold-relay rank); swap
        pieces ride the group's replicas, falling back to the tree only
        after the swap hold."""
        mine_tree = tree_nums[lc.peer.id]
        for piece in sorted(needed[lc.peer.id]):
            if piece in lc.done or piece in lc.inflight:
                continue
            if piece in mine_tree:
                holders = [p for p in lc.parents
                           if p.id not in dead and holds(p, piece, now)]
                if not holders:
                    continue
                lt = {p.id: link_type(lc.peer.host.msg.topology,
                                      p.host.msg.topology) for p in holders}

                def capped(p) -> int:
                    kids = served_children.get(p.id)
                    if kids is None or lc.peer.id in kids:
                        return 0
                    return 1 if len(kids) >= RELAY_FANOUT else 0

                def avail_ms(p) -> float:
                    src = by_peer_id.get(p.id)
                    if src is None or landed_now(src, piece, now):
                        return 0.0
                    up = src.arrive.get(piece)
                    return up[1] if up is not None else 1e12
                holders.sort(key=lambda p: (
                    capped(p), avail_ms(p), active.get(p.id, 0),
                    int(lt[p.id]), p.id))
                return piece, holders[0], False
            mates = swap_holders(lc, piece, now)
            if mates:
                mates.sort(key=lambda p: (active.get(p.id, 0), p.id))
                return piece, mates[0], False
            if now - lc.joined_ms >= ROLLOUT_SWAP_HOLD_MS:
                # swap hold expired with no living holder: tree fallback
                return piece, seed_peer, True
        return None

    events: list[tuple] = []
    seq = 0

    def push(t: float, *payload) -> None:
        nonlocal seq
        heapq.heappush(events, (t, seq, *payload))
        seq += 1

    for i, lc in enumerate(leechers):
        for _ in range(parallelism):
            push(lc.joined_ms, "worker", i)

    if kill_owner:
        if not sharded:
            raise ValueError("kill_owner needs sharded=True")
        # the first host with a non-empty tree share, killed once half of
        # it has landed
        victim = next(lc for lc in leechers if tree_nums[lc.peer.id])

    SAFETY_MS = 600_000.0
    finished = 0
    while events:
        alive_n = len(leechers) - len(dead)
        if finished >= alive_n:
            break
        now, _s, kind, i, *rest = heapq.heappop(events)
        if now > SAFETY_MS:
            break
        lc = leechers[i]
        if lc.peer.id in dead:
            continue
        tracker = trackers[lc.peer.id]
        if kind == "land":
            piece, parent_id, t_wire = rest
            lc.inflight.discard(piece)
            if parent_id in dead:
                lc.arrive.pop(piece, None)
                push(now, "worker", i)
                continue
            lc.done.add(piece)
            lc.landed_at[piece] = t_wire
            lc.peer.finished_pieces.add(piece)
            active[parent_id] = max(0, active.get(parent_id, 0) - 1)
            lc.since_refresh += 1
            # the tracker turns this landing into per-shard readiness, as
            # the conductor does
            for _name in tracker.on_span(piece * piece_size,
                                         piece * piece_size + piece_size,
                                         t_wire):
                shard_ready_ms.append(t_wire)
            if (victim is not None and kill_ms is None and lc is victim
                    and len(lc.done & tree_nums[lc.peer.id])
                    >= max(1, len(tree_nums[lc.peer.id]) // 2)):
                kill_ms = now
                dead.add(lc.peer.id)
                lc.peer.stream_gone = True
                task.set_parents(lc.peer.id, [])
                affinity.forget_host(lc.peer.host.id)
                continue
            if len(tracker.ready) >= tracker.total:
                lc.done_ms = max(lc.done_ms, t_wire)
                lc.peer.transit(PeerState.SUCCEEDED)
                task.set_parents(lc.peer.id, [])
                lc.peer.last_offer_ids = set()
                lc.parents = []
                finished += 1
            elif lc.since_refresh >= REFRESH_EVERY:
                lc.since_refresh = 0
                refresh_parents(lc, now)
            continue
        # worker event
        if len(tracker.ready) >= tracker.total:
            continue
        if len(lc.done) + len(lc.inflight) >= len(needed[lc.peer.id]):
            continue
        if lc.peer.id not in task.peers:
            task.add_peer(lc.peer)
            lc.peer.transit(PeerState.RUNNING)
            refresh_parents(lc)
        if not lc.parents:
            refresh_parents(lc, now)
        got = pick(lc, now)
        if got is None:
            if now - lc.last_refresh >= COLD_REFRESH_MS:
                lc.last_refresh = now
                refresh_parents(lc, now)
            push(now + POLL_MS, "worker", i)
            continue
        piece, parent, is_fallback = got
        lc.inflight.add(piece)
        if is_fallback:
            fallback_pieces += 1
        lc.schedule.append([piece, parent.id])
        served_children.setdefault(parent.id, set()).add(lc.peer.id)
        lt = link_type(lc.peer.host.msg.topology, parent.host.msg.topology)
        if parent is seed_peer:
            dcn_bytes += piece_size
            tree_bytes_by_peer[lc.peer.id] = \
                tree_bytes_by_peer.get(lc.peer.id, 0) + piece_size
        else:
            ici_bytes += piece_size
        load = active.get(parent.id, 0)
        active[parent.id] = load + 1
        queue_ms = rng.uniform(0.1, 0.5)
        ttfb_ms = (LINK_RTT_MS[lt] * (1.0 + TTFB_QUEUE_FACTOR * load)
                   * rng.uniform(0.9, 1.3))
        wire_ms = (piece_size / LINK_BW_BPS[lt] * 1000.0
                   * (1.0 + WIRE_SHARE_FACTOR * load) * rng.uniform(0.9, 1.25))
        t_first = now + queue_ms + ttfb_ms
        t_wire = t_first + wire_ms
        src = by_peer_id.get(parent.id)
        if src is not None and not landed_now(src, piece, now):
            up = src.arrive.get(piece)
            if up is not None:
                hop = LINK_RTT_MS[lt]
                t_first = max(t_first, up[0] + hop)
                t_wire = max(t_first + wire_ms, up[1] + hop)
                lc.relay_pulls += 1
        lc.arrive[piece] = (t_first, t_wire)
        push(t_wire, "land", i, piece, parent.id, t_wire)
        push(t_wire, "worker", i)

    alive = [lc for lc in leechers if lc.peer.id not in dead]
    complete = sum(1 for lc in alive
                   if len(trackers[lc.peer.id].ready)
                   >= trackers[lc.peer.id].total)
    makespan = max((lc.done_ms for lc in alive), default=0.0)
    ready_sorted = sorted(shard_ready_ms)
    schedules = {lc.peer.id: lc.schedule for lc in leechers}
    digest = hashlib.sha256(
        json.dumps(schedules, sort_keys=True).encode()).hexdigest()
    hosts = positions * replicas
    tree_vals = [tree_bytes_by_peer.get(lc.peer.id, 0) for lc in alive]
    result = {
        "seed": seed,
        "sharded": sharded,
        "positions": positions,
        "replicas": replicas,
        "daemons": hosts,
        "shards": shards,
        "pieces": pieces,
        "piece_size": piece_size,
        "content_bytes": content,
        "requested_bytes_per_host": (content // positions if sharded
                                     else content),
        "makespan_ms": round(makespan, 3),
        "complete": complete,
        "alive": len(alive),
        "shard_ready_ms": {"p50": _pctl(ready_sorted, 0.50),
                           "p99": _pctl(ready_sorted, 0.99)},
        "shards_ready": len(ready_sorted),
        # tree (seed uplink, DCN) against in-pod swap (ICI) bytes
        "dcn_bytes": dcn_bytes,
        "ici_bytes": ici_bytes,
        "tree_copies": round(dcn_bytes / content, 3),
        "tree_bytes_per_host_mean": (round(sum(tree_vals)
                                           / max(len(tree_vals), 1)))
        if tree_vals else 0,
        "swap_fallback_pieces": fallback_pieces,
        "relay_pulled_pieces": sum(lc.relay_pulls for lc in leechers),
        "schedule_digest": digest,
    }
    if kill_owner:
        result["kill"] = {
            "killed_host": victim.peer.host.id,
            "kill_ms": round(kill_ms, 3) if kill_ms is not None else None,
            "completed": complete == len(alive),
            "fallback_pieces": fallback_pieces,
            # bounded by the dead owner's share over its replicas
            "fallback_bounded": (fallback_pieces * piece_size
                                 <= content // positions * replicas),
        }
    return result


def _run_pr14(args, *, partner_exemption: bool = True) -> dict:
    """The sharded rollout across fleet sizes, naive against sharded, and
    a kill-the-owner run, with a plain baseline sim as the digest gate.
    Acceptance: sharded beats naive 2x at 64 hosts, its makespan shrinks
    as the fleet grows while naive's does not, and the tree carries about
    one content copy. ``partner_exemption=False`` rules every run with the
    reference's filter, which gives the reference's ``rollout_digest``."""
    base = run_bench(**_bench_kw(args))
    if args.smoke:
        sizes = [(2, 2), (4, 4)]
        shards, pieces, psize = 8, 16, 64 << 10
    else:
        sizes = [(4, 4), (8, 8), (16, 16)]
        shards, pieces, psize = ROLLOUT_SHARDS, 128, 1 << 20
    scenarios: dict[str, dict] = {sc: {} for sc in ROLLOUT_SCENARIOS}
    for positions, replicas in sizes:
        for sc, arm in (("roll_naive", False), ("roll_sharded", True)):
            r = run_rollout_bench(
                seed=args.seed, positions=positions, replicas=replicas,
                shards=shards, pieces=pieces, piece_size=psize,
                parallelism=args.parallelism, sharded=arm,
                partner_exemption=partner_exemption)
            scenarios[sc][f"{positions}x{replicas}"] = r
    chaos = run_rollout_bench(
        seed=args.seed, positions=sizes[0][0], replicas=sizes[0][1],
        shards=shards, pieces=pieces, piece_size=psize,
        parallelism=args.parallelism, sharded=True, kill_owner=True,
        partner_exemption=partner_exemption)
    keys = [f"{p}x{r}" for p, r in sizes]
    # the acceptance size is 8x8 (64 hosts); smoke labels its own
    mid = "8x8" if "8x8" in keys else keys[min(1, len(keys) - 1)]
    naive, shrd = scenarios["roll_naive"], scenarios["roll_sharded"]
    speedup_mid = round(naive[mid]["makespan_ms"]
                        / max(shrd[mid]["makespan_ms"], 1e-9), 3)
    rollout_digest = hashlib.sha256(json.dumps(
        {sc: {k: v["schedule_digest"] for k, v in scenarios[sc].items()}
         for sc in ROLLOUT_SCENARIOS} | {"chaos": chaos["schedule_digest"]},
        sort_keys=True).encode()).hexdigest()
    content = shrd[keys[0]]["content_bytes"]
    return {
        "bench": "dfbench-sharded",
        "seed": args.seed,
        "sizes": keys,
        "shards": shards,
        "pieces": pieces,
        "piece_size": psize,
        "parallelism": args.parallelism,
        "schedule_digest": base["schedule_digest"],
        "scenarios": scenarios,
        "makespan_ms": {sc: {k: v["makespan_ms"]
                             for k, v in scenarios[sc].items()}
                        for sc in ROLLOUT_SCENARIOS},
        "shard_ready_p99_ms": {sc: {k: v["shard_ready_ms"]["p99"]
                                    for k, v in scenarios[sc].items()}
                               for sc in ROLLOUT_SCENARIOS},
        "speedup": speedup_mid,
        "speedup_size": mid,
        "sharded_beats_naive_2x": speedup_mid >= 2.0,
        "sharded_tracks_shard_bytes": (
            shrd[keys[-1]]["makespan_ms"] < shrd[keys[0]]["makespan_ms"]),
        "naive_tracks_content_bytes": (
            naive[keys[-1]]["makespan_ms"]
            >= 0.8 * naive[keys[0]]["makespan_ms"]),
        "tree_bounded": all(
            shrd[k]["dcn_bytes"] <= 1.5 * content for k in keys),
        "tree_bytes_per_host_mean": {k: shrd[k]["tree_bytes_per_host_mean"]
                                     for k in keys},
        "dcn_bytes": {sc: {k: v["dcn_bytes"]
                           for k, v in scenarios[sc].items()}
                      for sc in ROLLOUT_SCENARIOS},
        "kill": chaos["kill"] | {
            "makespan_ms": chaos["makespan_ms"],
        },
        "rollout_digest": rollout_digest,
    }


def _run_pr4(args) -> dict:
    """One seed, three scenarios: the P2P-served ratio with and without
    PEX while the control plane is down. Scenario blobs drop the raw
    schedules (the digest stays)."""
    scenarios = {}
    for sc in SCENARIOS:
        r = run_bench(scenario=sc, **_bench_kw(args))
        del r["schedules"]
        scenarios[sc] = r
    return {
        "bench": "dfbench-pex",
        "seed": args.seed,
        "scenarios": scenarios,
        "p2p_served_ratio": {sc: scenarios[sc]["p2p_served_ratio"]
                             for sc in SCENARIOS},
        "wall_ms": {sc: scenarios[sc]["wall_ms"] for sc in SCENARIOS},
    }


# ---------------------------------------------------------- fleet pulse
# Virtual announce streams through the real ``FleetPulse``: stationary
# noise, then a fault injected at ``PULSE_INJECT_AT``. The reference's
# constants; ``pulse_digest`` depends on every one of them.
PULSE_SMOKE_FLEET = 128             # the legs the CPU tests run
PULSE_FLEETS = (1000, 10000)        # the full-size legs
PULSE_INTERVALS = 40                # announce intervals per leg
PULSE_INJECT_AT = 20                # interval the fault injection starts
PULSE_FAULTY = 7                    # daemons driven faulty per fault leg
PULSE_SILENT = 3                    # daemons that go silent (stall leg)
PULSE_ANNOUNCE_MS = 30_000.0        # one announce interval (virtual)
PULSE_MAX_BYTES = 512               # per-announce piggyback budget (gate)
PULSE_INJECTIONS = ("none", "stall", "byzantine")


def run_fleetpulse_bench(*, seed: int = 7, daemons: int = 1000,
                         inject: str = "none") -> dict:
    """Drive ``daemons`` virtual announce streams through the port's
    ``FleetPulse`` on a virtual clock: ``PULSE_INTERVALS`` intervals of
    stationary noise, then, on the fault legs, from ``PULSE_INJECT_AT``:

    * ``stall``: ``PULSE_FAULTY`` daemons spike loop lag and SLO breaches
      and ``PULSE_SILENT`` daemons stop announcing (silent-daemon through
      ``tick()``);
    * ``byzantine``: ``PULSE_FAULTY`` daemons burst corrupt verdicts and
      shunned parents (one self-quarantines), escalate serves off the
      primary rung and shed admissions.

    Reported per leg: per-kind detection latency in announce intervals,
    false positives (a firing on a clean daemon, or anything on the clean
    leg) and a sha256 ``pulse_digest`` over the anomaly rows.
    ``ingest_per_sec`` is this host's wall rate, the one number that is
    not a function of the arguments."""
    interval_s = PULSE_ANNOUNCE_MS / 1000.0
    rng = random.Random(f"{seed}:{daemons}:{inject}")
    now_ref = [0.0]
    rows: list[dict] = []
    fp = FleetPulse(sink=rows.append, clock=lambda: now_ref[0])

    faulty = [f"vd{i:05d}" for i in range(PULSE_FAULTY)] \
        if inject in ("stall", "byzantine") else []
    silent = [f"vd{i:05d}" for i in
              range(PULSE_FAULTY, PULSE_FAULTY + PULSE_SILENT)] \
        if inject == "stall" else []
    injected = set(faulty) | set(silent)

    # per-daemon counters since boot (the daemon/pulse.py shape)
    cum = {f"vd{i:05d}": {"slo": 0, "shed": 0, "corrupt": 0, "shun": 0,
                          "rung": 0, "p2p": 0}
           for i in range(daemons)}

    t0 = time.perf_counter()
    for t in range(PULSE_INTERVALS):
        now_ref[0] += interval_s
        hot = t >= PULSE_INJECT_AT
        for i in range(daemons):
            hid = f"vd{i:05d}"
            if hot and hid in silent:
                continue            # the daemon fell over: no announce
            c = cum[hid]
            # stationary noise under the detector's absolute floors: the
            # clean leg must produce no firing
            c["slo"] += rng.randrange(2)
            c["shed"] += rng.randrange(2)
            c["p2p"] += 4 + rng.randrange(4)
            c["rung"] += rng.randrange(2)
            lag = 4.0 + 8.0 * rng.random()
            quar = False
            if hot and hid in faulty:
                if inject == "stall":
                    lag = 500.0 + 400.0 * rng.random()
                    c["slo"] += 10 + rng.randrange(5)
                else:
                    c["corrupt"] += 5 + rng.randrange(3)
                    c["shun"] += 1
                    c["rung"] += 6 + rng.randrange(3)
                    c["shed"] += 10 + rng.randrange(5)
                    quar = (i == 0 and t >= PULSE_INJECT_AT + 2)
            fp.ingest(hid, {
                "v": 1, "seq": t, "flight_tasks": 1 + i % 3,
                "loop_lag_max_ms": round(lag, 3),
                "slo_breaches": c["slo"],
                "served_rungs": {"p2p": c["p2p"], "seed": c["rung"]},
                "qos_shed": c["shed"],
                "corrupt_verdicts": c["corrupt"],
                "shunned_parents": c["shun"],
                "self_quarantined": quar,
                "qos_state": "shed" if (hot and hid in faulty
                                        and inject == "byzantine")
                             else "normal",
            }, interval_s=interval_s)
        fp.tick()                   # the scheduler's GC cadence
    wall_s = time.perf_counter() - t0

    inject_at_s = PULSE_INJECT_AT * interval_s
    latency: dict[str, float] = {}
    false_positives = 0
    for row in rows:
        kind = row["anomaly"]
        on_injected = row["host_id"] in injected
        if inject == "none" or not on_injected \
                or row["at"] <= inject_at_s:
            false_positives += 1
            continue
        lat = (row["at"] - inject_at_s) / interval_s
        if kind not in latency or lat < latency[kind]:
            latency[kind] = round(lat, 1)
    digest = hashlib.sha256(json.dumps(
        [[r["decision_id"], r["anomaly"], r["host_id"], r["signal"]]
         for r in rows], sort_keys=True).encode()).hexdigest()
    return {
        "daemons": daemons,
        "inject": inject,
        "intervals": PULSE_INTERVALS,
        "announces": fp.ingested,
        "anomalies": len(rows),
        "anomaly_counts": {k: v for k, v in
                           sorted(fp.anomaly_counts.items()) if v},
        "detection_latency_intervals": dict(sorted(latency.items())),
        "false_positives": false_positives,
        "incidents": len(fp.incidents),
        "ingest_per_sec": round(fp.ingested / max(wall_s, 1e-9), 1),
        "pulse_digest": digest,
    }


def _pulse_overhead_bytes() -> int:
    """Encoded bytes a busy pulse adds to one announce: the same
    ``AnnounceHostRequest`` with and without a fully populated digest,
    through the port's msgpack codec. Gated at ``PULSE_MAX_BYTES``."""
    host = HostMsg(id="overhead-probe-host", ip="10.0.0.1", port=65001,
                   download_port=65002,
                   topology=TopologyInfo(slice_name="pod-00",
                                         ici_coords=(15, 15),
                                         zone="bench-zone"))
    pulse = PulseDigest(
        seq=999_999, flight_tasks=64, flight_evicted=4096,
        served_rungs={"p2p": 1_000_000, "seed": 50_000, "cross": 10_000,
                      "origin": 5_000, "relay": 2_500, "swap": 1_250},
        loop_lag_max_ms=1234.567, loop_stalls=999, slo_breaches=100_000,
        corrupt_verdicts=5_000, shunned_parents=64, self_quarantined=True,
        qos_state="brownout", qos_shed=100_000, storage_tasks=4096)
    bare = AnnounceHostRequest(host=host, interval_s=30.0)
    full = AnnounceHostRequest(host=host, interval_s=30.0, pulse=pulse)
    return len(idl_dumps(full)) - len(idl_dumps(bare))


def fleetpulse_legs(args) -> dict:
    """``--pr18`` without its ``fleetpulse_pure`` key: the baseline's
    ``schedule_digest``, the fleet-pulse legs (128 daemons; with 1,000 and
    10,000 unless ``args.smoke``), ``pulse_digest`` over the 128-daemon
    legs, the detection gates and ``bytes_per_announce``."""
    base = run_bench(**_bench_kw(args))
    legs = {}
    fleets = [PULSE_SMOKE_FLEET] + ([] if args.smoke else list(PULSE_FLEETS))
    for n in fleets:
        for inj in PULSE_INJECTIONS:
            legs[f"{inj}_{n}"] = run_fleetpulse_bench(
                seed=args.seed, daemons=n, inject=inj)
    smoke_legs = [legs[f"{inj}_{PULSE_SMOKE_FLEET}"]
                  for inj in PULSE_INJECTIONS]
    pulse_digest = hashlib.sha256("".join(
        leg["pulse_digest"] for leg in smoke_legs).encode()).hexdigest()
    detected = sorted({k for leg in legs.values()
                       for k in leg["anomaly_counts"]})
    # silent-daemon is gap-triggered (2.5 missed intervals by design) and
    # carries its own bound; every push-signal kind must clear 2 intervals
    push_latency: dict[str, float] = {}
    silent_latency = 0.0
    for leg in legs.values():
        for kind, lat in leg["detection_latency_intervals"].items():
            if kind == "silent-daemon":
                silent_latency = max(silent_latency, lat)
            else:
                push_latency[kind] = max(push_latency.get(kind, 0.0), lat)
    overhead = _pulse_overhead_bytes()
    return {
        "bench": "dfbench-fleetpulse",
        "seed": args.seed,
        "fleets": fleets,
        "intervals": PULSE_INTERVALS,
        "inject_at": PULSE_INJECT_AT,
        "schedule_digest": base["schedule_digest"],
        "pulse_digest": pulse_digest,
        "legs": legs,
        "detected_kinds": detected,
        "detection_latency_intervals": dict(sorted(push_latency.items())),
        "silent_detection_intervals": silent_latency,
        "detection_bounded": all(v <= 2.0 for v in push_latency.values()),
        "false_positives": {name: leg["false_positives"]
                            for name, leg in sorted(legs.items())},
        "zero_false_positives": all(leg["false_positives"] == 0
                                    for leg in legs.values()),
        "bytes_per_announce": overhead,
        "pulse_overhead_ok": overhead <= PULSE_MAX_BYTES,
    }


def _run_pr18(args) -> dict:
    """The fleet pulse (``--pr18``): ``fleetpulse_legs`` and
    ``fleetpulse_pure``, the 64-daemon control-plane storm's ruling
    digest with pulses ingested between its rulings equal to the digest
    without them (the observer-purity gate)."""
    out = fleetpulse_legs(args)
    disarmed = run_ctrl_bench(seed=args.seed, daemons=CTRL_SMOKE_FLEET,
                              pieces=CTRL_PIECES, armed=False)
    pulsed = run_ctrl_bench(seed=args.seed, daemons=CTRL_SMOKE_FLEET,
                            pieces=CTRL_PIECES, armed=False, pulse=True)
    out["fleetpulse_pure"] = (disarmed["ruling_digest"]
                              == pulsed["ruling_digest"])
    return out


# Poisoned-swarm harness: one byzantine holder serving corrupt bytes into
# a fan-out, quarantine on vs off, through the real Scheduling filter and
# the real QuarantineRegistry ladder on a virtual clock. The poisoner is a
# complete non-seed holder, the parent the evaluator prefers. Measured:
# pod makespan, wasted corrupt bytes, time-to-quarantine and the corrupt
# verdicts absorbed before the ladder engaged.

BYZ_CORRUPT_PCT = 60         # % of poisoner serves that are corrupt
BYZ_LOCAL_SHUN = 2           # child-local verdict-ledger shun threshold
                             # (daemon/verdicts.py SHUN_THRESHOLD)
BYZ_QUARANTINE_THRESHOLD = 3  # registry threshold (scheduler default)


def run_byzantine_bench(*, seed: int = 7, daemons: int = 8,
                        pieces: int = 32, piece_size: int = 4 << 20,
                        parallelism: int = 4,
                        corrupt_pct: int = BYZ_CORRUPT_PCT,
                        quarantine: bool = True) -> dict:
    """One poisoned fan-out; returns makespan + wasted-byte accounting.

    ``quarantine=True`` models the shipped immune system: each child's
    local verdict ledger shuns the poisoner after ``BYZ_LOCAL_SHUN``
    verified corruptions, and the real ``QuarantineRegistry`` (driven
    through ``Scheduling.filter_candidates`` via the ``quarantined``
    exclusion) removes it pod-wide at the threshold. ``quarantine=False``
    is the fabric without an immune system: corruption is caught piece-by-piece at each
    landing, silently requeued, and the scheduler keeps offering the
    poisoner — every child pays for the same lesson separately, forever.
    Pure function of its arguments (virtual clock, seeded rng)."""
    rng = random.Random(seed)
    now_ref = [0.0]            # virtual ms, read by the registry clock

    res = Resource()
    task = Task("byz" + "0" * 61, "bench://byzantine")
    task.set_content_info(pieces * piece_size, piece_size, pieces)

    quarantine_rows: list[dict] = []
    registry = None
    if quarantine:
        registry = QuarantineRegistry(
            corrupt_threshold=BYZ_QUARANTINE_THRESHOLD,
            halflife_s=1e9,            # no decay inside one short sim
            probation_delay_s=1e9,     # no mid-sim reprieve (chaos e2e
                                       # proves the reprieve half live)
            sink=quarantine_rows.append,
            clock=lambda: now_ref[0] / 1000.0)
    # the filter's pool shuffle draws from its own stream seeded like the
    # sim's (the reference seeds the module rng for it)
    sched = Scheduling(make_evaluator("default"), rng=random.Random(seed),
                       quarantine=registry)

    def topo(slice_name: str, x: int, y: int) -> TopologyInfo:
        return TopologyInfo(slice_name=slice_name, ici_coords=(x, y),
                            zone="bench-zone")

    def mk_host(name: str, slice_name: str, x: int, y: int,
                host_type: HostType = HostType.NORMAL):
        return res.store_host(HostMsg(
            id=f"{name}-host", ip="10.0.0.1", port=1, download_port=2,
            type=host_type, topology=topo(slice_name, x, y)))

    def complete_peer(name: str, host) -> Peer:
        p = res.get_or_create_peer(f"{name}-peer", task, host)
        p.transit(PeerState.RUNNING)
        p.finished_pieces = set(range(pieces))
        p.transit(PeerState.SUCCEEDED)
        return p

    seed_peer = complete_peer(
        "seedh", mk_host("seedh", "slice-seed", 9, 9, HostType.SUPER_SEED))
    # the poisoner: a complete NORMAL holder INSIDE slice 0 — best link
    # class, full coverage, the evaluator's favourite parent
    poisoner = complete_peer("poison", mk_host("poison", "slice-0", 3, 3))

    leechers: list[_Leecher] = []
    local_corrupt: list[dict] = []     # per-leecher {parent_id: verdicts}
    for i in range(daemons):
        s = i % 2
        idx = i // 2
        host = mk_host(f"s{s}w{idx}", f"slice-{s}", idx % 2, idx // 2)
        peer = Peer(f"s{s}w{idx}-peer", task, host)
        joined = i * 10.0 * rng.uniform(0.9, 1.1)
        lc = _Leecher(peer, None, joined)
        leechers.append(lc)
        local_corrupt.append({})

    by_peer_id = {lc.peer.id: lc for lc in leechers}
    active: dict[str, int] = {}
    wasted_bytes = 0
    wasted_transfers = 0
    poison_serves_total = 0
    quarantined_at: float | None = None
    serves_after_quarantine = 0

    def refresh_parents(lc: _Leecher) -> None:
        parents = sched.find_parents(lc.peer)
        lc.parents = parents
        lc.peer.last_offer_ids = {p.id for p in parents}
        task.set_parents(lc.peer.id, [p.id for p in parents])

    def holds(parent, piece: int) -> bool:
        if parent is seed_peer or parent is poisoner:
            return True
        src = by_peer_id.get(parent.id)
        return src is not None and piece in src.done

    def pick(lc: _Leecher, i: int):
        shun = local_corrupt[i]
        for piece in range(pieces):
            if piece in lc.done or piece in lc.inflight:
                continue
            holders = [p for p in lc.parents if holds(p, piece)]
            if quarantine:
                # the child's own verdict ledger: locally-shunned parents
                # are refused a dispatcher slot whatever the offer says
                holders = [p for p in holders
                           if shun.get(p.id, 0) < BYZ_LOCAL_SHUN]
            if not holders:
                continue
            lt = {p.id: link_type(lc.peer.host.msg.topology,
                                  p.host.msg.topology) for p in holders}
            holders.sort(key=lambda p: (active.get(p.id, 0),
                                        int(lt[p.id]), p.id))
            return piece, holders[0]
        return None

    events: list[tuple] = []
    seq = 0

    def push(t: float, *payload) -> None:
        nonlocal seq
        heapq.heappush(events, (t, seq, *payload))
        seq += 1

    for i, lc in enumerate(leechers):
        for _ in range(parallelism):
            push(lc.joined_ms, "worker", i)

    finished = 0
    while events and finished < len(leechers):
        now, _s, kind, i, *rest = heapq.heappop(events)
        now_ref[0] = now
        lc = leechers[i]
        if kind == "land":
            piece, parent_id, corrupted = rest
            lc.inflight.discard(piece)
            active[parent_id] = max(0, active.get(parent_id, 0) - 1)
            if corrupted:
                # caught at the child's landing verification: the piece
                # requeues; the corrupt verdict is the immune signal
                wasted_bytes += piece_size
                wasted_transfers += 1
                lc.schedule.append([piece, parent_id, "corrupt"])
                local_corrupt[i][parent_id] = \
                    local_corrupt[i].get(parent_id, 0) + 1
                if registry is not None:
                    registry.record_corrupt(
                        "poison-host", task_id=task.id,
                        reporter=lc.peer.host.id)
                    refresh_parents(lc)
                    if (quarantined_at is None and registry.state(
                            "poison-host") == QUARANTINED):
                        # stamped HERE, at the verdict that tripped the
                        # ruling — sampling it on a later worker event
                        # lagged time_to_quarantine and let a dispatch in
                        # the gap escape the serves-after counter
                        quarantined_at = now
                push(now, "worker", i)
                continue
            lc.done.add(piece)
            lc.peer.finished_pieces.add(piece)
            lc.schedule.append([piece, parent_id, "ok"])
            if len(lc.done) >= pieces:
                lc.done_ms = now
                lc.peer.transit(PeerState.SUCCEEDED)
                finished += 1
            elif len(lc.done) % REFRESH_EVERY == 0:
                refresh_parents(lc)
            continue
        # worker event
        if len(lc.done) + len(lc.inflight) >= pieces:
            continue
        if lc.peer.id not in task.peers:
            task.add_peer(lc.peer)
            lc.peer.transit(PeerState.RUNNING)
            refresh_parents(lc)
        if not lc.parents:
            refresh_parents(lc)
        got = pick(lc, i)
        if got is None:
            refresh_parents(lc)
            push(now + POLL_MS, "worker", i)
            continue
        piece, parent = got
        lc.inflight.add(piece)
        lt = link_type(lc.peer.host.msg.topology, parent.host.msg.topology)
        load = active.get(parent.id, 0)
        active[parent.id] = load + 1
        ttfb_ms = (LINK_RTT_MS[lt] * (1.0 + TTFB_QUEUE_FACTOR * load)
                   * rng.uniform(0.9, 1.3))
        wire_ms = (piece_size / LINK_BW_BPS[lt] * 1000.0
                   * (1.0 + WIRE_SHARE_FACTOR * load) * rng.uniform(0.9, 1.25))
        corrupted = False
        if parent is poisoner:
            poison_serves_total += 1
            if quarantined_at is not None:
                serves_after_quarantine += 1
            # deterministic per-dispatch draw (seeded rng, dispatch order)
            corrupted = rng.random() * 100.0 < corrupt_pct
        t_done = now + ttfb_ms + wire_ms
        push(t_done, "land", i, piece, parent.id, corrupted)
        push(t_done, "worker", i)
    makespan = max((lc.done_ms for lc in leechers), default=0.0)
    total_bytes = daemons * pieces * piece_size
    schedules = {lc.peer.id: lc.schedule for lc in leechers}
    digest = hashlib.sha256(
        json.dumps(schedules, sort_keys=True).encode()).hexdigest()
    corrupt_verdicts = sum(sum(d.values()) for d in local_corrupt)
    return {
        "seed": seed,
        "daemons": daemons,
        "pieces": pieces,
        "piece_size": piece_size,
        "corrupt_pct": corrupt_pct,
        "quarantine": quarantine,
        "makespan_ms": round(makespan, 3),
        "wasted_corrupt_bytes": wasted_bytes,
        "wasted_transfers": wasted_transfers,
        # corrupt bytes per unit of useful content delivered — the
        # pod-wide tax the poisoner extracts
        "wasted_ratio": round(wasted_bytes / total_bytes, 4),
        "corrupt_verdicts": corrupt_verdicts,
        "poisoner_serves": poison_serves_total,
        "poisoner_serves_after_quarantine": serves_after_quarantine,
        "time_to_quarantine_ms": (round(quarantined_at, 3)
                                  if quarantined_at is not None else None),
        "quarantine_rows": len(quarantine_rows),
        "quarantine_transitions": [
            {"from": r.get("from_state"), "to": r.get("to_state"),
             "why": r.get("why")} for r in quarantine_rows],
        "schedule_digest": digest,
    }


def _run_pr12(args) -> dict:
    """The swarm immune system under a
    byzantine holder, quarantine on vs off. A plain baseline sim rides
    along twice — bare, and with an ARMED-but-evidence-free registry —
    as the digest gates (both give the baseline's digest: the filter
    consults the registry only per-candidate and an empty registry
    answers healthy without touching the rng). Acceptance: quarantine bounds wasted corrupt bytes to a
    small multiple of the evidence threshold while the unprotected pod's
    waste scales with daemons x corrupt_pct; the poisoner is quarantined
    after a bounded number of verdicts and serves ~nothing afterwards;
    makespan improves."""
    base = run_bench(**_bench_kw(args))
    armed = run_bench(**_bench_kw(args), quarantine=QuarantineRegistry())
    shape = dict(seed=args.seed,
                 daemons=4 if args.smoke else 8,
                 pieces=8 if args.smoke else 32,
                 piece_size=(256 << 10) if args.smoke else (4 << 20),
                 parallelism=args.parallelism)
    protected = run_byzantine_bench(**shape, quarantine=True)
    exposed = run_byzantine_bench(**shape, quarantine=False)
    byz_digest = hashlib.sha256(json.dumps(
        {"on": protected, "off": exposed},
        sort_keys=True).encode()).hexdigest()
    return {
        "bench": "dfbench-byzantine",
        "seed": args.seed,
        "daemons": shape["daemons"],
        "pieces": shape["pieces"],
        "piece_size": shape["piece_size"],
        "corrupt_pct": protected["corrupt_pct"],
        # the scheduler sim untouched by the quarantine plumbing: digest
        # gates (bare AND armed-empty-registry runs)
        "schedule_digest": base["schedule_digest"],
        "quarantine_pure": (base["schedule_digest"]
                            == armed["schedule_digest"]),
        "quarantine_on": protected,
        "quarantine_off": exposed,
        "makespan_ms": {"on": protected["makespan_ms"],
                        "off": exposed["makespan_ms"]},
        "wasted_ratio": {"on": protected["wasted_ratio"],
                         "off": exposed["wasted_ratio"]},
        "time_to_quarantine_ms": protected["time_to_quarantine_ms"],
        "verdicts_to_quarantine": BYZ_QUARANTINE_THRESHOLD,
        # the headline: with quarantine, pod-wide wasted corrupt bytes
        # stay bounded near threshold x piece_size; exposed, every child
        # pays separately and waste scales with daemons x corrupt_pct.
        # (Makespan is reported, not gated: a 60%-corrupt parent still
        # contributes 40% goodput in the link model, so wall-clock is
        # roughly a wash — the tax quarantine removes is wasted BYTES
        # and verdict churn, which at pod scale is shared-uplink load.)
        "quarantine_bounds_waste": (
            protected["wasted_corrupt_bytes"]
            < exposed["wasted_corrupt_bytes"]),
        "byzantine_digest": byz_digest,
    }


# Cross-pod federation harness: many pods behind thin
# DCN links, one origin, whole-fleet cold start — the feeder-limited
# regime of the MLPerf-on-pods papers. ``fed_naive`` is the flat fabric:
# every daemon may back-source and cross-pod parents are unrestricted,
# so the cold herd storms the origin from every pod at once.
# ``fed_hier`` drives the real two-level stack: the real PodFederation
# (hash-ring per-pod seed election) armed inside the real Scheduling
# filter — cross-pod parents are legal only for each pod's elected
# seeds, members never touch the origin, and the in-pod fan-out rides
# the relay shaping with cut-through pipelining, so the chain is
# origin -> pod-seed (DCN) -> ICI relay tree. The seed-kill chaos
# variant kills a pod's elected seed mid-pull: the federation view
# forgets the host, the ring re-elects, and the pod completes with no
# origin copies beyond the replacement's resume of the holes.

FED_SCENARIOS = ("fed_naive", "fed_hier")
FED_PIECES = 32              # pieces per federation run (fixed: the scale
                             # axis is PODS, not content size)


def run_federation_bench(*, seed: int = 7, pods: int = 4,
                         daemons_per_pod: int = 16, pieces: int = FED_PIECES,
                         piece_size: int = 4 << 20, parallelism: int = 4,
                         federation: bool = True,
                         origin_link: LinkType = LinkType.DCN,
                         seed_kill: bool = False,
                         collect_podscope: bool = False) -> dict:
    """One multi-pod cold-start fan-out; returns makespan + per-tier byte
    accounting. Pure function of its arguments (virtual clock, seeded
    rng, deterministic elections). ``federation=False`` models the flat
    pre-federation fabric (anyone may back-source, anyone may cross
    pods); ``federation=True`` arms the real PodFederation inside the
    real Scheduling filter. ``seed_kill`` kills pod-0's elected seed
    once it has landed half the content (a deterministic trigger — no
    wall clock), exercising forget-host -> ring re-election -> resume."""
    rng = random.Random(seed)

    res = Resource()
    task = Task("fed" + "0" * 61, "bench://federation")
    task.set_content_info(pieces * piece_size, piece_size, pieces)

    fed = PodFederation(seeds_per_pod=1) if federation else None
    # the filter's pool shuffle: its own stream, seeded like the sim's
    sched = Scheduling(make_evaluator("default"), rng=random.Random(seed),
                       relay_fanout=RELAY_FANOUT, federation=fed)

    def topo(pod: int, i: int) -> TopologyInfo:
        return TopologyInfo(slice_name=f"pod-{pod}", ici_coords=(i % 8, i // 8),
                            zone="bench-zone")

    leechers: list[_Leecher] = []
    pod_of: dict[str, str] = {}        # peer id -> pod name
    for p in range(pods):
        for i in range(daemons_per_pod):
            t = topo(p, i)
            host = res.store_host(HostMsg(
                id=f"p{p}w{i}-host", ip="10.0.0.1", port=1, download_port=2,
                topology=t))
            peer = Peer(f"p{p}w{i}-peer", task, host)
            if fed is not None:
                fed.observe_host(host.id, t)   # the announce plane
            idx = p * daemons_per_pod + i
            joined = (idx * COLD_JOIN_MS / max(pods * daemons_per_pod, 1)) \
                * rng.uniform(0.8, 1.2)
            flight = None
            if collect_podscope:
                flight = TaskFlight(task.id, peer.id, url="bench://federation",
                                    max_events=5 * pieces + 8)
                flight.events.append((joined, fr.REGISTERED, -1, "", 0, 0.0))
            lc = _Leecher(peer, flight, joined)
            pod_of[peer.id] = f"pod-{p}"
            leechers.append(lc)

    by_peer_id = {lc.peer.id: lc for lc in leechers}
    by_host_id = {lc.peer.host.id: lc for lc in leechers}
    active: dict[str, int] = {}
    served_children: dict[str, set[str]] = {}
    dead: set[str] = set()             # peer ids of killed daemons
    bytes_by_tier = {name: 0 for name in
                     (*LINK_TIER_NAMES.values(), "origin")}
    origin_by_peer: dict[str, int] = {}
    kill_ms: float | None = None
    victim: _Leecher | None = None
    reelected: list[str] = []
    pod0_origin_after_kill = 0

    def is_pod_seed(lc: _Leecher) -> bool:
        if fed is None:
            return True                # flat fabric: anyone back-sources
        return lc.peer.host.id in fed.seeds_for(task.id, pod_of[lc.peer.id])

    def refresh_parents(lc: _Leecher, now: float = 0.0) -> None:
        parents = sched.find_parents(lc.peer)
        lc.parents = parents
        lc.peer.last_offer_ids = {p.id for p in parents}
        task.set_parents(lc.peer.id, [p.id for p in parents])

    def holds(parent, piece: int, now: float) -> bool:
        src = by_peer_id.get(parent.id)
        if src is None or parent.id in dead:
            return False
        t = src.landed_at.get(piece)
        if t is not None and t <= now:
            return True
        # cut-through: an in-flight piece is announce-ahead
        # pullable — including behind a pod seed's ORIGIN stream, which
        # is exactly the origin -> pod-seed -> ICI pipeline
        return piece in src.arrive

    def landed_now(parent, piece: int, now: float) -> bool:
        src = by_peer_id.get(parent.id)
        if src is None or parent.id in dead:
            return False
        t = src.landed_at.get(piece)
        return t is not None and t <= now

    def pick(lc: _Leecher, now: float):
        """(piece, parent_or_None) — None parent = origin back-source,
        legal only for pod seeds under federation. The holder ranking is
        the cold_relay rule: under-fanout-cap first, earliest available
        copy, load, link tier."""
        allowed_origin = None
        for piece in range(pieces):
            if piece in lc.done or piece in lc.inflight:
                continue
            holders = [p for p in lc.parents
                       if p.id not in dead and holds(p, piece, now)]
            if not holders:
                if allowed_origin is None:
                    allowed_origin = is_pod_seed(lc)
                if allowed_origin:
                    return piece, None
                continue
            lt = {p.id: link_type(lc.peer.host.msg.topology,
                                  p.host.msg.topology) for p in holders}

            def capped(p) -> int:
                kids = served_children.get(p.id)
                if kids is None or lc.peer.id in kids:
                    return 0
                return 1 if len(kids) >= RELAY_FANOUT else 0

            def avail_ms(p) -> float:
                if landed_now(p, piece, now):
                    return 0.0
                up = by_peer_id[p.id].arrive.get(piece)
                return up[1] if up is not None else 1e12
            holders.sort(key=lambda p: (
                capped(p), avail_ms(p), active.get(p.id, 0),
                int(lt[p.id]), p.id))
            return piece, holders[0]
        return None

    def kill_seed(now: float) -> None:
        """Pod-0's elected seed dies mid-pull: process gone, storage
        gone, stream gone. The federation view forgets it (the live
        scheduler does this on leave/stream-gone), so the next ruling
        that needs pod-0's seed re-elects the next ring member."""
        nonlocal kill_ms
        kill_ms = now
        dead.add(victim.peer.id)
        victim.peer.stream_gone = True
        task.set_parents(victim.peer.id, [])
        fed.forget_host(victim.peer.host.id)
        if victim.flight is not None:
            victim.flight.state = "failed"

    events: list[tuple] = []
    seq = 0

    def push(t: float, *payload) -> None:
        nonlocal seq
        heapq.heappush(events, (t, seq, *payload))
        seq += 1

    for i, lc in enumerate(leechers):
        for _ in range(parallelism):
            push(lc.joined_ms, "worker", i)

    if seed_kill:
        if fed is None:
            raise ValueError("seed_kill needs federation=True")
        # election is deterministic, so the victim is known up front;
        # register pod-0 hosts are observed already
        vic_host = fed.seeds_for(task.id, "pod-0")[0]
        victim = by_host_id[vic_host]

    SAFETY_MS = 600_000.0
    finished = 0
    while events:
        alive = len(leechers) - len(dead)
        if finished >= alive:
            break
        now, _s, kind, i, *rest = heapq.heappop(events)
        if now > SAFETY_MS:
            break
        lc = leechers[i]
        if lc.peer.id in dead:
            continue                   # a dead daemon's events are void
        if kind == "land":
            piece, parent_id, t_wire = rest
            lc.inflight.discard(piece)
            if parent_id in dead:
                # the parent died mid-stream: the transfer aborted, the
                # piece deadline re-pulls it from another holder
                lc.arrive.pop(piece, None)
                push(now, "worker", i)
                continue
            lc.done.add(piece)
            lc.landed_at[piece] = t_wire
            lc.peer.finished_pieces.add(piece)
            active[parent_id] = max(0, active.get(parent_id, 0) - 1)
            lc.since_refresh += 1
            if (victim is not None and kill_ms is None and lc is victim
                    and len(lc.done) >= pieces // 2):
                kill_seed(now)
                continue
            if len(lc.done) >= pieces:
                if lc.flight is not None:
                    lc.flight.state = "success"
                lc.peer.transit(PeerState.SUCCEEDED)
                # a completed peer needs no parents: clearing its
                # in-edges (the live scheduler does this when the
                # conductor closes) releases the cycle filter so EARLY
                # joiners — ancestors of half the DAG — can finally be
                # offered the finished holders below them
                task.set_parents(lc.peer.id, [])
                lc.peer.last_offer_ids = set()
                lc.parents = []
                finished += 1
            elif lc.since_refresh >= REFRESH_EVERY:
                lc.since_refresh = 0
                refresh_parents(lc, now)
            continue
        # worker event
        if len(lc.done) + len(lc.inflight) >= pieces:
            continue
        if lc.peer.id not in task.peers:
            task.add_peer(lc.peer)
            lc.peer.transit(PeerState.RUNNING)
            refresh_parents(lc)
        if not lc.parents:
            refresh_parents(lc, now)
        got = pick(lc, now)
        if got is None:
            if now - lc.last_refresh >= COLD_REFRESH_MS:
                lc.last_refresh = now
                refresh_parents(lc, now)
            push(now + POLL_MS, "worker", i)
            continue
        piece, parent = got
        lc.inflight.add(piece)
        if parent is None:
            # origin back-source over the origin tier (one contended
            # egress for the whole fleet — the resource federation
            # exists to ration)
            lc.schedule.append([piece, _ORIGIN_ID])
            load = active.get(_ORIGIN_ID, 0)
            active[_ORIGIN_ID] = load + 1
            ttfb_ms = (LINK_RTT_MS[origin_link]
                       * (1.0 + TTFB_QUEUE_FACTOR * load)
                       * rng.uniform(0.9, 1.3))
            wire_ms = (piece_size / LINK_BW_BPS[origin_link] * 1000.0
                       * (1.0 + WIRE_SHARE_FACTOR * load)
                       * rng.uniform(0.9, 1.25))
            t_first = now + ttfb_ms
            t_wire = t_first + wire_ms
            lc.arrive[piece] = (t_first, t_wire)
            bytes_by_tier["origin"] += piece_size
            origin_by_peer[lc.peer.id] = \
                origin_by_peer.get(lc.peer.id, 0) + piece_size
            if kill_ms is not None and pod_of[lc.peer.id] == "pod-0":
                # the replacement seed's resume: the only origin traffic
                # the failover is allowed to add
                pod0_origin_after_kill += piece_size
            lc.done_ms = max(lc.done_ms, t_wire)
            if lc.flight is not None:
                lc.flight.events.append((t_wire, fr.WIRE_DONE, piece, "",
                                         piece_size, wire_ms))
            push(t_wire, "land", i, piece, _ORIGIN_ID, t_wire)
            push(t_wire, "worker", i)
            continue
        lc.schedule.append([piece, parent.id])
        served_children.setdefault(parent.id, set()).add(lc.peer.id)
        lt = link_type(lc.peer.host.msg.topology, parent.host.msg.topology)
        bytes_by_tier[LINK_TIER_NAMES[lt]] += piece_size
        load = active.get(parent.id, 0)
        active[parent.id] = load + 1
        queue_ms = rng.uniform(0.1, 0.5)
        ttfb_ms = (LINK_RTT_MS[lt] * (1.0 + TTFB_QUEUE_FACTOR * load)
                   * rng.uniform(0.9, 1.3))
        wire_ms = (piece_size / LINK_BW_BPS[lt] * 1000.0
                   * (1.0 + WIRE_SHARE_FACTOR * load) * rng.uniform(0.9, 1.25))
        t_disp = now + queue_ms
        t_first = t_disp + ttfb_ms
        t_wire = t_first + wire_ms
        if not landed_now(parent, piece, now):
            # cut-through hop behind the parent's own landing watermark
            up = by_peer_id[parent.id].arrive.get(piece)
            if up is not None:
                hop = LINK_RTT_MS[lt]
                t_first = max(t_first, up[0] + hop)
                t_wire = max(t_first + wire_ms, up[1] + hop)
                lc.relay_pulls += 1
        lc.arrive[piece] = (t_first, t_wire)
        lc.done_ms = max(lc.done_ms, t_wire)
        if lc.flight is not None:
            ev = lc.flight.events.append
            ev((now, fr.SCHEDULED, piece, parent.id, 0, 0.0))
            ev((t_disp, fr.DISPATCHED, piece, parent.id, 0, 0.0))
            ev((t_first, fr.FIRST_BYTE, piece, parent.id, 0, 0.0))
            ev((t_wire, fr.WIRE_DONE, piece, parent.id, piece_size, wire_ms))
        push(t_wire, "land", i, piece, parent.id, t_wire)
        push(t_wire, "worker", i)

    alive = [lc for lc in leechers if lc.peer.id not in dead]
    makespan = max((lc.done_ms for lc in alive), default=0.0)
    content = pieces * piece_size
    schedules = {lc.peer.id: lc.schedule for lc in leechers}
    digest = hashlib.sha256(
        json.dumps(schedules, sort_keys=True).encode()).hexdigest()
    seed_hosts = set()
    if fed is not None:
        for p in range(pods):
            seed_hosts |= set(fed.seeds_for(task.id, f"pod-{p}"))
    member_origin = sum(
        n for pid, n in origin_by_peer.items()
        if fed is not None
        and by_peer_id[pid].peer.host.id not in seed_hosts
        and (victim is None or pid != victim.peer.id))
    result = {
        "seed": seed,
        "federation": federation,
        "pods": pods,
        "daemons_per_pod": daemons_per_pod,
        "daemons": pods * daemons_per_pod,
        "pieces": pieces,
        "piece_size": piece_size,
        "content_bytes": content,
        "origin_link": LINK_TIER_NAMES[origin_link],
        "makespan_ms": round(makespan, 3),
        "complete": sum(1 for lc in alive if len(lc.done) >= pieces),
        "alive": len(alive),
        "origin_bytes": bytes_by_tier["origin"],
        # the headline ratio: copies of the content that crossed the
        # origin uplink (hier acceptance: <= 1.25 x pods)
        "origin_copies": round(bytes_by_tier["origin"] / content, 3),
        "bytes_by_tier": dict(bytes_by_tier),
        "cross_pod_p2p_bytes": bytes_by_tier["dcn"] + bytes_by_tier["wan"],
        # bytes NON-SEED members pulled from origin: the federation
        # contract is exactly 0 — every member byte arrives over the
        # pod seed's ICI tree. None when federation is off: the flat
        # fabric has no seed/member distinction, and reporting 0 there
        # would read as the contract holding in the very scenario that
        # violates it
        "member_origin_bytes": (member_origin if fed is not None
                                else None),
        "relay_pulled_pieces": sum(lc.relay_pulls for lc in leechers),
        "schedule_digest": digest,
    }
    if seed_kill:
        result["seed_kill"] = {
            "killed_host": victim.peer.host.id,
            "kill_ms": round(kill_ms, 3) if kill_ms is not None else None,
            "reelected": (fed.seeds_for(task.id, "pod-0")
                          if fed is not None else []),
            "completed": all(len(lc.done) >= pieces for lc in alive),
            # resume bound: pod-0's origin bytes after the kill cover at
            # most the holes the dead seed never spread in-pod
            "pod0_origin_bytes_after_kill": pod0_origin_after_kill,
            "resume_bounded": pod0_origin_after_kill <= content,
        }
    if collect_podscope:
        snaps = []
        for lc in leechers:
            dump = lc.flight.timeline()
            dump["started_at"] = 0.0
            dump["summary"] = lc.flight.summarize()
            snaps.append({"addr": lc.peer.id, "pod": pod_of[lc.peer.id],
                          "flights": {task.id: dump}})
        result["podscope_snapshots"] = snaps
    return result


def _run_pr13(args) -> dict:
    """Cross-pod federation over DCN. A plain single-pod baseline sim
    rides along as the digest gate (federation disarmed: the baseline's
    digest); the fakepod
    then scales across pod counts for flat (fed_naive) vs hierarchical
    (fed_hier) distribution, and a seed-kill chaos run proves mid-pull
    failover. Acceptance: hier origin egress
    <= 1.25 x (pods x content) at the largest size, hier makespan growth
    <= 2x while the pod count grows 4x, members never touch the origin,
    and the killed pod re-elects + completes with the replacement's
    resume as the only extra origin traffic."""
    base = run_bench(**_bench_kw(args))
    if args.smoke:
        sizes = [(2, 6), (4, 6)]
        pieces, psize = 8, 256 << 10
    else:
        sizes = [(4, 64), (8, 64), (16, 64)]
        pieces, psize = FED_PIECES, 4 << 20
    scenarios: dict[str, dict] = {sc: {} for sc in FED_SCENARIOS}
    for pods, dpp in sizes:
        for sc, fed_on in (("fed_naive", False), ("fed_hier", True)):
            r = run_federation_bench(
                seed=args.seed, pods=pods, daemons_per_pod=dpp,
                pieces=pieces, piece_size=psize,
                parallelism=args.parallelism, federation=fed_on)
            scenarios[sc][f"{pods}x{dpp}"] = r
    # two-level tree shape at the smallest size, through the real
    # podscope aggregation (pure readout — never in the rng path)
    tree_run = run_federation_bench(
        seed=args.seed, pods=sizes[0][0], daemons_per_pod=sizes[0][1],
        pieces=pieces, piece_size=psize, parallelism=args.parallelism,
        federation=True, collect_podscope=True)
    report = podscope.aggregate(tree_run.pop("podscope_snapshots"))
    task_report = next(iter(report["tasks"].values()))
    chaos = run_federation_bench(
        seed=args.seed, pods=sizes[0][0], daemons_per_pod=sizes[0][1],
        pieces=pieces, piece_size=psize, parallelism=args.parallelism,
        federation=True, seed_kill=True)
    biggest = f"{sizes[-1][0]}x{sizes[-1][1]}"
    smallest = f"{sizes[0][0]}x{sizes[0][1]}"
    hier = scenarios["fed_hier"]
    naive = scenarios["fed_naive"]
    content = hier[biggest]["content_bytes"]
    pod_growth = sizes[-1][0] / sizes[0][0]
    growth = {sc: round(scenarios[sc][biggest]["makespan_ms"]
                        / max(scenarios[sc][smallest]["makespan_ms"], 1e-9),
                        3) for sc in FED_SCENARIOS}
    fed_digest = hashlib.sha256(json.dumps(
        {sc: {k: v["schedule_digest"] for k, v in scenarios[sc].items()}
         for sc in FED_SCENARIOS} | {"chaos": chaos["schedule_digest"]},
        sort_keys=True).encode()).hexdigest()
    return {
        "bench": "dfbench-federation",
        "seed": args.seed,
        "sizes": [f"{p}x{d}" for p, d in sizes],
        "pieces": pieces,
        "piece_size": psize,
        "parallelism": args.parallelism,
        # federation disarmed == the plain scheduler path: the
        # baseline's digest
        "schedule_digest": base["schedule_digest"],
        "scenarios": scenarios,
        "makespan_ms": {sc: {k: v["makespan_ms"]
                             for k, v in scenarios[sc].items()}
                        for sc in FED_SCENARIOS},
        "origin_copies": {sc: {k: v["origin_copies"]
                               for k, v in scenarios[sc].items()}
                          for sc in FED_SCENARIOS},
        "pod_growth_factor": pod_growth,
        "makespan_growth": growth,
        # acceptance flags
        "origin_bounded": (hier[biggest]["origin_bytes"]
                           <= 1.25 * sizes[-1][0] * content),
        "sublinear_in_pods": growth["fed_hier"] <= 2.0,
        "hier_beats_naive": all(
            hier[f"{p}x{d}"]["makespan_ms"]
            < naive[f"{p}x{d}"]["makespan_ms"] for p, d in sizes),
        "member_origin_bytes": hier[biggest]["member_origin_bytes"],
        "tree": {"depth": task_report["depth"],
                 "cross_pod_bytes": task_report["cross_pod_bytes"],
                 "edges": len(task_report["edges"])},
        "seed_kill": chaos["seed_kill"] | {
            "makespan_ms": chaos["makespan_ms"],
            "origin_copies": chaos["origin_copies"],
            "member_origin_bytes": chaos["member_origin_bytes"],
        },
        "federation_digest": fed_digest,
    }


# The control-plane storm's shape, shared by the recovery storm: virtual
# daemons per pod-sized task group, pieces per task, the shard names per
# ruling and the rulings per fleet, the hosts poisoned before the refresh
# storm and the registrants' class mix.
CTRL_FLEETS = (1000, 5000, 10000)   # virtual daemons per full-size point
CTRL_SMOKE_FLEET = 64               # the legs' fleet (pinned)
CTRL_PEERS_PER_POD = 256            # one task per pod-sized group
CTRL_PIECES = 32
CTRL_SHARDS = 16                    # shard names per shard ruling
CTRL_SHARD_RULINGS = 512            # shard rulings per fleet
CTRL_QUARANTINED = 3                # pod-0 hosts poisoned pre-refresh
CTRL_CRITICAL_EVERY = 97            # every Nth register is critical class
CTRL_BULK_EVERY = 3                 # every Nth register is bulk class
RECOV_OUTAGE_MS = 5_000.0           # virtual scheduler downtime (crash
                                    # to restarted-and-serving)
RECOV_ANNOUNCE_MS = 30_000.0        # one announce interval: how long the
                                    # amnesia brain waits to re-learn
                                    # holders from periodic announces
RECOV_FULL_FLEET = 512              # full-mode second recovery point


def run_ctrl_bench(*, seed: int = 7, daemons: int = 1000,
                   pieces: int = 32, piece_size: int = 4 << 20,
                   armed: bool = True, pulse: bool = False) -> dict:
    """A cold register herd and a steady-state refresh storm through the
    real control-plane stack: ``Scheduling`` over ``Resource`` with the
    ``DecisionLedger``, ``PodFederation``, ``QuarantineRegistry`` and
    ``ShardAffinity`` armed; every ``find``/``refresh``/``preempt``/
    ``shard`` ruling the fleet takes, profiled by ``common/phasetimer.py``
    when ``armed``.

    The storm: ``daemons`` hosts across pod-sized tasks (one task +
    SUPER_SEED seed peer per CTRL_PEERS_PER_POD group) register back to
    back (the cold herd — ``find`` rulings; queue-wait is each
    registrant's real wall delay behind the single brain), a few pod-0
    hosts earn quarantine, then every peer reports progress and
    re-rules (``refresh``), critical children probe ``preempt``, and a
    capped slice takes ``shard`` rulings.

    Determinism: virtual quarantine clock, seeded rng, sha256 shard
    hashing. ``ruling_digest`` (ordered [kind, peer, chosen] rows, never
    latencies) is a pure function of (seed, daemons, pieces), the same
    armed or disarmed (the profiler-purity gate) and with pulses or
    without. The port's swap-partner exemption (ROADMAP known difference
    13) moves no ruling here: the shard requests come after every find
    and refresh, so no peer has a swap partner while they are ruled."""
    now_ref = [0.0]            # virtual ms, read by the registry clock

    res = Resource()
    registry = QuarantineRegistry(
        corrupt_threshold=3.0, halflife_s=1e9, probation_delay_s=1e9,
        clock=lambda: now_ref[0] / 1000.0)
    fed = PodFederation(seeds_per_pod=1)
    ledger = DecisionLedger()
    affinity = ShardAffinity(sink=ledger.on_decision)
    # the filter's pool shuffle, seeded as the reference seeds its module
    # rng
    sched = Scheduling(make_evaluator("default"), rng=random.Random(seed),
                       relay_fanout=RELAY_FANOUT, quarantine=registry,
                       federation=fed, sharded=affinity)
    sched.decision_sink = ledger.on_decision

    phasetimer.reset()
    if armed:
        phasetimer.arm()

    # the pulse purity leg: a FleetPulse fed synthetic pulses between
    # rulings mid-storm, with its own Random and its own sink; the gate is
    # that ruling_digest is the same with pulses or without
    pulse_fp = pulse_rng = None
    if pulse:
        pulse_fp = FleetPulse(sink=(lambda row: None), federation=fed,
                              clock=lambda: now_ref[0] / 1000.0)
        pulse_rng = random.Random(f"ctrl-pulse:{seed}:{daemons}")

    pods = max(1, -(-daemons // CTRL_PEERS_PER_POD))

    def topo(pod: int, i: int) -> TopologyInfo:
        return TopologyInfo(slice_name=f"pod-{pod}",
                            ici_coords=(i % 16, (i // 16) % 16),
                            zone="bench-zone")

    tasks: list[Task] = []
    for p in range(pods):
        # registered with the Resource: the state-bytes walk and the
        # per-peer quotient read res.tasks
        task = res.get_or_create_task(f"ctrl{p:03d}".ljust(64, "0"),
                                      f"bench://ctrl/{p}")
        task.set_content_info(pieces * piece_size, piece_size, pieces)
        t = topo(p, 255)
        host = res.store_host(HostMsg(
            id=f"c{p}seed-host", ip="10.0.0.1", port=1, download_port=2,
            type=HostType.SUPER_SEED, topology=t))
        fed.observe_host(host.id, t)
        sp = res.get_or_create_peer(f"c{p}seed-peer", task, host)
        sp.transit(PeerState.RUNNING)
        sp.finished_pieces = set(range(pieces))
        sp.transit(PeerState.SUCCEEDED)
        tasks.append(task)

    hosts = []
    for i in range(daemons):
        p = i // CTRL_PEERS_PER_POD
        t = topo(p, i % CTRL_PEERS_PER_POD)
        host = res.store_host(HostMsg(
            id=f"c{p}w{i % CTRL_PEERS_PER_POD}-host", ip="10.0.0.1",
            port=1, download_port=2, topology=t))
        fed.observe_host(host.id, t)
        hosts.append(host)

    rows: list[list] = []      # [kind, peer_id, chosen ids] -> the digest
    peers = []

    # -- cold register herd: every daemon rules `find` back to back;
    # registrant i's queue wait is its wall delay behind the i-1 rulings
    # before it
    t_storm = time.perf_counter()
    for i, host in enumerate(hosts):
        p = i // CTRL_PEERS_PER_POD
        task = tasks[p]
        peer = res.get_or_create_peer(
            f"c{p}w{i % CTRL_PEERS_PER_POD}-peer", task, host)
        peer.created_at = float(i)     # deterministic preempt-victim order
        if i % CTRL_CRITICAL_EVERY == 0:
            peer.qos_class = "critical"
        elif i % CTRL_BULK_EVERY == 0:
            peer.qos_class = "bulk"
        peers.append(peer)
        if armed:
            phasetimer.note_queue_wait(time.perf_counter() - t_storm)
        parents = sched.find_parents(peer)
        peer.last_offer_ids = {pr.id for pr in parents}
        task.set_parents(peer.id, [pr.id for pr in parents])
        rows.append(["find", peer.id, [pr.id for pr in parents]])
    register_wall_s = time.perf_counter() - t_storm

    # -- a few pod-0 hosts earn pod-wide quarantine (virtual clock), so
    # the refresh storm exercises the `quarantined` exclusion path
    now_ref[0] = 1000.0
    for host in hosts[:CTRL_QUARANTINED]:
        for rep in ("rep-a", "rep-b"):
            for _ in range(2):
                registry.record_corrupt(host.id, task_id=tasks[0].id,
                                        reporter=rep)

    # -- steady state: the fleet reports progress, then re-rules
    for i, peer in enumerate(peers):
        peer.finished_pieces = set(range((i * 7) % pieces))
    t1 = time.perf_counter()
    for peer in peers:
        if pulse_fp is not None:
            # a pulse lands between rulings, as announces do: if ingest
            # touched any ruling input, the digest gate would catch it
            pulse_fp.ingest(peer.host.id, {
                "v": 1, "seq": 1, "flight_tasks": 1,
                "loop_lag_max_ms": 5.0 + pulse_rng.random(),
                "slo_breaches": pulse_rng.randrange(3),
                "served_rungs": {"p2p": pulse_rng.randrange(8)},
                "qos_shed": 0, "corrupt_verdicts": 0,
                "shunned_parents": 0, "self_quarantined": False,
                "qos_state": "normal",
            }, interval_s=PULSE_ANNOUNCE_MS / 1000.0)
        parents = sched.refresh_parents(peer)
        peer.last_offer_ids = {pr.id for pr in parents}
        peer.task.set_parents(peer.id, [pr.id for pr in parents])
        rows.append(["refresh", peer.id, [pr.id for pr in parents]])
    refresh_wall_s = time.perf_counter() - t1

    t2 = time.perf_counter()
    for peer in peers:
        if peer.qos_class != "critical":
            continue
        victim = sched.preempt_for(peer)
        rows.append(["preempt", peer.id,
                     [victim.id] if victim is not None else []])
    requested = [f"layer-{j:02d}" for j in range(CTRL_SHARDS)]
    for peer in peers[:CTRL_SHARD_RULINGS]:
        assigned = sched.shard_assignment(peer, requested)
        rows.append(["shard", peer.id, list(assigned or [])])
    tail_wall_s = time.perf_counter() - t2

    wall_s = register_wall_s + refresh_wall_s + tail_wall_s
    snap = phasetimer.snapshot() if armed else None
    obs = CtrlObservatory(resource=res, ledger=ledger, federation=fed,
                          quarantine=registry, sharded=affinity, ttl_s=0.0)
    state = obs.state_bytes()
    phasetimer.reset()
    digest = hashlib.sha256(
        json.dumps(rows, sort_keys=True).encode()).hexdigest()
    n_rulings = len(rows)
    out = {
        "daemons": daemons,
        "pods": pods,
        "pieces": pieces,
        "armed": armed,
        "rulings": n_rulings,
        "rulings_per_sec": round(n_rulings / max(wall_s, 1e-9), 1),
        "wall_ms": {
            "register_storm": round(register_wall_s * 1000, 3),
            "refresh_storm": round(refresh_wall_s * 1000, 3),
            "preempt_and_shard": round(tail_wall_s * 1000, 3),
            "total": round(wall_s * 1000, 3),
        },
        "state_bytes": state,
        "ruling_digest": digest,
    }
    if snap is not None:
        out["profile"] = {
            "rulings": snap["rulings"],
            "phases": snap["phases"],
            "compute_ms": snap["compute_ms"],
            "unattributed_ms": snap["unattributed_ms"],
            "queue_wait_ms": snap["queue_wait_ms"],
        }
    return out


def _ctrl_overhead_ns() -> dict:
    """ns per ``phase()`` call, disarmed and armed: the disarmed number
    is what every ruling pays for carrying the profiler."""
    phasetimer.reset()
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with phasetimer.phase("filter"):
            pass
    disarmed = (time.perf_counter() - t0) / n * 1e9
    phasetimer.arm()
    n2 = 20_000
    t0 = time.perf_counter()
    for _ in range(n2):
        with phasetimer.phase("filter"):
            pass
    armed = (time.perf_counter() - t0) / n2 * 1e9
    phasetimer.reset()
    return {"disarmed_ns_per_call": round(disarmed, 1),
            "armed_ns_per_call": round(armed, 1)}


def _run_pr16(args) -> dict:
    """The control-plane storm (``--ctrl``). Gates: the baseline sim
    re-run with the profiler armed keeps its ``schedule_digest`` (the
    profiler never perturbs a ruling), and the 64-daemon storm's
    ``ruling_digest`` is the same armed and disarmed; the disarmed
    overhead is measured. The full size adds the 1,000, 5,000 and
    10,000-daemon storms: rulings/s, per-phase p50/p99, queue-wait
    growth and bytes of state per peer at each size."""
    base = run_bench(**_bench_kw(args))
    phasetimer.reset()
    phasetimer.arm()
    prof = run_bench(**_bench_kw(args))
    phasetimer.reset()
    profiler_pure = base["schedule_digest"] == prof["schedule_digest"]

    # the 64-daemon storm always runs, twice: the disarmed twin proves the
    # armed profiler changed no ruling. Pieces are pinned, not scaled by
    # --smoke: the digest is derived from the committed parameters
    ctrl_pieces = CTRL_PIECES
    disarmed64 = run_ctrl_bench(seed=args.seed, daemons=CTRL_SMOKE_FLEET,
                                pieces=ctrl_pieces, armed=False)
    scenarios = {str(CTRL_SMOKE_FLEET): run_ctrl_bench(
        seed=args.seed, daemons=CTRL_SMOKE_FLEET, pieces=ctrl_pieces,
        armed=True)}
    if not args.smoke:
        for n in CTRL_FLEETS:
            scenarios[str(n)] = run_ctrl_bench(
                seed=args.seed, daemons=n, pieces=ctrl_pieces, armed=True)
    ctrl_pure = (disarmed64["ruling_digest"]
                 == scenarios[str(CTRL_SMOKE_FLEET)]["ruling_digest"])
    keys = sorted(scenarios, key=int)
    return {
        "bench": "dfbench-ctrl",
        "seed": args.seed,
        "fleets": [int(k) for k in keys],
        "pieces": ctrl_pieces,
        "schedule_digest": base["schedule_digest"],
        "profiler_pure": profiler_pure,
        "ctrl_profiler_pure": ctrl_pure,
        "ruling_digests": {k: scenarios[k]["ruling_digest"] for k in keys},
        "scenarios": scenarios,
        "rulings_per_sec": {k: scenarios[k]["rulings_per_sec"]
                            for k in keys},
        "phase_p50_ms": {k: {ph: r["p50_ms"] for ph, r in
                             scenarios[k]["profile"]["phases"].items()}
                         for k in keys},
        "phase_p99_ms": {k: {ph: r["p99_ms"] for ph, r in
                             scenarios[k]["profile"]["phases"].items()}
                         for k in keys},
        "state_bytes_per_peer": {k: scenarios[k]["state_bytes"]["per_peer"]
                                 for k in keys},
        "overhead": _ctrl_overhead_ns(),
    }


def run_recovery_bench(*, seed: int = 7, daemons: int = 64,
                       pieces: int = 32, piece_size: int = 4 << 20,
                       durable: bool = True,
                       partner_exemption: bool = True) -> dict:
    """One leg of the crash-resilience storm: a cold herd through
    the real control-plane stack (``Scheduling`` over ``Resource`` with
    ``QuarantineRegistry``/``PodFederation``/``ShardAffinity`` armed),
    the scheduler KILLED at 50 % of the refresh storm, then restarted —
    with the ``scheduler/statestore.py`` snapshot (``durable=True``) or
    with amnesia (Dragonfly2's behavior, which the snapshot exists to
    beat).

    The crash discards every in-memory ruling input. On restart the
    durable brain restores the snapshot (quarantine ladder, shard
    request tables + memos, seed elections) and — because daemons see
    the epoch change — every holder's content is re-announced BEFORE
    the herd's retry storm lands. The amnesia brain learns holders only
    from each daemon's periodic announce, one ``RECOV_ANNOUNCE_MS``
    interval later, so its retry storm back-sources from the origin.

    Measured per leg: time from restart to the first ruling served,
    origin hits in the retry storm (a ruling whose offer names no
    content holder = one origin back-source), re-offers of a host
    quarantined BEFORE the crash, and shard-assignment stickiness
    across the restart. The durable leg also proves the
    ``sched.snapshot.io`` contract mid-run: an injected ENOSPC save
    fails silently while the very next ruling still lands.

    Determinism: virtual quarantine/statestore clocks, seeded rng —
    ``ruling_digest`` (ordered [kind, peer, chosen] rows, never wall
    times) is a pure function of (seed, daemons, pieces, durable).
    ``partner_exemption=False`` rules with the reference's filter (swap
    partners held to the cycle and bad-node rules, ROADMAP known
    difference 13)."""
    # the filter's pool shuffle: one stream across both scheduler
    # lifetimes, as the reference's module rng runs on across its crash
    pool_rng = random.Random(seed)
    sched_cls = Scheduling if partner_exemption else _ReferenceFilter
    now_ref = [0.0]            # virtual ms: quarantine AND statestore

    def vclock() -> float:
        return now_ref[0] / 1000.0

    def build_stack():
        res = Resource()
        registry = QuarantineRegistry(
            corrupt_threshold=3.0, halflife_s=1e9, probation_delay_s=1e9,
            clock=vclock)
        fed = PodFederation(seeds_per_pod=1)
        ledger = DecisionLedger()
        affinity = ShardAffinity(sink=ledger.on_decision)
        sched = sched_cls(make_evaluator("default"), rng=pool_rng,
                          relay_fanout=RELAY_FANOUT, quarantine=registry,
                          federation=fed, sharded=affinity)
        sched.decision_sink = ledger.on_decision
        return res, registry, fed, affinity, sched

    def wire(store, registry, fed, affinity):
        # the same component set scheduler/server.py registers (minus
        # tenants/meta, which have no bench-side analog)
        store.register("quarantine", registry.export_state,
                       registry.restore)
        store.register("federation", fed.export_state, fed.restore)
        store.register("shard_affinity", affinity.export_state,
                       affinity.restore)

    pods = max(1, -(-daemons // CTRL_PEERS_PER_POD))

    def topo(pod: int, i: int) -> TopologyInfo:
        return TopologyInfo(slice_name=f"pod-{pod}",
                            ici_coords=(i % 16, (i // 16) % 16),
                            zone="bench-zone")

    def make_tasks(res):
        out = []
        for p in range(pods):
            task = res.get_or_create_task(f"recv{p:03d}".ljust(64, "0"),
                                          f"bench://recovery/{p}")
            task.set_content_info(pieces * piece_size, piece_size, pieces)
            out.append(task)
        return out

    def add_seed(res, fed, tasks, p):
        t = topo(p, 255)
        host = res.store_host(HostMsg(
            id=f"r{p}seed-host", ip="10.0.0.1", port=1, download_port=2,
            type=HostType.SUPER_SEED, topology=t))
        fed.observe_host(host.id, t)
        sp = res.get_or_create_peer(f"r{p}seed-peer", tasks[p], host)
        sp.transit(PeerState.RUNNING)
        sp.finished_pieces = set(range(pieces))
        sp.transit(PeerState.SUCCEEDED)

    res, registry, fed, affinity, sched = build_stack()
    tasks = make_tasks(res)
    for p in range(pods):
        add_seed(res, fed, tasks, p)

    rows: list[list] = []      # [kind, peer_id, chosen ids] -> the digest
    peers = []

    # -- cold herd: every daemon registers (find rulings)
    for i in range(daemons):
        p = i // CTRL_PEERS_PER_POD
        w = i % CTRL_PEERS_PER_POD
        t = topo(p, w)
        host = res.store_host(HostMsg(
            id=f"r{p}w{w}-host", ip="10.0.0.1", port=1, download_port=2,
            topology=t))
        fed.observe_host(host.id, t)
        peer = res.get_or_create_peer(f"r{p}w{w}-peer", tasks[p], host)
        peer.created_at = float(i)
        peers.append(peer)
        parents = sched.find_parents(peer)
        peer.last_offer_ids = {pr.id for pr in parents}
        tasks[p].set_parents(peer.id, [pr.id for pr in parents])
        rows.append(["find", peer.id, [pr.id for pr in parents]])

    # -- one pod-0 holder goes byzantine: two independent reporters, two
    # hard verdicts each -> pod-wide quarantine
    now_ref[0] = 1000.0
    poisoner_peer_id = peers[0].id
    for rep in ("rep-a", "rep-b"):
        for _ in range(2):
            registry.record_corrupt(peers[0].host.id, task_id=tasks[0].id,
                                    reporter=rep)

    # -- progress: the herd holds partial content; the poisoner holds
    # EVERYTHING, so it is maximally attractive to any brain that
    # forgot why it was quarantined
    for i, peer in enumerate(peers):
        peer.finished_pieces = set(range((i * 7) % pieces))
    peers[0].finished_pieces = set(range(pieces))

    requested = [f"layer-{j:02d}" for j in range(CTRL_SHARDS)]
    shard_n = min(daemons, CTRL_SHARD_RULINGS)
    for peer in peers[:shard_n]:       # membership warm-up pass
        assigned = sched.shard_assignment(peer, requested)
        rows.append(["shard", peer.id, list(assigned or [])])
    pre_shard = {}
    for peer in peers[:shard_n]:       # steady state: full membership
        assigned = sched.shard_assignment(peer, requested)
        rows.append(["shard-steady", peer.id, list(assigned or [])])
        pre_shard[peer.host.id] = list(assigned or [])

    half = daemons // 2
    for peer in peers[:half]:
        parents = sched.refresh_parents(peer)
        peer.last_offer_ids = {pr.id for pr in parents}
        peer.task.set_parents(peer.id, [pr.id for pr in parents])
        rows.append(["refresh", peer.id, [pr.id for pr in parents]])

    # -- durable leg: the snapshot first survives an injected ENOSPC
    # (the sched.snapshot.io contract: a failed snapshot must never
    # block or perturb a ruling — one still lands mid-fault), then
    # persists for real
    tmpdir = ""
    snapshot_fault_survived = None
    try:
        if durable:
            tmpdir = tempfile.mkdtemp(prefix="dfbench-recovery-")
            store = SchedulerStateStore(tmpdir, clock=vclock, wall=vclock)
            wire(store, registry, fed, affinity)
            faultgate.reset()
            faultgate.arm_script("sched.snapshot.io=error:n=1")
            failed_save = store.save(reason="bench")
            probe = sched.refresh_parents(peers[half])
            peers[half].last_offer_ids = {pr.id for pr in probe}
            peers[half].task.set_parents(peers[half].id,
                                         [pr.id for pr in probe])
            rows.append(["refresh-during-fault", peers[half].id,
                         [pr.id for pr in probe]])
            faultgate.reset()
            snapshot_fault_survived = (failed_save is False
                                       and store.save(reason="bench"))

        # crash-time holdings: what each daemon can re-announce later
        holdings = [(i, sorted(peer.finished_pieces))
                    for i, peer in enumerate(peers)]

        # ==== CRASH: the scheduler dies at 50 % of the refresh storm;
        # every in-memory ruling input is gone. Restart after a virtual
        # outage.
        now_ref[0] += RECOV_OUTAGE_MS
        res, registry, fed, affinity, sched = build_stack()
        tasks = make_tasks(res)

        t_restart = time.perf_counter()
        provenance = None
        if durable:
            store2 = SchedulerStateStore(tmpdir, clock=vclock, wall=vclock)
            wire(store2, registry, fed, affinity)
            provenance = store2.restore()
            # epoch change -> every daemon re-announces held content
            # (PEX digest codec) BEFORE the retry storm lands: holders
            # are back immediately — and the restored ladder keeps the
            # poisoner's full copy out of every offer
            for p in range(pods):
                add_seed(res, fed, tasks, p)
            for i, held in holdings:
                if not held:
                    continue
                p = i // CTRL_PEERS_PER_POD
                w = i % CTRL_PEERS_PER_POD
                t = topo(p, w)
                host = res.store_host(HostMsg(
                    id=f"r{p}w{w}-host", ip="10.0.0.1", port=1,
                    download_port=2, topology=t))
                fed.observe_host(host.id, t)
                tw = res.get_or_create_peer(f"r{p}w{w}-peer", tasks[p],
                                            host)
                tw.created_at = float(i)
                tw.finished_pieces = set(held)

        # -- retry storm: the mid-pull herd re-registers IMMEDIATELY (no
        # daemon waits out an announce interval to retry). A ruling
        # whose offer names no content holder is an origin hit: that
        # child back-sources its bytes over the WAN.
        time_to_first_ruling_ms = 0.0
        origin_hits = 0
        poisoner_offers = 0
        post_shard = {}
        peers2 = []
        for i in range(daemons):
            p = i // CTRL_PEERS_PER_POD
            w = i % CTRL_PEERS_PER_POD
            t = topo(p, w)
            host = res.store_host(HostMsg(
                id=f"r{p}w{w}-host", ip="10.0.0.1", port=1,
                download_port=2, topology=t))
            fed.observe_host(host.id, t)
            peer = res.get_or_create_peer(f"r{p}w{w}-peer", tasks[p], host)
            peer.created_at = float(i)
            peers2.append(peer)
            parents = sched.find_parents(peer)
            if i == 0:
                time_to_first_ruling_ms = round(
                    (time.perf_counter() - t_restart) * 1000, 3)
            peer.last_offer_ids = {pr.id for pr in parents}
            tasks[p].set_parents(peer.id, [pr.id for pr in parents])
            rows.append(["recover-find", peer.id,
                         [pr.id for pr in parents]])
            if not any(pr.has_content() for pr in parents):
                origin_hits += 1
            if any(pr.id == poisoner_peer_id for pr in parents):
                poisoner_offers += 1
            if i < shard_n:
                assigned = sched.shard_assignment(peer, requested)
                rows.append(["recover-shard", peer.id,
                             list(assigned or [])])
                post_shard[host.id] = list(assigned or [])

        # -- one announce interval later: the amnesia brain finally
        # re-learns holders from periodic announces — including the
        # poisoner, whose quarantine evidence died with the old process
        now_ref[0] += RECOV_ANNOUNCE_MS
        if not durable:
            for p in range(pods):
                add_seed(res, fed, tasks, p)
            for i, held in holdings:
                peers2[i].finished_pieces = set(held)

        # -- steady state resumes: the whole herd re-rules
        for peer in peers2:
            parents = sched.refresh_parents(peer)
            peer.last_offer_ids = {pr.id for pr in parents}
            peer.task.set_parents(peer.id, [pr.id for pr in parents])
            rows.append(["recover-refresh", peer.id,
                         [pr.id for pr in parents]])
            if any(pr.id == poisoner_peer_id for pr in parents):
                poisoner_offers += 1
    finally:
        faultgate.reset()
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)

    sticky = sum(1 for hid, a in pre_shard.items()
                 if post_shard.get(hid) == a)
    digest = hashlib.sha256(
        json.dumps(rows, sort_keys=True).encode()).hexdigest()
    out = {
        "leg": "durable" if durable else "amnesia",
        "daemons": daemons,
        "pods": pods,
        "pieces": pieces,
        "rulings": len(rows),
        "time_to_first_ruling_ms": time_to_first_ruling_ms,
        "origin_hits_after_restart": origin_hits,
        "poisoner_reoffers": poisoner_offers,
        "shard_stickiness": round(sticky / max(len(pre_shard), 1), 4),
        "ruling_digest": digest,
    }
    if durable:
        out["snapshot_fault_survived"] = bool(snapshot_fault_survived)
        out["provenance"] = provenance
    return out


def _run_pr17(args, *, partner_exemption: bool = True) -> dict:
    """Control-plane crash resilience. Gates: the no-crash baseline sim
    keeps the baseline's ``schedule_digest`` (durability never perturbs
    a ruling),
    the durable leg serves its first post-restart ruling with ZERO
    origin stampede while the amnesia twin back-sources the whole herd,
    a host quarantined before the crash is never re-offered across the
    restart (the amnesia twin re-offers it), shard assignments stay
    >=90 % sticky, and a snapshot that fails mid-run (injected ENOSPC)
    never blocks a ruling. ``recovery_digest`` pins both legs' ruling
    streams. ``partner_exemption=False`` rules every leg with the
    reference's filter."""
    base = run_bench(**_bench_kw(args))
    # legs are PINNED to the fleet-64 x 32-piece shape (not --smoke
    # scaled): the smoke re-derivation must use the exact parameters
    # the committed artifact used
    legs = {
        "durable": run_recovery_bench(
            seed=args.seed, daemons=CTRL_SMOKE_FLEET, pieces=CTRL_PIECES,
            durable=True, partner_exemption=partner_exemption),
        "amnesia": run_recovery_bench(
            seed=args.seed, daemons=CTRL_SMOKE_FLEET, pieces=CTRL_PIECES,
            durable=False, partner_exemption=partner_exemption),
    }
    if not args.smoke:
        for name, durable in (("durable", True), ("amnesia", False)):
            legs[f"{name}_{RECOV_FULL_FLEET}"] = run_recovery_bench(
                seed=args.seed, daemons=RECOV_FULL_FLEET,
                pieces=CTRL_PIECES, durable=durable,
                partner_exemption=partner_exemption)
    d, a = legs["durable"], legs["amnesia"]
    recovery_digest = hashlib.sha256(
        (d["ruling_digest"] + a["ruling_digest"]).encode()).hexdigest()
    return {
        "bench": "dfbench-recovery",
        "seed": args.seed,
        "daemons": CTRL_SMOKE_FLEET,
        "pieces": CTRL_PIECES,
        "schedule_digest": base["schedule_digest"],
        "recovery_digest": recovery_digest,
        "legs": legs,
        "time_to_first_ruling_ms": {
            k: v["time_to_first_ruling_ms"] for k, v in legs.items()},
        "origin_hits_after_restart": {
            k: v["origin_hits_after_restart"] for k, v in legs.items()},
        "poisoner_reoffers": {
            k: v["poisoner_reoffers"] for k, v in legs.items()},
        "shard_stickiness": {
            k: v["shard_stickiness"] for k, v in legs.items()},
        "snapshot_fault_survived": d["snapshot_fault_survived"],
        "origin_amplification_bounded": (
            d["origin_hits_after_restart"] * 10
            <= a["origin_hits_after_restart"]),
        "poisoner_quarantined_across_restart": (
            d["poisoner_reoffers"] == 0 < a["poisoner_reoffers"]),
        "affinity_sticky": d["shard_stickiness"] >= 0.9,
    }


POINTS = {"pr19": _run_pr19, "pr18": _run_pr18, "pr17": _run_pr17,
          "ctrl": _run_pr16, "pr14": _run_pr14, "pr13": _run_pr13,
          "pr12": _run_pr12, "pr11": _run_pr11, "pr10": _run_pr10,
          "pr9": _run_pr9, "pr8": _run_pr8, "pr6": _run_pr6, "pr5": _run_pr5,
          "pr4": _run_pr4}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dfbench", description="deterministic fakepod benchmark")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--daemons", type=int, default=8)
    p.add_argument("--pieces", type=int, default=64)
    p.add_argument("--piece-size", type=int, default=4 << 20)
    p.add_argument("--parallelism", type=int, default=4)
    p.add_argument("--scenario", default="baseline",
                   choices=SCENARIOS + COLD_SCENARIOS,
                   help="discovery model (scheds_down_* = every scheduler "
                   "unreachable, with/without the PEX gossip rung; "
                   "cold_* = whole-pod cold start, store-and-forward vs "
                   "cut-through relay)")
    p.add_argument("--pr4", action="store_true",
                   help="baseline and both schedulers-down scenarios: the "
                   "P2P-served ratio with and without PEX")
    p.add_argument("--pr5", action="store_true",
                   help="replay the baseline schedule through the legacy "
                   "and zero-stall data-plane models, and self-check span "
                   "landing")
    p.add_argument("--pr6", action="store_true",
                   help="podscope's pod numbers per scenario (makespan, "
                   "tree depth, origin amplification, edge bandwidth "
                   "percentiles, the bottleneck edge)")
    p.add_argument("--pr8", action="store_true",
                   help="replay the decision-ledger rows through the "
                   "default, nt and ml evaluators (decision_digest, "
                   "ledger purity)")
    p.add_argument("--pr9", action="store_true",
                   help="cold-start makespan and tree depth against pod "
                   "size (64, 128, 256; 8, 16 with --smoke), pull-only "
                   "against cut-through relay")
    p.add_argument("--pr10", action="store_true",
                   help="content-addressed storage through rolling-restart "
                   "churn and alias pulls against the task-id-keyed "
                   "baseline (churn_digest)")
    p.add_argument("--pr11", action="store_true",
                   help="multi-tenant QoS: a critical pull against a bulk "
                   "herd on one uplink, with and without the class split "
                   "and the admission ladder (qos_digest)")
    p.add_argument("--pr12", action="store_true",
                   help="a byzantine holder in a fan-out, quarantine on vs "
                   "off (byzantine_digest, quarantine_pure)")
    p.add_argument("--pr13", action="store_true",
                   help="cross-pod federation across pod counts, flat vs "
                   "hierarchical, and a pod-seed kill (federation_digest)")
    p.add_argument("--pr14", action="store_true",
                   help="sharded-checkpoint rollout against fleet size, "
                   "naive against shard affinity with in-pod swap, and a "
                   "kill-the-owner run (rollout_digest)")
    p.add_argument("--ctrl", action="store_true",
                   help="the control-plane storm: register, refresh, "
                   "preempt and shard rulings at 64 daemons and (without "
                   "--smoke) 1,000, 5,000 and 10,000, profiled "
                   "(ruling_digests, profiler purity)")
    p.add_argument("--pr17", action="store_true",
                   help="a scheduler crash mid-storm, durable snapshot vs "
                   "amnesia (recovery_digest)")
    p.add_argument("--pr18", action="store_true",
                   help="the fleet pulse: anomaly legs at 128 daemons and "
                   "(without --smoke) 1,000 and 10,000, and the storm's "
                   "rulings with and without pulses (fleetpulse_pure)")
    p.add_argument("--pr19", action="store_true",
                   help="the learned loop: datagen, two seeded MLP fits on "
                   "--device, the learned-vs-heuristic replay and a "
                   "learned leg")
    p.add_argument("--device", default="cuda",
                   help="where --pr19 fits (default cuda: raises without a "
                   "CUDA card; 'cpu' to fit on the CPU)")
    p.add_argument("--out", default="-",
                   help="result path ('-', the default: stdout only)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny run (4 daemons x 8 pieces)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.daemons, args.pieces, args.out = 4, 8, "-"
    point = next((name for name in POINTS if getattr(args, name)), None)
    t0 = time.monotonic()
    if point is not None:
        result = POINTS[point](args)
    else:
        result = run_bench(scenario=args.scenario, **_bench_kw(args))
    wall_s = time.monotonic() - t0
    text = json.dumps(result, indent=2, sort_keys=True)
    if args.out == "-":
        print(text)
        return 0
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(text + "\n")
    digest = result.get("schedule_digest") or \
        result["scenarios"]["baseline"]["schedule_digest"]
    print(f"dfbench: wrote {args.out} (schedule {digest[:12]}, "
          f"{wall_s:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
