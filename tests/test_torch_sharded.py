"""Sharded-checkpoint delivery on the CPU, held against the JAX package.

The same inputs, made from a seed with numpy, go through
``dragonfly2_tpu`` and ``dragonfly2_tpu_torch``:

* Shard math: ``parse_shard_names``, ``validate_manifest``,
  ``pieces_for_shards`` and ``split_affinity`` give equal results
  (``split_affinity`` over seeded member and shard sets); ``ShardTracker``
  reports the same ready names for the same out-of-order, duplicate and
  boundary spans.
* Scheduler: ``ShardAffinity`` gives equal assignments and equal
  ``decision_kind=shard`` ledger rows over one seeded sequence of
  registrations, evictions and pods, and so does the scheduler's
  ``assigned_shards`` on registers that arrive one after another. Two
  port-only rules are pinned beside the reference's behaviour: when a
  register grows a group, the group's earlier members are ruled again
  and the changed ruling is pushed on their report streams, and swap
  partners may feed each other across the DAG's cycle exclusion.
* Daemon: the dispatcher never dispatches an unneeded piece, holds a
  swap-class piece off the seed for ``SWAP_HOLD_S`` and then lets the seed
  serve it, and never races one onto the seed in the endgame; widen is
  refused once ``_finishing`` is set; a subset pull from a counting
  ``file://`` origin reads no byte beyond the covering pieces and lands
  the same pieces in both packages, and a request for another shard
  fetches only the gap; a two-replica affinity pull swaps over P2P, and
  when the holder is killed the partner falls back to the tree, finishes
  with identical bytes and counts the fallback.

The cases of ``tests/test_sharded.py`` that concern the ported modules are
mirrored here; its flight-recorder, ``dfdiag`` and podscope cases are not,
since those surfaces have no counterpart in the port yet. Tolerances are
exact. Every test that starts servers runs under ``asyncio.wait_for``.
"""

import asyncio
import collections
import dataclasses
import threading
import time
import types

import numpy as np
import pytest

import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu import source as ref_source
from dragonfly2_tpu.common import sharding as ref_sharding
from dragonfly2_tpu.common.metrics import REGISTRY as REF_REGISTRY
from dragonfly2_tpu.daemon import config as ref_dconfig
from dragonfly2_tpu.daemon import piece_dispatcher as ref_dispatcher
from dragonfly2_tpu.daemon.conductor import (
    PeerTaskConductor as RefConductor)
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.scheduler import Scheduler as RefScheduler
from dragonfly2_tpu.scheduler import SchedulerConfig as RefSchedulerConfig
from dragonfly2_tpu.scheduler.config import SeedPeerAddr as RefSeedPeerAddr
from dragonfly2_tpu.scheduler.evaluator import (
    make_evaluator as ref_make_evaluator)
from dragonfly2_tpu.scheduler.resource import Resource as RefResource
from dragonfly2_tpu.scheduler.resource import Task as RefTask
from dragonfly2_tpu.scheduler.scheduling import Scheduling as RefScheduling
from dragonfly2_tpu.scheduler.shard_affinity import (
    ShardAffinity as RefShardAffinity)
from dragonfly2_tpu.source.file_client import (
    FileSourceClient as RefFileSourceClient)
from dragonfly2_tpu.storage.manager import StorageConfig as RefStorageConfig
from dragonfly2_tpu.storage.manager import StorageManager as RefStorageManager
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch import source as port_source
from dragonfly2_tpu_torch.common import sharding
from dragonfly2_tpu_torch.common.metrics import REGISTRY
from dragonfly2_tpu_torch.daemon import piece_dispatcher
from dragonfly2_tpu_torch.daemon.conductor import PeerTaskConductor
from dragonfly2_tpu_torch.daemon.config import DaemonConfig, DownloadConfig
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.evaluator import make_evaluator
from dragonfly2_tpu_torch.scheduler.resource import Resource, Task
from dragonfly2_tpu_torch.rpc import Channel, ServiceClient
from dragonfly2_tpu_torch.scheduler.resource import PeerState
from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.scheduler.service import SCHEDULER_SERVICE
from dragonfly2_tpu_torch.scheduler.shard_affinity import ShardAffinity
from dragonfly2_tpu_torch.source.file_client import FileSourceClient
from dragonfly2_tpu_torch.storage.manager import StorageConfig, StorageManager

MiB = 1 << 20
PIECE = 4 * MiB
E2E_LIMIT_S = 60.0

PACKAGES = {"ref": (ref_sharding, ref_msg), "port": (sharding, port_msg)}


def mk(msg, name, start, size, **kw):
    return msg.ShardInfo(name=name, range_start=start, range_size=size, **kw)


def _names(rng, n: int) -> list[str]:
    return [f"model.layers.{int(i)}.w{int(rng.integers(0, 9))}"
            for i in rng.permutation(10 * n)[:n]]


def _seeded_manifest(rng, n: int, total: int) -> list[tuple]:
    """``n`` disjoint (name, start, size) ranges with seeded gaps."""
    cuts = np.sort(rng.choice(np.arange(1, total), 2 * n, replace=False))
    return [(f"t{i}", int(cuts[2 * i]), int(cuts[2 * i + 1] - cuts[2 * i]))
            for i in range(n)]


# ---------------------------------------------------------------- math

@pytest.mark.parametrize("csv", ["a, b ,c,a,", "", " , ,", "x",
                                 "layers.1.w,layers.0.w,layers.1.w"])
def test_parse_shard_names(csv):
    got = sharding.parse_shard_names(csv)
    assert got == ref_sharding.parse_shard_names(csv)
    if csv == "a, b ,c,a,":
        assert got == ["a", "b", "c"]


VALIDATE_CASES = {
    "duplicate": ([("a", 0, 4), ("a", 4, 4)], -1),
    "overlap": ([("a", 0, 8), ("b", 4, 8)], -1),
    "beyond": ([("a", 0, 8)], 4),
    "size": ([("a", 0, 0)], -1),
    "negative-start": ([("a", -1, 4)], -1),
    "empty-name": ([("", 0, 4)], -1),
    "gaps-legal": ([("a", 0, 4), ("b", 100, 4)], 104),
    "unsorted-legal": ([("b", 50, 10), ("a", 0, 50)], 60),
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_manifest(case):
    spans, length = VALIDATE_CASES[case]
    outcome = []
    for shard_mod, msg in PACKAGES.values():
        try:
            shard_mod.validate_manifest([mk(msg, *s) for s in spans],
                                        content_length=length)
            outcome.append(None)
        except ValueError as exc:
            outcome.append(str(exc))
    assert outcome[0] == outcome[1]
    assert (outcome[0] is None) == case.endswith("legal")


def test_pieces_for_shards_boundary_mid_piece():
    for shard_mod, msg in PACKAGES.values():
        # shard b straddles pieces 1 and 2: both claimed
        assert shard_mod.pieces_for_shards([mk(msg, "b", 6, 4)], 4, 4) \
            == {1, 2}
        assert shard_mod.pieces_for_shards([mk(msg, "a", 4, 4)], 4, 4) \
            == {1}
        # tail clamp: a shard past the last piece claims no phantoms
        assert shard_mod.pieces_for_shards([mk(msg, "t", 6, 100)], 4, 3) \
            == {1, 2}
        with pytest.raises(ValueError):
            shard_mod.pieces_for_shards([mk(msg, "a", 0, 4)], 0, 1)


@pytest.mark.parametrize("seed", range(4))
def test_pieces_for_shards_seeded(seed):
    rng = np.random.default_rng(seed)
    total = int(rng.integers(1_000, 100_000))
    spans = _seeded_manifest(rng, int(rng.integers(1, 12)), total)
    piece = int(rng.integers(16, 4096))
    pieces = -(-total // piece)
    subset = [spans[i] for i in
              rng.choice(len(spans), int(rng.integers(1, len(spans) + 1)),
                         replace=False)]
    got = sharding.pieces_for_shards(
        [mk(port_msg, *s) for s in subset], piece, pieces)
    want = ref_sharding.pieces_for_shards(
        [mk(ref_msg, *s) for s in subset], piece, pieces)
    assert got == want and got


@pytest.mark.parametrize("seed", range(6))
def test_split_affinity_seeded(seed):
    rng = np.random.default_rng(seed)
    names = _names(rng, int(rng.integers(1, 40)))
    members = [f"host-{int(i)}-10.0.0.{int(i)}"
               for i in rng.permutation(20)[:int(rng.integers(1, 6))]]
    got = sharding.split_affinity(names, members)
    assert got == ref_sharding.split_affinity(names, members)
    assert set(got) == set(names) and set(got.values()) <= set(members)
    # order-independent, and bounded-load balanced
    assert got == sharding.split_affinity(names[::-1], members[::-1])
    cap = -(-len(names) // len(members))
    assert max(collections.Counter(got.values()).values()) <= cap
    assert sharding.split_affinity(names, []) == {}


def test_split_affinity_two_replicas_exact_halves():
    two = collections.Counter(sharding.split_affinity(
        [f"s{i}" for i in range(6)],
        ["da-127.0.0.1", "db-127.0.0.1"]).values())
    assert set(two.values()) == {3}


# ---------------------------------------------------------------- tracker

TRACKED = [("a", 0, 10), ("b", 10, 6), ("c", 20, 4)]    # gap 16-20


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestShardTracker:
    def _tracker(self, pkg, requested=None):
        shard_mod, msg = PACKAGES[pkg]
        return shard_mod.ShardTracker([mk(msg, *s) for s in TRACKED],
                                      requested)

    def test_out_of_order_and_duplicate_spans(self, pkg):
        tr = self._tracker(pkg)
        assert tr.on_span(5, 10, 1.0) == []      # tail of a first
        assert tr.on_span(5, 10, 1.5) == []      # duplicate: no change
        assert tr.on_span(0, 5, 2.0) == ["a"]    # head completes it
        assert tr.on_span(0, 10, 3.0) == []      # re-landing a ready shard
        assert tr.ready == {"a": 2.0}
        assert tr.pending() == ["b", "c"]

    def test_boundary_span_completes_two_shards(self, pkg):
        tr = self._tracker(pkg)
        assert tr.on_span(0, 8, 1.0) == []
        assert tr.on_span(8, 16, 2.0) == ["a", "b"]

    def test_gap_bytes_never_complete_anything(self, pkg):
        tr = self._tracker(pkg)
        assert tr.on_span(16, 20, 1.0) == []
        assert tr.on_span(20, 24, 2.0) == ["c"]

    def test_requested_subset(self, pkg):
        tr = self._tracker(pkg, ["c", "a"])
        assert tr.total == 2
        assert tr.requested_bytes() == 14
        assert tr.shard_bytes_in(8, 22) == 4     # a's tail + c's head
        assert tr.on_span(0, 24, 1.0) == ["a", "c"]   # b untracked
        assert tr.needed_pieces(4, 6) == {0, 1, 2, 5}
        with pytest.raises(ValueError, match="not in manifest"):
            self._tracker(pkg, ["zz"])


@pytest.mark.parametrize("seed", range(4))
def test_tracker_seeded_spans(seed):
    """Seeded spans (out of order, duplicated, straddling boundaries and
    gaps) into both packages' trackers: the same ready names at every
    step, and the same byte accounting."""
    rng = np.random.default_rng(100 + seed)
    total = 50_000
    spans = _seeded_manifest(rng, 9, total)
    requested = None
    if seed % 2:
        requested = [spans[i][0] for i in
                     sorted(rng.choice(len(spans), 4, replace=False))]
    ours = sharding.ShardTracker([mk(port_msg, *s) for s in spans],
                                 requested)
    theirs = ref_sharding.ShardTracker([mk(ref_msg, *s) for s in spans],
                                       requested)
    piece = 997
    order = list(rng.permutation(-(-total // piece)))
    order += list(rng.choice(order, 5))          # duplicate landings
    for step, p in enumerate(order):
        lo, hi = int(p) * piece, min(total, (int(p) + 1) * piece)
        assert ours.on_span(lo, hi, float(step)) == \
            theirs.on_span(lo, hi, float(step))
        assert ours.shard_bytes_in(lo, hi) == theirs.shard_bytes_in(lo, hi)
    assert ours.ready == theirs.ready
    assert ours.pending() == theirs.pending() == []
    assert ours.requested_bytes() == theirs.requested_bytes()
    assert ours.needed_pieces(piece, len(order)) == \
        theirs.needed_pieces(piece, len(order))


# ---------------------------------------------------------------- affinity

def _affinity_op_sequence(seed: int) -> list[tuple]:
    """A seeded sequence of registrations (host, pod, requested subset),
    host evictions and task drops over two tasks and three pods."""
    rng = np.random.default_rng(seed)
    names = [f"s{i}" for i in range(12)]
    tasks = ["t" + "a" * 63, "t" + "b" * 63]
    ops = []
    for _ in range(40):
        r = rng.random()
        host = f"h{int(rng.integers(0, 6))}-10.0.0.1"
        if r < 0.8:
            k = int(rng.integers(1, len(names) + 1))
            req = [names[i] for i in sorted(
                rng.choice(len(names), k, replace=False))]
            ops.append(("assign", tasks[int(rng.integers(0, 2))], host,
                        ["pod-a", "pod-b", ""][int(rng.integers(0, 3))],
                        req))
        elif r < 0.95:
            ops.append(("forget", host))
        else:
            ops.append(("drop", tasks[int(rng.integers(0, 2))]))
    return ops


def _run_affinity(aff, msg, ops) -> tuple[list, list]:
    rows, out = [], []
    aff.sink = rows.append
    for op in ops:
        if op[0] == "assign":
            _, task, host, pod, req = op
            out.append(aff.assign(
                task_id=task, peer_id=f"{host}-peer-{task[1]}",
                host_id=host, topology=msg.TopologyInfo(pod=pod),
                requested=req))
        elif op[0] == "forget":
            aff.forget_host(op[1])
        else:
            aff.drop_task(op[1])
    return out, rows


@pytest.mark.parametrize("seed", range(4))
def test_shard_affinity_sequence_parity(seed):
    ops = _affinity_op_sequence(seed)
    got, got_rows = _run_affinity(ShardAffinity(), port_msg, ops)
    want, want_rows = _run_affinity(RefShardAffinity(), ref_msg, ops)
    assert got == want
    assert got_rows == want_rows and got_rows
    assert {r["decision_kind"] for r in got_rows} == {"shard"}


def _peer(res, msg, task, name, pod="roll-pod"):
    host = res.store_host(msg.Host(
        id=f"{name}-host", ip="10.0.0.1", port=1, download_port=2,
        topology=msg.TopologyInfo(slice_name=pod, ici_coords=(0, 0))))
    return res.get_or_create_peer(f"{name}-peer", task, host)


AFFINITY = {"ref": (RefShardAffinity, RefResource, RefTask, ref_msg),
            "port": (ShardAffinity, Resource, Task, port_msg)}


@pytest.mark.parametrize("pkg", sorted(AFFINITY))
class TestShardAffinity:
    def _stack(self, pkg):
        aff_cls, res_cls, task_cls, msg = AFFINITY[pkg]
        return res_cls(), task_cls("t" + "0" * 63, "file:///x"), \
            aff_cls(), msg

    @staticmethod
    def _assign(aff, task, p, names):
        return aff.assign(task_id=task.id, peer_id=p.id, host_id=p.host.id,
                          topology=p.host.msg.topology, requested=names)

    def test_disjoint_cover_across_group(self, pkg):
        res, task, aff, msg = self._stack(pkg)
        names = [f"s{i}" for i in range(8)]
        peers = [_peer(res, msg, task, f"h{i}") for i in range(3)]
        for _ in range(2):       # the second pass sees full membership
            got = {p.host.id: self._assign(aff, task, p, names)
                   for p in peers}
        owned = [n for sub in got.values() for n in sub]
        assert sorted(owned) == sorted(names)

    def test_groups_are_pod_scoped(self, pkg):
        res, task, aff, msg = self._stack(pkg)
        for pod in ("pod-a", "pod-b"):
            p = _peer(res, msg, task, pod, pod=pod)
            assert self._assign(aff, task, p, ["a", "b"]) == ["a", "b"]

    def test_ledger_rows_only_on_change(self, pkg):
        res, task, aff, msg = self._stack(pkg)
        rows = []
        aff.sink = rows.append
        p = _peer(res, msg, task, "h0")
        self._assign(aff, task, p, ["a", "b"])
        self._assign(aff, task, p, ["a", "b"])   # identical: no row
        assert len(rows) == 1
        assert rows[0]["assigned"] == ["a", "b"] and rows[0]["swap"] == []

    def test_forget_host_moves_ownership(self, pkg):
        res, task, aff, msg = self._stack(pkg)
        names = [f"s{i}" for i in range(8)]
        a, b = _peer(res, msg, task, "ha"), _peer(res, msg, task, "hb")
        for p in (a, b):
            self._assign(aff, task, p, names)
        aff.forget_host(b.host.id)
        assert self._assign(aff, task, a, names) == names

    def test_resource_eviction_hooks_forget(self, pkg):
        """The scheduler chains the view to the resource's eviction: a
        host that leaves stops anchoring ownership."""
        res, task, aff, msg = self._stack(pkg)
        res.on_host_evict = aff.forget_host
        names = [f"s{i}" for i in range(8)]
        a, b = _peer(res, msg, task, "ha"), _peer(res, msg, task, "hb")
        for p in (a, b):
            self._assign(aff, task, p, names)
        res.leave_host(b.host.id)
        assert self._assign(aff, task, a, names) == names


@pytest.mark.parametrize("enabled", [True, False])
def test_scheduling_arm(enabled):
    res = Resource()
    task = Task("t" + "1" * 63, "file:///x")
    child = _peer(res, port_msg, task, "c0")
    sched = Scheduling(make_evaluator("default"),
                       sharded=ShardAffinity() if enabled else None)
    ref = RefScheduling(RefSchedulerConfig(), ref_make_evaluator("default"),
                        sharded=RefShardAffinity() if enabled else None)
    ref_res = RefResource()
    ref_child = _peer(ref_res, ref_msg, RefTask(task.id, "file:///x"), "c0")
    for names in (["a"], []):
        assert sched.shard_assignment(child, names) == \
            ref.shard_assignment(ref_child, names)
    assert sched.shard_assignment(child, ["a"]) == \
        (["a"] if enabled else None)


def _register_req(msg, task_id, name, names):
    return msg.RegisterPeerTaskRequest(
        url="file:///ckpt.bin", task_id=task_id, peer_id=f"{name}-peer",
        url_meta=msg.UrlMeta(shards=",".join(names)),
        peer_host=msg.Host(id=f"{name}-127.0.0.1", ip="127.0.0.1",
                           hostname=name, topology=msg.TopologyInfo(
                               pod="pod-x")))


REGISTER_TASK = "t" + "9" * 63


async def _registers(sched, msg, plan, together: bool,
                     rerule: bool = False):
    """Register ``plan``'s peers. ``rerule`` (for the reference, which
    rules only at register): after each register, rule every earlier peer
    again with the reference's own ``shard_assignment``, as the port's
    service does."""
    reqs = [_register_req(msg, REGISTER_TASK, name, names)
            for name, names in plan]
    svc = sched.service
    if together:
        results = await asyncio.gather(*(svc.register_peer_task(r, None)
                                         for r in reqs))
    else:
        results = []
        for i, r in enumerate(reqs):
            results.append(await svc.register_peer_task(r, None))
            for name, names in plan[:i] if rerule else ():
                sched.scheduling.shard_assignment(sched.resource.find_peer(
                    REGISTER_TASK, f"{name}-peer"), names)
    rows = [{k: v for k, v in r.items() if k != "created_at"}
            for r in sched.ledger.snapshot(limit=512)["decisions"]
            if r.get("decision_kind") == "shard"]
    return [r.assigned_shards for r in results], rows


REGISTER_PLAN = [("a0", [f"s{i}" for i in range(6)]),
                 ("a1", [f"s{i}" for i in range(6)]),
                 ("b0", ["s4", "s5", "s6", "s7"]),
                 ("a2", [f"s{i}" for i in range(6)])]


def test_register_assigned_shards_match_reference():
    """Registers one after another: the port's ``assigned_shards`` equal
    the reference's (the first is ruled solo), and its shard ledger rows
    equal the reference's when the reference's own ruling is applied to
    each earlier peer after every register, which is the port's re-rule."""
    port = Scheduler(SchedulerConfig(listen_ip="127.0.0.1"))
    got, got_rows = asyncio.run(_registers(port, port_msg, REGISTER_PLAN,
                                           together=False))
    want, want_rows = asyncio.run(_registers(
        RefScheduler(RefSchedulerConfig()), ref_msg, REGISTER_PLAN,
        together=False, rerule=True))
    assert got == want and got[0] == REGISTER_PLAN[0][1]
    assert got_rows == want_rows
    assert len(got_rows) > len(REGISTER_PLAN)        # re-rulings happened
    assert all(set(r["assigned"]) <= set(r["requested"]) for r in got_rows)
    # every peer's current ruling is its newest ledger row; an earlier
    # peer whose ruling changed waits to get it on its report stream
    newest = {r["peer_id"]: r["assigned"] for r in got_rows}
    for (name, _names), first in zip(REGISTER_PLAN, got):
        peer = port.resource.find_peer(REGISTER_TASK, f"{name}-peer")
        assert peer.assigned_shards == newest[peer.id]
        assert peer.shard_push_pending == (peer.assigned_shards != first)


def test_register_disabled_arm_leaves_field_off():
    got, rows = asyncio.run(_registers(
        Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                  shard_affinity_enabled=False)),
        port_msg, REGISTER_PLAN[:1], together=False))
    assert got == [None] and rows == []


async def _first_packet(sched, peer_id: str):
    """Open ``peer_id``'s report stream and read the first packet."""
    async def reports():
        yield port_msg.PieceResult(task_id=REGISTER_TASK,
                                   src_peer_id=peer_id)
        await asyncio.sleep(30)
    stream = sched.service.report_piece_result(reports(), None)
    try:
        return await stream.__anext__()
    finally:
        await stream.aclose()


def test_registers_arriving_together_are_ruled_as_a_group():
    """Replicas that register together: both packages rule the first solo
    at its register (it would tree-fetch everything); the port then rules
    it again with the full membership and sends that ruling as the first
    packet of its report stream, so the pair splits the shards
    disjointly."""
    plan = REGISTER_PLAN[:2]
    port = Scheduler(SchedulerConfig(listen_ip="127.0.0.1"))

    async def main():
        got, _ = await _registers(port, port_msg, plan, together=True)
        return got, await _first_packet(port, "a0-peer")
    got, packet = asyncio.run(main())
    want, _ = asyncio.run(_registers(
        RefScheduler(RefSchedulerConfig()), ref_msg, plan, together=True))
    assert got == want and want[0] == plan[0][1]      # solo at register
    split = ref_sharding.split_affinity(
        plan[0][1], ["a0-127.0.0.1", "a1-127.0.0.1"])
    halves = [[n for n in plan[0][1] if split[n] == host]
              for host in ("a0-127.0.0.1", "a1-127.0.0.1")]
    assert len(halves[0]) == len(halves[1]) == 3 and got[1] == halves[1]
    assert packet.src_peer_id == "a0-peer" and packet.advisory
    assert packet.assigned_shards == halves[0]
    assert not packet.candidate_peers and packet.main_peer is None
    a0 = port.resource.find_peer(REGISTER_TASK, "a0-peer")
    assert a0.assigned_shards == halves[0] and not a0.shard_push_pending


def test_rerule_reaches_an_open_report_stream():
    """A replica whose report stream is already open when its partner
    registers gets the changed ruling on that stream at once; one in
    another pod is not ruled again."""
    names = [f"s{i}" for i in range(6)]
    port = Scheduler(SchedulerConfig(listen_ip="127.0.0.1"))
    svc = port.service

    async def main():
        await svc.register_peer_task(
            _register_req(port_msg, REGISTER_TASK, "a0", names), None)
        far = _register_req(port_msg, REGISTER_TASK, "z0", names)
        far.peer_host.topology.pod = "pod-far"
        await svc.register_peer_task(far, None)
        a0 = port.resource.find_peer(REGISTER_TASK, "a0-peer")
        sink = asyncio.Queue()
        a0.packet_sink = sink
        await svc.register_peer_task(
            _register_req(port_msg, REGISTER_TASK, "a1", names), None)
        z0 = port.resource.find_peer(REGISTER_TASK, "z0-peer")
        return a0, z0, [sink.get_nowait() for _ in range(sink.qsize())]
    a0, z0, packets = asyncio.run(main())
    assert [p.assigned_shards for p in packets] == [a0.assigned_shards]
    assert 0 < len(a0.assigned_shards) < len(names)
    assert not a0.shard_push_pending
    assert z0.assigned_shards == names and not z0.shard_push_pending


def test_swap_partners_pass_the_cycle_filter():
    """Two replicas that swap must each be the other's parent. The
    reference excludes the second edge as a DAG cycle; the port offers it
    (and keeps it out of the DAG), for partners only."""
    def stack(res_cls, task_cls, msg, sched):
        res = res_cls()
        task = task_cls("t" + "2" * 63, "file:///x")
        a, b = (_peer(res, msg, task, n) for n in ("a", "b"))
        other = _peer(res, msg, task, "c", pod="elsewhere")
        for p in (a, b, other):
            p.finished_pieces.add(0)
        task.set_parents(b.id, [a.id])           # a -> b already
        task.set_parents(other.id, [b.id])       # b -> other already
        if sched.sharded is not None:
            for p in (a, b, other):
                sched.sharded.assign(
                    task_id=task.id, peer_id=p.id, host_id=p.host.id,
                    topology=p.host.msg.topology, requested=["s0", "s1"])
        return task, a, b, other

    port = Scheduling(make_evaluator("default"), sharded=ShardAffinity())
    task, a, b, other = stack(Resource, Task, port_msg, port)
    assert {p.id for p in port.filter_candidates(a)} == {b.id}
    ref = RefScheduling(RefSchedulerConfig(), ref_make_evaluator("default"),
                        sharded=RefShardAffinity())
    rtask, ra, rb, rother = stack(RefResource, RefTask, ref_msg, ref)
    assert ref.filter_candidates(ra) == []       # b excluded: cycle
    # not partners (another pod), or no shard arm: the cycle rule holds
    plain = Scheduling(make_evaluator("default"))
    task2, a2, _b2, _o2 = stack(Resource, Task, port_msg, plain)
    assert plain.filter_candidates(a2) == []
    task.set_parents(a.id, [b.id, other.id])
    assert task.dag.parents(a.id) == set()       # the DAG stays acyclic


def test_swap_partner_outlasts_a_bad_node_blip():
    """A partner whose last piece was an outlier among its last 20 (the
    bad-node rule's Z-score above 3) stays in its partner's candidates in
    the port; a non-partner with the same costs is excluded, and the
    reference excludes both. On the card such a blip had the scheduler's
    next refresh drop the partner, and the child's swap pieces then fell
    back to the seed."""
    def stack(res_cls, task_cls, msg, sched):
        res = res_cls()
        task = task_cls("t" + "3" * 63, "file:///x")
        a, b = (_peer(res, msg, task, n) for n in ("a", "b"))
        other = _peer(res, msg, task, "c", pod="elsewhere")
        for p in (a, b, other):
            p.finished_pieces.add(0)
        for p in (b, other):
            for cost in [100] * 19 + [900]:
                p.observe_piece_cost(cost)
        for p in (a, b, other):
            sched.sharded.assign(
                task_id=task.id, peer_id=p.id, host_id=p.host.id,
                topology=p.host.msg.topology, requested=["s0", "s1"])
        return a, b

    port = Scheduling(make_evaluator("default"), sharded=ShardAffinity())
    a, b = stack(Resource, Task, port_msg, port)
    assert port.evaluator.is_bad_node(b)
    assert {p.id for p in port.filter_candidates(a)} == {b.id}
    ref = RefScheduling(RefSchedulerConfig(), ref_make_evaluator("default"),
                        sharded=RefShardAffinity())
    ra, _rb = stack(RefResource, RefTask, ref_msg, ref)
    assert ref.filter_candidates(ra) == []


def test_finished_partner_stays_offered_until_its_result_lands():
    """A replica that finished its subset half-closes its report stream
    and only then sends its PeerResult (the daemon's order, as in the
    reference). In that gap its partner, still short of swap pieces, must
    keep it as a candidate parent; a partner whose stream drops without
    the half-close (a dead process) is excluded as stream-gone."""
    names = [f"s{i}" for i in range(6)]

    async def report(client, peer_id, nums):
        stream = client.stream_stream("ReportPieceResult")
        await stream.write(port_msg.PieceResult(
            task_id=REGISTER_TASK, src_peer_id=peer_id, success=True))
        for n in nums:
            await stream.write(port_msg.PieceResult(
                task_id=REGISTER_TASK, src_peer_id=peer_id, success=True,
                piece_info=port_msg.PieceInfo(piece_num=n,
                                              range_start=n * PIECE,
                                              range_size=PIECE)))
        return stream

    async def main():
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1"))
        await sched.start()
        channel = Channel(sched.address)
        try:
            for name in ("a0", "a1"):
                await sched.service.register_peer_task(_register_req(
                    port_msg, REGISTER_TASK, name, names), None)
            a0, a1 = (sched.resource.find_peer(REGISTER_TASK, f"{n}-peer")
                      for n in ("a0", "a1"))
            for p in (a0, a1):
                p.transit(PeerState.RUNNING)
            client = ServiceClient(channel, SCHEDULER_SERVICE)
            done = await report(client, a0.id, range(3))
            await done.done_writing()            # finished: half-close
            while await done.read() is not None:
                pass
            offered = {p.id for p in sched.scheduling.filter_candidates(a1)}
            crashed = await report(client, a1.id, range(3, 5))
            while len(a1.finished_pieces) < 2:
                await asyncio.sleep(0.01)
            crashed.cancel()                      # gone, no half-close
            for _ in range(500):
                if a1.packet_sink is None:
                    break
                await asyncio.sleep(0.01)
            return a0, a1, offered, sched.scheduling
        finally:
            await channel.close()
            await sched.stop()
    a0, a1, offered, scheduling = asyncio.run(
        asyncio.wait_for(main(), E2E_LIMIT_S))
    assert not a0.is_done() and not a0.stream_gone
    assert a0.finished_pieces == {0, 1, 2}
    assert a0.id in offered
    assert a1.packet_sink is None and a1.stream_gone
    assert a1.id not in {p.id for p in scheduling.filter_candidates(a0)}


# ---------------------------------------------------------------- dispatcher

DISPATCHERS = {"ref": (ref_dispatcher, ref_msg),
               "port": (piece_dispatcher, port_msg)}


def _info(msg, num, size=4):
    return msg.PieceInfo(piece_num=num, range_start=num * size,
                         range_size=size)


def test_swap_hold_constant_is_the_reference():
    assert piece_dispatcher.SWAP_HOLD_S == ref_dispatcher.SWAP_HOLD_S == 1.5


@pytest.mark.parametrize("pkg", sorted(DISPATCHERS))
class TestDispatcherShardState:
    def test_unneeded_pieces_never_dispatch(self, pkg):
        mod, msg = DISPATCHERS[pkg]

        async def main():
            d = mod.PieceDispatcher()
            d.set_shard_state({1}, set())
            await d.add_parent("p1", "a:1")
            await d.announce("p1", [_info(msg, n) for n in (0, 1, 2)])
            assert d.pending_count() == 1
            got = await d.get(timeout=0.2)
            assert [p.piece_num for p in got.pieces] == [1]
            await d.report(got, ok=True)
            assert await d.get(timeout=0.2) is None
            assert d.starving()
            await d.close()

        asyncio.run(main())

    def test_swap_piece_waits_out_hold_then_seed_serves(self, pkg):
        mod, msg = DISPATCHERS[pkg]

        async def main():
            d = mod.PieceDispatcher()
            d.set_shard_state({0, 1}, {1})
            assert d.swap_hold_s == mod.SWAP_HOLD_S
            d.swap_hold_s = 0.3
            await d.add_parent("seed", "s:1", is_seed=True)
            await d.announce("seed", [_info(msg, 0), _info(msg, 1)])
            t0 = time.monotonic()
            got = await d.get(timeout=0.2)
            assert [p.piece_num for p in got.pieces] == [0]  # no swap drag
            await d.report(got, ok=True)
            got = await d.get(timeout=2.0)       # swap: only after the hold
            assert got is not None and got.piece.piece_num == 1
            assert time.monotonic() - t0 >= 0.25
            await d.report(got, ok=True)
            await d.close()

        asyncio.run(main())

    def test_endgame_never_races_swap_piece_onto_seed(self, pkg):
        mod, msg = DISPATCHERS[pkg]

        async def main():
            d = mod.PieceDispatcher()
            d.set_shard_state({0}, {0})
            d.endgame = True
            await d.add_parent("mate", "m:1")
            await d.add_parent("seed", "s:1", is_seed=True)
            await d.announce("mate", [_info(msg, 0)])
            await d.announce("seed", [_info(msg, 0)])
            first = await d.get(timeout=0.2)
            assert first is not None and first.parent.peer_id == "mate"
            for ps in d._pieces.values():
                ps.dispatched_at -= mod.ENDGAME_RACE_AGE_S + 1.0
            assert await d.get(timeout=0.15) is None
            d.swap_nums = set()              # without the class: races
            racer = await d.get(timeout=0.3)
            assert racer is not None and racer.parent.peer_id == "seed"
            await d.close()

        asyncio.run(main())

    def test_swap_piece_rides_peer_immediately(self, pkg):
        mod, msg = DISPATCHERS[pkg]

        async def main():
            d = mod.PieceDispatcher()
            d.set_shard_state({0}, {0})
            d.swap_hold_s = 30.0
            await d.add_parent("seed", "s:1", is_seed=True)
            await d.add_parent("mate", "m:1")
            await d.announce("seed", [_info(msg, 0)])
            await d.announce("mate", [_info(msg, 0)])
            got = await d.get(timeout=0.3)
            assert got is not None and got.parent.peer_id == "mate"
            await d.report(got, ok=True)
            await d.close()

        asyncio.run(main())


def test_affinity_split_takes_equally_rare_pieces_oldest_first():
    """In an affinity split, partners hold this download's tree pieces
    off the seed from when they first saw them: equally rare pieces go
    oldest first (the reference picks at random among them)."""
    async def main():
        d = piece_dispatcher.PieceDispatcher(explore_ratio=0.0)
        d.set_shard_state(set(range(40)), {39})
        await d.add_parent("seed", "s:1", is_seed=True)
        order = [int(n) for n in np.random.default_rng(3).permutation(39)]
        for n in order:
            await d.announce("seed", [_info(port_msg, n, size=4 + n)])
        got = []
        while len(got) < 39:
            disp = await d.get(timeout=1.0)
            got += [p.piece_num for p in disp.pieces]
            await d.report(disp, ok=True)
        await d.close()
        return got
    assert asyncio.run(main()) == [int(n) for n in
                                   np.random.default_rng(3).permutation(39)]


# ---------------------------------------------------------------- widen

def _conductor(pkg, tmp_path):
    msg = PACKAGES[pkg][1]
    shards = [mk(msg, "a", 0, 4), mk(msg, "b", 4, 4)]
    if pkg == "ref":
        return RefConductor(
            task_id="t" * 64, peer_id="p1", url="http://x/y", url_meta=None,
            storage_mgr=RefStorageManager(RefStorageConfig(
                data_dir=str(tmp_path / "store"))),
            piece_mgr=None, shard_manifest=shards, requested_shards=["a"])
    return PeerTaskConductor(
        task_id="t" * 64, peer_id="p1", url="http://x/y", url_meta=None,
        storage_mgr=StorageManager(StorageConfig(
            data_dir=str(tmp_path / "store"))), piece_mgr=None,
        shard_manifest=shards, requested_shards=["a"])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestWidenCommitRace:
    def test_widen_refused_once_finishing(self, pkg, tmp_path):
        async def main():
            c = _conductor(pkg, tmp_path)
            c._finishing = True
            assert c.widen_to_whole_file() is False
            assert c.requested_shards == ["a"]
            c2 = _conductor(pkg, tmp_path)
            c2.done_event.set()
            assert c2.widen_to_whole_file() is False
            c3 = _conductor(pkg, tmp_path)
            assert c3.widen_to_whole_file() is True
            assert c3.requested_shards is None
            assert c3.widen_to_whole_file() is True   # idempotent

        asyncio.run(main())

    def test_finish_success_sets_commit_flag(self, pkg, tmp_path):
        async def main():
            c = _conductor(pkg, tmp_path)
            c.set_content_info(8, 4)
            assert c.needed_pieces == {0}
            await c.on_piece_from_source(0, 0, b"abcd", 1)
            await c._finish_success()
            assert c._finishing is True and c.state == c.SUCCESS
            assert not c.storage.md.done          # a warm partial
            assert c.widen_to_whole_file() is False

        asyncio.run(main())

    def test_widen_keeps_ready_shards_and_needs_every_piece(self, pkg,
                                                            tmp_path):
        async def main():
            c = _conductor(pkg, tmp_path)
            c.set_content_info(8, 4)
            await c.on_piece_from_source(0, 0, b"abcd", 1)
            assert set(c.shard_tracker.ready) == {"a"}
            assert c.widen_to_whole_file() is True
            assert c.needed_pieces is None and c.pieces_remaining() == 1
            assert set(c.shard_tracker.ready) == {"a"}
            assert c.shard_tracker.total == 2
            await c.on_piece_from_source(1, 4, b"efgh", 1)
            assert set(c.shard_tracker.ready) == {"a", "b"}
            await c._finish_success()
            assert c.storage.md.done              # whole file: done

        asyncio.run(main())


# ---------------------------------------------------------------- subset pull

def _counting(base):
    class Counting(base):
        """``file://`` origin that records each range it serves and the
        bytes it reads."""

        def __init__(self):
            self.served: list[tuple[int, int]] = []
            self.bytes_read = 0

        async def download(self, req):
            resp = await super().download(req)
            start = req.range.start if req.range is not None else 0
            self.served.append((start, start + resp.content_length))
            inner = resp.chunks

            async def counted():
                async for chunk in inner:
                    self.bytes_read += len(chunk)
                    yield chunk
            resp.chunks = counted()
            return resp
    return Counting()


# a 3-piece file; s0 spans pieces 0-1, s1 sits inside piece 1, s2 in 2
SUBSET_MANIFEST = [("s0", 0, 5 * MiB), ("s1", 5 * MiB, 2 * MiB),
                   ("s2", 8 * MiB + 100, 4 * MiB - 100)]


def _subset_origin(tmp_path):
    data = np.random.default_rng(21).integers(
        0, 256, 3 * PIECE, dtype=np.uint8).tobytes()
    path = tmp_path / "ckpt.bin"
    path.write_bytes(data)
    return f"file://{path}", data


async def _subset_pulls(daemon, msg, url, counting) -> list[dict]:
    manifest = msg.ShardManifest(
        shards=[mk(msg, *s) for s in SUBSET_MANIFEST])
    out = []
    for names in ("s1", "s2", "s0"):
        counting.served.clear()
        counting.bytes_read = 0
        req = msg.DownloadRequest(
            url=url, url_meta=msg.UrlMeta(shards=names),
            shard_manifest=manifest, timeout_s=30.0)
        frames = [r async for r in daemon.ptm.start_file_task(req)]
        c = daemon.ptm.conductor(frames[-1].task_id)
        out.append({"shards": [f.shard for f in frames if f.shard],
                    "ready": sorted(c.ready),
                    "needed": sorted(c.needed_pieces),
                    "served": list(counting.served),
                    "bytes_read": counting.bytes_read,
                    "done": c.storage.md.done,
                    "state": c.state})
    return out


def test_subset_pull_reads_only_covering_pieces(tmp_path):
    url, data = _subset_origin(tmp_path)

    async def port_pulls():
        counting = _counting(FileSourceClient)
        previous = port_source.client_for("file://")
        port_source.register_client("file", counting)
        d = Daemon(DaemonConfig(workdir=str(tmp_path / "port"),
                                hostname="port", device="cpu",
                                download=DownloadConfig(
                                    back_source_group_min_bytes=MiB)))
        await d.start()
        try:
            got = await _subset_pulls(d, port_msg, url, counting)
            ts = d.storage_mgr.get(d.ptm._task_id(url, port_msg.UrlMeta()))
            with open(ts.data_path(), "rb") as f:
                assert f.read() == data           # every piece by now
            return got
        finally:
            await d.stop()
            port_source.register_client("file", previous)

    async def ref_pulls():
        counting = _counting(RefFileSourceClient)
        previous = ref_source.client_for("file://")
        ref_source.register_client("file", counting)
        d = RefDaemon(ref_dconfig.DaemonConfig(
            workdir=str(tmp_path / "ref"), host_ip="127.0.0.1",
            hostname="ref",
            storage=ref_dconfig.StorageSection(gc_interval_s=3600),
            download=ref_dconfig.DownloadConfig(
                back_source_group_min_bytes=MiB)))
        await d.start()
        try:
            return await _subset_pulls(d, ref_msg, url, counting)
        finally:
            await d.stop()
            ref_source.register_client("file", previous)

    got = asyncio.run(asyncio.wait_for(port_pulls(), E2E_LIMIT_S))
    want = asyncio.run(asyncio.wait_for(ref_pulls(), E2E_LIMIT_S))
    assert got == want
    # s1: only piece 1 crosses the origin; s2: only the gap piece 2;
    # s0: piece 0 (piece 1 is adopted from the warm partial)
    assert [g["served"] for g in got] == [[(PIECE, 2 * PIECE)],
                                          [(2 * PIECE, 3 * PIECE)],
                                          [(0, PIECE)]]
    assert [g["bytes_read"] for g in got] == [PIECE] * 3
    assert [g["shards"] for g in got] == [["s1"], ["s2"], ["s0"]]
    assert [g["ready"] for g in got] == [[1], [1, 2], [0, 1, 2]]
    # warm partials until the third subset completes the whole file
    assert [g["done"] for g in got] == [False, False, True]


def test_subset_output_holds_the_requested_bytes(tmp_path):
    url, data = _subset_origin(tmp_path)

    async def main():
        d = Daemon(DaemonConfig(workdir=str(tmp_path / "d"), hostname="d",
                                device="cpu"))
        await d.start()
        try:
            out = tmp_path / "out.bin"
            req = port_msg.DownloadRequest(
                url=url, output=str(out),
                url_meta=port_msg.UrlMeta(shards="s2"),
                shard_manifest=port_msg.ShardManifest(
                    shards=[mk(port_msg, *s) for s in SUBSET_MANIFEST]),
                device_sink=port_msg.DeviceSink(enabled=True),
                timeout_s=30.0)
            frames = [r async for r in d.ptm.start_file_task(req)]
            c = d.ptm.conductor(frames[-1].task_id)
            tensors = await asyncio.to_thread(c.device_ingest.result, 10)
            lo, size = SUBSET_MANIFEST[2][1:]
            assert list(tensors) == ["s2"]
            assert tensors["s2"].numpy().tobytes() == data[lo:lo + size]
            assert c.device_ingest.host.numel() == size
            assert out.read_bytes()[lo:lo + size] == data[lo:lo + size]
            # the completed-task reuse path never serves the partial
            assert d.storage_mgr.find_completed_task(c.task_id) is None
        finally:
            await d.stop()

    asyncio.run(asyncio.wait_for(main(), E2E_LIMIT_S))


# ---------------------------------------------------------------- affinity pod

SWAP_SHARDS = [(f"s{i}", i * PIECE, PIECE) for i in range(4)]
SWAP_NAMES = ",".join(s[0] for s in SWAP_SHARDS)


def _crash(daemon) -> None:
    """Stop without LeaveHost: the scheduler keeps the dead host's shard
    request, as it does for a host that died."""
    async def no_leave():
        return None
    daemon.scheduler.leave_host = no_leave


async def _affinity_pod(seed, sched_addr, make_leecher, msg, urls):
    """B pulls both files solo; A pulls the first and swaps off B; B dies;
    A pulls the second and falls back to the tree for B's shards."""
    manifest = msg.ShardManifest(shards=[mk(msg, *s) for s in SWAP_SHARDS])

    async def pull(d, url):
        req = msg.DownloadRequest(
            url=url, url_meta=msg.UrlMeta(shards=SWAP_NAMES),
            shard_manifest=manifest, disable_back_source=True,
            timeout_s=40.0)
        frames = [r async for r in d.ptm.start_file_task(req)]
        c = d.ptm.conductor(frames[-1].task_id)
        with open(c.storage.data_path(), "rb") as f:
            content = f.read()
        parents = collections.Counter(
            "seed" if p.source.endswith("seed") else "mate"
            for p in c.storage.md.pieces.values())
        return {"srcs": {f.shard: f.shard_src for f in frames if f.shard},
                "assigned": c.affinity_shards,
                "traffic_source": c.traffic_source,
                "traffic_p2p": c.traffic_p2p,
                "parents": dict(parents)}, content

    b, a = make_leecher("b"), make_leecher("a")
    await b.start()
    await a.start()
    try:
        for url in urls:
            await pull(b, url)
        first, first_bytes = await pull(a, urls[0])
        _crash(b)
        await b.stop()
        second, second_bytes = await pull(a, urls[1])
        return first, second, first_bytes, second_bytes
    finally:
        await a.stop()


def _fallbacks(registry) -> float:
    return registry._metrics["df_shard_fallback_total"].value()


def test_affinity_swap_and_holder_kill_fallback(tmp_path):
    data = [np.random.default_rng(31 + i).integers(
        0, 256, 4 * PIECE, dtype=np.uint8).tobytes() for i in range(2)]
    urls = []
    for i, blob in enumerate(data):
        path = tmp_path / f"f{i}.bin"
        path.write_bytes(blob)
        urls.append(f"file://{path}")

    async def port_pod():
        seed = Daemon(DaemonConfig(
            workdir=str(tmp_path / "p-seed"), hostname="seed", is_seed=True,
            listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu"))
        await seed.start()
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1", seed_peers=[
            SeedPeerAddr(host_id=seed.host_info().id, ip="127.0.0.1",
                         rpc_port=seed.rpc.port,
                         download_port=seed.upload_server.port)]))
        await sched.start()
        try:
            return await _affinity_pod(
                seed, sched.address, lambda n: Daemon(DaemonConfig(
                    workdir=str(tmp_path / f"p-{n}"), hostname=n,
                    listen_ip="127.0.0.1", host_ip="127.0.0.1",
                    device="cpu",
                    scheduler=DaemonSched(addresses=[sched.address]))),
                port_msg, urls)
        finally:
            await sched.stop()
            await seed.stop()

    async def ref_pod():
        def cfg(name):
            return ref_dconfig.DaemonConfig(
                workdir=str(tmp_path / f"r-{name}"), host_ip="127.0.0.1",
                hostname=name,
                storage=ref_dconfig.StorageSection(gc_interval_s=3600))
        seed_cfg = cfg("seed")
        seed_cfg.is_seed = True
        seed = RefDaemon(seed_cfg)
        await seed.start()
        sched = RefScheduler(RefSchedulerConfig(seed_peers=[RefSeedPeerAddr(
            ip="127.0.0.1", rpc_port=seed.rpc.port,
            download_port=seed.upload_server.port)]))
        await sched.start()

        def leecher(name):
            c = cfg(name)
            c.scheduler = ref_dconfig.SchedulerConfig(
                addresses=[sched.address], schedule_timeout_s=20.0)
            return RefDaemon(c)
        try:
            return await _affinity_pod(seed, sched.address, leecher,
                                       ref_msg, urls)
        finally:
            await sched.stop()
            await seed.stop()

    before = _fallbacks(REGISTRY)
    got = asyncio.run(asyncio.wait_for(port_pod(), E2E_LIMIT_S))
    port_fallbacks = _fallbacks(REGISTRY) - before
    before = _fallbacks(REF_REGISTRY)
    want = asyncio.run(asyncio.wait_for(ref_pod(), E2E_LIMIT_S))
    ref_fallbacks = _fallbacks(REF_REGISTRY) - before
    first, second, first_bytes, second_bytes = got
    assert first_bytes == data[0] and second_bytes == data[1]
    assert want[2] == data[0] and want[3] == data[1]
    # A was assigned a strict subset: the rest swapped off B over P2P,
    # never from the origin
    assert 0 < len(first["assigned"]) < len(SWAP_SHARDS)
    assert "swap" in first["srcs"].values()
    assert first["traffic_source"] == second["traffic_source"] == 0
    assert first["parents"].get("mate", 0) > 0
    # B died holding A's swap shards of the second file: the seed (the
    # tree) served them after the hold, each counted as a fallback
    assert second["parents"].get("mate", 0) == 0
    swapped = [n for n, src in second["srcs"].items() if src == "swap"]
    assert swapped and port_fallbacks == len(swapped)
    # the same rulings and the same fallback count in the reference
    for ours, theirs in ((first, want[0]), (second, want[1])):
        assert ours["assigned"] == theirs["assigned"]
        assert ours["srcs"] == theirs["srcs"]
    assert port_fallbacks == ref_fallbacks


def test_replicas_started_together_swap_without_fallback(tmp_path):
    """Two pipeline stages, two replicas each, started together (the
    smoke's phase 9 at a CPU size, with the origin slowed so that the
    seed's pull outlasts the swap hold, as a multi-GB pull does): each
    pair is ruled as a pair, every swap-class piece comes from the
    partner, none falls back to the tree, and no replica reads the
    origin."""
    shard = 2 * PIECE
    data = np.random.default_rng(41).integers(
        0, 256, 8 * shard, dtype=np.uint8).tobytes()
    path = tmp_path / "stages.bin"
    path.write_bytes(data)
    names = [f"s{i}" for i in range(8)]
    stages = [names[:4], names[4:]]
    manifest = port_msg.ShardManifest(shards=[
        mk(port_msg, n, i * shard, shard) for i, n in enumerate(names)])

    class SlowOrigin(FileSourceClient):
        async def download(self, req):
            resp = await super().download(req)
            inner = resp.chunks

            async def slow():
                async for chunk in inner:
                    await asyncio.sleep(0.15)     # about 7 MiB/s a stream
                    yield chunk
            resp.chunks = slow()
            return resp
    previous = port_source.client_for("file://")
    port_source.register_client("file", SlowOrigin())

    async def main():
        seed = Daemon(DaemonConfig(
            workdir=str(tmp_path / "seed"), hostname="seed", is_seed=True,
            listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu"))
        await seed.start()
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1", seed_peers=[
            SeedPeerAddr(host_id=seed.host_info().id, ip="127.0.0.1",
                         rpc_port=seed.rpc.port,
                         download_port=seed.upload_server.port)]))
        await sched.start()
        replicas = {n: Daemon(DaemonConfig(
            workdir=str(tmp_path / n), hostname=n, listen_ip="127.0.0.1",
            host_ip="127.0.0.1", device="cpu",
            scheduler=DaemonSched(addresses=[sched.address])))
            for n in ("a0", "a1", "b0", "b1")}
        for d in replicas.values():
            d.topology = dataclasses.replace(d.topology, pod="pod-x")
            await d.start()

        async def pull(d, stage):
            req = port_msg.DownloadRequest(
                url=f"file://{path}", disable_back_source=True,
                url_meta=port_msg.UrlMeta(shards=",".join(stage)),
                shard_manifest=manifest, timeout_s=40.0,
                device_sink=port_msg.DeviceSink(enabled=True))
            frames = [r async for r in d.ptm.start_file_task(req)]
            c = d.ptm.conductor(frames[-1].task_id)
            return c, await asyncio.to_thread(c.device_ingest.result, 10)
        try:
            return await asyncio.gather(*(
                pull(d, stages[n[0] == "b"]) for n, d in replicas.items()))
        finally:
            for d in replicas.values():
                await d.stop()
            await sched.stop()
            await seed.stop()

    before = _fallbacks(REGISTRY)
    try:
        runs = asyncio.run(asyncio.wait_for(main(), E2E_LIMIT_S))
    finally:
        port_source.register_client("file", previous)
    assert _fallbacks(REGISTRY) == before
    for i in (0, 2):                              # each stage's pair
        (c0, _), (c1, _) = runs[i], runs[i + 1]
        stage = stages[i // 2]
        assert sorted(c0.affinity_shards + c1.affinity_shards) == stage
        assert len(c0.affinity_shards) == len(c1.affinity_shards) == 2
    for (c, tensors), stage in zip(runs, [stages[0]] * 2 + [stages[1]] * 2):
        assert list(tensors) == stage
        for n in stage:
            lo = int(n[1:]) * shard
            assert tensors[n].numpy().tobytes() == data[lo:lo + shard]
        assert c.traffic_source == 0 and not c.storage.md.done
        assert c.swap_piece_nums and c.swap_piece_nums <= c.ready
        assert not any(c.storage.md.pieces[n].source.endswith("seed")
                       for n in c.swap_piece_nums)


def test_metadata_save_leaves_has_range_free(tmp_path, monkeypatch):
    """A finished subset's ``persist`` (and ``mark_done``) fsyncs the
    metadata behind the data file's write-back, seconds after a multi-GB
    pull. The upload server's ``has_range`` runs on the event loop, so it
    must not wait for that save."""
    from dragonfly2_tpu_torch.storage import metadata as port_metadata
    ts = StorageManager(StorageConfig(data_dir=str(tmp_path))).register_task(
        port_metadata.TaskMetadata(task_id="t" * 64, content_length=8,
                                   total_piece_count=2, piece_size=4))
    ts.write_piece(0, 0, b"abcd")
    saving = threading.Event()
    real_save = port_metadata.TaskMetadata.save

    def slow_save(md, task_dir):
        saving.set()
        time.sleep(0.5)
        real_save(md, task_dir)
    monkeypatch.setattr(port_metadata.TaskMetadata, "save", slow_save)
    for finish in (ts.persist, lambda: ts.mark_done(success=True)):
        saving.clear()
        worker = threading.Thread(target=finish)
        worker.start()
        assert saving.wait(5)
        t0 = time.monotonic()
        assert ts.has_range(0, 4) and not ts.has_range(0, 8)
        assert time.monotonic() - t0 < 0.25
        worker.join(5)
        assert not worker.is_alive()
    assert ts.md.done and ts.md.success


def test_saves_reach_disk_in_snapshot_order(tmp_path):
    """An old subset conductor's ``persist`` (done=False) and a fresh
    conductor's ``mark_done`` (done=True) on one storage: the later state
    is the one on disk, even when the first save stalls on its way to the
    disk while the second one runs."""
    import json
    from dragonfly2_tpu_torch.storage import metadata as port_metadata
    ts = StorageManager(StorageConfig(data_dir=str(tmp_path))).register_task(
        port_metadata.TaskMetadata(task_id="s" * 64, content_length=8,
                                   total_piece_count=2, piece_size=4))
    ts.write_piece(0, 0, b"abcd")
    stalled = threading.Event()

    class StallFirstSave:
        """The storage's save lock; its first taker stalls before it
        gets the lock."""
        def __init__(self):
            self.lock, self.takers = threading.Lock(), 0

        def __enter__(self):
            self.takers += 1
            if self.takers == 1:
                stalled.set()
                time.sleep(0.3)
            self.lock.acquire()

        def __exit__(self, *exc):
            self.lock.release()
    ts._save_lock = StallFirstSave()
    old = threading.Thread(target=ts.persist)
    old.start()
    assert stalled.wait(5)
    ts.mark_done(success=True)
    old.join(5)
    assert not old.is_alive() and ts._save_lock.takers == 2
    with open(f"{ts.dir}/{port_metadata.METADATA_FILE}") as f:
        on_disk = json.load(f)
    assert on_disk["done"] and on_disk["success"]


def test_sync_of_a_task_that_never_learns_its_geometry_ends(monkeypatch):
    """A child's SyncPieceTasks to a running task without storage waits
    for the storage, but only for a register's time: a task torn down
    before it knew its geometry is answered NOT_FOUND, not held open."""
    from dragonfly2_tpu_torch.common.errors import Code, DFError
    from dragonfly2_tpu_torch.daemon import rpcserver
    monkeypatch.setattr(rpcserver, "REGISTER_TIMEOUT_S", 0.2)
    stuck = types.SimpleNamespace(storage=None,
                                  storage_ready=asyncio.Event(),
                                  done_event=asyncio.Event(),
                                  subscribe=asyncio.Queue,
                                  unsubscribe=lambda q: None)
    ptm = types.SimpleNamespace(storage_mgr={}, conductor=lambda tid: stuck)
    svc = rpcserver.DaemonService(ptm)

    async def main():
        async def requests():
            yield port_msg.PieceTaskRequest(task_id="u" * 64)
            await asyncio.sleep(30)
        stream = svc.sync_piece_tasks(requests(), None)
        t0 = time.monotonic()
        with pytest.raises(DFError) as err:
            await stream.__anext__()
        return err.value.code, time.monotonic() - t0
    code, waited = asyncio.run(asyncio.wait_for(main(), 10))
    assert code == Code.NOT_FOUND and 0.2 <= waited < 5
