"""Pod federation on the port and against the reference
(``scheduler/federation.py``).

* The reference's ``tests/test_federation.py`` election cases run through
  both packages (``pkg`` parameter); its cross-pod filter cases and the
  eviction hooks run on the port.
* Parity: seeded membership churn and quarantine states give equal
  elections, decision rows, ``describe`` and ``export_state`` in both
  packages; ``walk_ring`` and the seed client walk the same ring; an
  export restores in the other package.
* A live federated pod on the CPU: a scheduler with ``federation_enabled``,
  a pod-less seed and two pods of two daemons each; one pod seed is
  elected per pod and no member takes a piece from the other pod.
"""

import asyncio
import dataclasses
import json
import random

import pytest

import dragonfly2_tpu.idl.messages as ref_msg
import dragonfly2_tpu.rpc.balancer as ref_balancer
import dragonfly2_tpu.scheduler.federation as ref_federation
import dragonfly2_tpu.scheduler.quarantine as ref_quarantine
import dragonfly2_tpu_torch.idl.messages as port_msg
import dragonfly2_tpu_torch.rpc.balancer as port_balancer
import dragonfly2_tpu_torch.scheduler.federation as port_federation
import dragonfly2_tpu_torch.scheduler.quarantine as port_quarantine
from dragonfly2_tpu_torch.daemon.config import DaemonConfig, StorageSection
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import DownloadRequest, Host
from dragonfly2_tpu_torch.scheduler.config import (SchedulerConfig,
                                                   SeedPeerAddr)
from dragonfly2_tpu_torch.scheduler.evaluator import make_evaluator
from dragonfly2_tpu_torch.scheduler.resource import (PeerState, Resource,
                                                     Task)
from dragonfly2_tpu_torch.scheduler.scheduling import (EXCLUSION_REASONS,
                                                       Scheduling)
from dragonfly2_tpu_torch.scheduler.server import Scheduler

PKGS = {"reference": (ref_federation, ref_msg, ref_balancer,
                      ref_quarantine),
        "port": (port_federation, port_msg, port_balancer, port_quarantine)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def topo(msg, slice_name="", zone="", pod="", coords=None):
    return msg.TopologyInfo(slice_name=slice_name, zone=zone, pod=pod,
                            ici_coords=coords)


class FakeQuarantine:
    def __init__(self, bad=()):
        self.bad = set(bad)

    def offerable(self, host_id, child_id=""):
        return host_id not in self.bad


def make(pkg, members=8, **kw):
    fed = pkg[0].PodFederation(**kw)
    for i in range(members):
        fed.observe_host(f"h{i}", topo(pkg[1], "pod-0", "z"))
    return fed


# ---------------------------------------------------------------------
# elections (both packages)
# ---------------------------------------------------------------------

def test_election_deterministic_and_sticky(pkg):
    a = make(pkg).seeds_for("task-x", "pod-0")
    b = make(pkg).seeds_for("task-x", "pod-0")
    assert a == b and len(a) == 1
    fed = make(pkg)
    first = fed.seeds_for("task-x", "pod-0")
    assert fed.seeds_for("task-x", "pod-0") is first


def test_different_tasks_spread_over_the_ring(pkg):
    fed = make(pkg, members=16)
    seeds = {fed.seeds_for(f"task-{i}", "pod-0")[0] for i in range(32)}
    assert len(seeds) > 1


def test_quarantined_member_skipped(pkg):
    plain = make(pkg).seeds_for("task-x", "pod-0")[0]
    fed = make(pkg, quarantine=FakeQuarantine(bad=[plain]))
    assert fed.seeds_for("task-x", "pod-0")[0] != plain


def test_wholly_quarantined_pod_still_elects(pkg):
    all_bad = FakeQuarantine(bad={f"h{i}" for i in range(8)})
    assert make(pkg, quarantine=all_bad).seeds_for("task-x", "pod-0")


def test_exhausted_election_emits_once(pkg):
    rows = []
    all_bad = FakeQuarantine(bad={f"h{i}" for i in range(8)})
    fed = make(pkg, quarantine=all_bad, sink=rows.append)
    first = fed.seeds_for("task-x", "pod-0")
    for _ in range(5):
        assert fed.seeds_for("task-x", "pod-0") == first
    assert len(rows) == 1 and rows[0]["result"] == "exhausted"


def test_exhaustion_and_recovery_both_journaled(pkg):
    rows = []
    q = FakeQuarantine()
    fed = make(pkg, quarantine=q, sink=rows.append)
    fed.seeds_for("task-x", "pod-0")
    q.bad = {f"h{i}" for i in range(8)}
    fed.seeds_for("task-x", "pod-0")
    fed.seeds_for("task-x", "pod-0")
    q.bad = set()
    fed.seeds_for("task-x", "pod-0")
    fed.seeds_for("task-x", "pod-0")
    assert [r["result"] for r in rows] == ["elected", "exhausted",
                                           "reelected"]


def test_dead_seed_reelected(pkg):
    rows = []
    fed = make(pkg, sink=rows.append)
    first = fed.seeds_for("task-x", "pod-0")[0]
    fed.forget_host(first)
    assert fed.seeds_for("task-x", "pod-0")[0] != first
    kinds = [(r["decision_kind"], r["result"]) for r in rows]
    assert ("federation", "elected") in kinds
    assert ("federation", "reelected") in kinds


def test_seed_client_walks_the_same_ring(pkg):
    ring = pkg[2].HashRing(["a", "b", "c"])
    plain = pkg[0].walk_ring(ring, "k", 3, None)
    assert plain == [ring.pick("k")]
    skipped = pkg[0].walk_ring(ring, "k", 3, FakeQuarantine(bad=[plain[0]]))
    assert skipped and skipped[0] != plain[0]


# ---------------------------------------------------------------------
# seeded parity
# ---------------------------------------------------------------------

def _churn(pkg, seed: int) -> list:
    """Seeded membership churn over three pods, quarantine evidence on a
    fake clock and elections for a handful of tasks; every answer, the
    rows and the durable state."""
    rng = random.Random(seed)
    clk = [0.0]
    reg = pkg[3].QuarantineRegistry(corrupt_threshold=1.0, min_reporters=1,
                                    probation_delay_s=50.0,
                                    clock=lambda: clk[0])
    rows: list = []
    fed = pkg[0].PodFederation(seeds_per_pod=rng.choice((1, 2)),
                               quarantine=reg, sink=rows.append)
    hosts = [f"host-{i:02d}" for i in range(18)]
    pods = ["pod-a", "pod-b", "pod-c", ""]
    tasks = [f"task-{rng.randrange(10**9)}" for _ in range(6)]
    out = []
    for _ in range(300):
        clk[0] += rng.choice((0.0, 1.0, 20.0))
        op = rng.random()
        h = rng.choice(hosts)
        if op < 0.35:
            fed.observe_host(h, topo(pkg[1], rng.choice(pods), "z"))
        elif op < 0.42:
            fed.forget_host(h)
        elif op < 0.5:
            reg.record_corrupt(h, reporter="r")
        elif op < 0.53:
            fed.drop_task(rng.choice(tasks))
        else:
            t = rng.choice(tasks)
            p = rng.choice(pods[:3])
            out.append([t, p, list(fed.seeds_for(t, p)),
                        fed.pod_of_host(h)])
    return out + [rows, fed.describe(), fed.export_state()]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_elections_equal_the_reference(seed):
    got = _churn(PKGS["port"], seed)
    assert got == _churn(PKGS["reference"], seed)
    assert got[-3]                      # elections were journaled


@pytest.mark.parametrize("src,dst", [("reference", "port"),
                                     ("port", "reference")])
def test_export_state_restores_in_the_other_package(src, dst):
    a = make(PKGS[src], members=6)
    for i in range(4):
        a.observe_host(f"q{i}", topo(PKGS[src][1], "pod-1", "z"))
    for t in ("t1", "t2", "t3"):
        a.seeds_for(t, "pod-0")
        a.seeds_for(t, "pod-1")
    blob = json.loads(json.dumps(a.export_state()))
    b = PKGS[dst][0].PodFederation()
    c = PKGS[src][0].PodFederation()
    assert b.restore(blob) == c.restore(blob) == 6
    assert b.describe() == c.describe() == a.describe()
    rows_b, rows_c = [], []
    b.sink, c.sink = rows_b.append, rows_c.append
    # a restored election that still stands emits no fresh row
    assert [b.seeds_for(t, "pod-0") for t in ("t1", "t2", "t3")] \
        == [a.seeds_for(t, "pod-0") for t in ("t1", "t2", "t3")]
    assert rows_b == rows_c == []


# ---------------------------------------------------------------------
# the scheduling filter (port)
# ---------------------------------------------------------------------

def build_task(pods=2, per_pod=3):
    res = Resource()
    task = Task("fedtest" + "0" * 57, "bench://fed")
    task.set_content_info(4 << 20, 1 << 20, 4)
    peers = []
    for p in range(pods):
        for i in range(per_pod):
            t = topo(port_msg, f"pod-{p}", "z", coords=(i, 0))
            host = res.store_host(Host(
                id=f"p{p}w{i}-host", ip="10.0.0.1", port=1, download_port=2,
                topology=t))
            peer = res.get_or_create_peer(f"p{p}w{i}-peer", task, host)
            peer.transit(PeerState.RUNNING)
            peer.finished_pieces = {0, 1}
            peers.append(peer)
    return res, task, peers


def make_sched(federation):
    return Scheduling(SchedulerConfig(), make_evaluator("default"),
                      federation=federation, rng=random.Random(0))


def make_fed(peers, seeds_per_pod=1):
    fed = port_federation.PodFederation(seeds_per_pod=seeds_per_pod)
    for peer in peers:
        fed.observe_host(peer.host.id, peer.host.msg.topology)
    return fed


def test_member_offer_never_crosses_pods():
    _res, task, peers = build_task()
    fed = make_fed(peers)
    seeds = set(fed.seeds_for(task.id, "pod-0"))
    member = next(p for p in peers
                  if p.host.msg.topology.slice_name == "pod-0"
                  and p.host.id not in seeds)
    offer = make_sched(fed).find_parents(member)
    assert offer
    assert all(p.host.msg.topology.slice_name == "pod-0" for p in offer)


def test_pod_seed_may_cross():
    _res, task, peers = build_task()
    fed = make_fed(peers)
    seed_hid = fed.seeds_for(task.id, "pod-0")[0]
    seed = next(p for p in peers if p.host.id == seed_hid)
    offer = make_sched(fed).find_parents(seed)
    assert any(p.host.msg.topology.slice_name == "pod-1" for p in offer)


def test_podless_host_never_restricted():
    res, task, peers = build_task()
    fed = make_fed(peers)
    host = res.store_host(Host(id="plain-host", ip="10.0.0.2", port=1,
                               download_port=2, topology=None))
    plain = res.get_or_create_peer("plain-peer", task, host)
    plain.transit(PeerState.RUNNING)
    assert make_sched(fed).find_parents(plain)


def test_cross_pod_exclusion_rides_the_ledger():
    assert "cross-pod" in EXCLUSION_REASONS
    _res, task, peers = build_task()
    fed = make_fed(peers)
    sched = make_sched(fed)
    rows = []
    sched.decision_sink = rows.append
    seeds = set(fed.seeds_for(task.id, "pod-0"))
    member = next(p for p in peers
                  if p.host.msg.topology.slice_name == "pod-0"
                  and p.host.id not in seeds)
    sched.find_parents(member)
    row = rows[-1]
    assert any(e["reason"] == "cross-pod" for e in row["excluded"])
    assert row["federation"] == {"pod": "pod-0",
                                 "pod_seeds": sorted(seeds),
                                 "is_pod_seed": False}
    for cand in row["candidates"]:
        assert cand["link_tier"] in ("local", "ici", "dcn", "wan")
        assert cand["cross_pod"] is False


def test_federation_none_is_exact_old_path():
    _res, _task, peers = build_task()
    sched = make_sched(None)
    rows = []
    sched.decision_sink = rows.append
    offer = sched.find_parents(peers[0])
    assert any(p.host.msg.topology.slice_name == "pod-1" for p in offer)
    assert "federation" not in rows[-1]


def test_eviction_hooks_chain_federation_and_shard_affinity():
    sched = Scheduler(SchedulerConfig(federation_enabled=True,
                                      federation_seeds_per_pod=2))
    assert sched.scheduling.federation is sched.federation
    assert sched.federation.seeds_per_pod == 2
    assert sched.federation.quarantine is sched.quarantine
    assert sched.fleetpulse.federation is sched.federation
    t = topo(port_msg, "pod-0", "z")
    sched.federation.observe_host("h1", t)
    sched.sharded.assign(task_id="t1", peer_id="p1", host_id="h1",
                         topology=t, requested=["a", "b"])
    sched.resource.on_host_evict("h1")
    assert sched.federation.pod_of_host("h1") == ""
    assert sched.sharded.export_state()["requests"] == [["t1", "pod-0", {}]]
    sched.federation.observe_host("h2", t)
    sched.federation.seeds_for("t1", "pod-0")
    sched.resource.on_task_evict("t1")
    assert sched.federation.describe()["elections"] == {}
    assert sched.sharded.export_state()["requests"] == []


# ---------------------------------------------------------------------
# a live federated pod on the CPU
# ---------------------------------------------------------------------

def test_two_pods_elect_one_seed_each_and_never_cross(tmp_path):
    data = random.Random(5).randbytes(6 * (4 << 20) + 999)
    origin = tmp_path / "origin.bin"
    origin.write_bytes(data)
    url = f"file://{origin}"

    def cfg(name, sched_addr=None, **kw):
        c = DaemonConfig(
            workdir=str(tmp_path / name), hostname=name,
            listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
            storage=StorageSection(gc_interval_s=3600),
            scheduler=DaemonSched(addresses=[sched_addr] if sched_addr
                                  else []), **kw)
        c.probe_enabled = False
        return c

    async def pull(d):
        task_id = None
        async for resp in d.ptm.start_file_task(DownloadRequest(
                url=url, output=str(tmp_path / f"{d.hostname}.out"),
                disable_back_source=True, timeout_s=60.0)):
            task_id = resp.task_id or task_id
        return d.ptm.conductor(task_id)

    async def go():
        seed = Daemon(cfg("seed", is_seed=True))
        await seed.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", federation_enabled=True,
            seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await sched.start()
        members = []
        try:
            for pod in ("pod-a", "pod-b"):
                for i in range(2):
                    d = Daemon(cfg(f"{pod}-{i}", sched.address))
                    # the pod identity DF_POD_ID gives a daemon process
                    d.topology = dataclasses.replace(d.topology, pod=pod)
                    await d.start()
                    members.append(d)
            conductors = await asyncio.gather(*(pull(d) for d in members))
            for d in members:
                assert (tmp_path / f"{d.hostname}.out").read_bytes() == data
            rows = [r for r in sched.ledger.snapshot(limit=512)["decisions"]
                    if r.get("decision_kind") == "federation"]
            elected = {r["pod"]: r["elected"] for r in rows
                       if r["result"] == "elected"}
            assert sorted(elected) == ["pod-a", "pod-b"]
            assert all(len(v) == 1 for v in elected.values())
            pod_seeds = {h for v in elected.values() for h in v}
            pod_of_peer = {c.peer_id: d.topology.pod
                           for c, d in zip(conductors, members)}
            for c, d in zip(conductors, members):
                assert c.traffic_source == 0
                if d.host_info().id in pod_seeds:
                    continue           # a pod seed may cross pods
                for parent in c.pieces_by_parent:
                    other = pod_of_peer.get(parent)
                    assert other in (None, d.topology.pod), (d.hostname,
                                                             parent)
            assert sched.federation.describe()["pods"] == {
                "pod-a": ["pod-a-0-127.0.0.1", "pod-a-1-127.0.0.1"],
                "pod-b": ["pod-b-0-127.0.0.1", "pod-b-1-127.0.0.1"]}
        finally:
            for d in members:
                await d.stop()
            await sched.stop()
            await seed.stop()

    asyncio.run(asyncio.wait_for(go(), 90.0))
