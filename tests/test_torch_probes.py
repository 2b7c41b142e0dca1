"""RTT probes and the ``nt`` evaluator, held against the JAX package.

The same seeded inputs, made with numpy, go through ``dragonfly2_tpu`` and
``dragonfly2_tpu_torch``:

* ``ProbeTarget``, ``SyncProbesRequest``, ``Probe`` and
  ``SyncProbesResponse`` give the reference's msgpack bytes.
* One sequence of ``record`` / ``fail`` calls, under a frozen clock,
  leaves equal ``snapshot_rows``, ``avg_rtt_us``, ``probed_count`` and
  ``pick_targets`` in both topology stores.
* On a staged 64-host cluster whose hosts each probed the 5 targets
  their store picked, ``RTTEvaluator.evaluate`` and ``explain`` equal the
  reference's for every child and candidate: totals bit-identical,
  ``substituted`` and ``rtt_us`` equal. One case binds the same
  ``topology_gnn`` imputer (a blob the port fitted) in both stores. The
  scheduler's ``nt`` rulings there give the reference's offers and
  decision rows, ``rtt_us`` and the static ``features[4]`` included.
* The scheduler's ``SyncProbes`` handler answers as the reference's on
  the same stores, and over the port's transport the probers of three
  port daemons fill ``TopologyStore.snapshot_rows``, from which the
  port's trainer fits a GNN.

Tolerances are exact. Every test that starts servers runs under
``asyncio.wait_for``.
"""

import asyncio
import functools
import itertools
import random

import numpy as np
import pytest

import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.idl import base as ref_base
from dragonfly2_tpu.scheduler import config as ref_config
from dragonfly2_tpu.scheduler import evaluator as ref_evaluator
from dragonfly2_tpu.scheduler import resource as ref_resource
from dragonfly2_tpu.scheduler.scheduling import Scheduling as RefScheduling
from dragonfly2_tpu.scheduler import service as ref_service
from dragonfly2_tpu.scheduler import topology_store as ref_topology_store
from dragonfly2_tpu.trainer import serving as ref_serving
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.daemon import networktopology
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl import base as port_base
from dragonfly2_tpu_torch.scheduler import evaluator as port_evaluator
from dragonfly2_tpu_torch.scheduler import resource as port_resource
from dragonfly2_tpu_torch.scheduler import service as port_service
from dragonfly2_tpu_torch.scheduler import topology_store as port_topology_store
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.trainer import serving as port_serving
from dragonfly2_tpu_torch.trainer import training

from test_torch_scheduler import _cross, _topologies

E2E_LIMIT_S = 60.0


@pytest.fixture
def frozen_clock(monkeypatch):
    """One settable wall clock for both stores."""
    clock = {"t": 1.7e9}

    def tick():
        clock["t"] += 0.001
        return clock["t"]
    monkeypatch.setattr(ref_topology_store.time, "time", tick)
    return clock


def _probe_messages(msg, rng) -> list:
    host = msg.Host(id="h-1", ip="10.1.0.1", hostname="h1", port=65000,
                    download_port=65001,
                    topology=msg.TopologyInfo(slice_name="s1", pod="p1"))
    probes = [msg.Probe(target_host_id=f"h-{int(i)}",
                        rtt_us=int(rng.integers(1, 1 << 31)),
                        created_at_ms=int(rng.integers(1, 1 << 42)))
              for i in rng.integers(0, 64, 3)]
    targets = [msg.ProbeTarget(host_id=f"h-{i}", ip=f"10.1.0.{i}",
                               port=65000 + i) for i in range(3)]
    return [msg.ProbeTarget(), targets[0], msg.Probe(), probes[0],
            msg.SyncProbesRequest(), msg.SyncProbesRequest(host=host),
            msg.SyncProbesRequest(host=host, probes=probes,
                                  failed_host_ids=["h-9", "h-10"]),
            msg.SyncProbesResponse(),
            msg.SyncProbesResponse(targets=targets, probe_interval_s=7.5)]


@pytest.mark.parametrize("seed", range(3))
def test_probe_messages_match_reference_bytes(seed):
    ref = _probe_messages(ref_msg, np.random.default_rng(seed))
    port = _probe_messages(port_msg, np.random.default_rng(seed))
    for r, p in zip(ref, port):
        assert port_base.dumps(p) == ref_base.dumps(r)
        assert port_base.loads(ref_base.dumps(r)) == p
    assert port_msg.SyncProbesResponse().probe_interval_s == 20.0


def _store_sequence(mod, seed: int):
    """One seeded run of records and failures; the store and what it
    answered along the way."""
    rng = np.random.default_rng(seed)
    store = mod.TopologyStore()
    hosts = [f"h{i}" for i in range(12)]
    picks = []
    for step in range(400):
        a, b = (hosts[int(i)] for i in rng.integers(0, 12, 2))
        if rng.random() < 0.1:
            store.fail(a, b)
        else:
            store.record(a, b, int(rng.integers(5, 30000)))
        if step % 50 == 0:
            picks.append([store.pick_targets(h, hosts) for h in hosts])
    return store, hosts, picks


@pytest.mark.parametrize("seed", range(4))
def test_store_sequence_matches_reference(seed, frozen_clock):
    ref, hosts, ref_picks = _store_sequence(ref_topology_store, seed)
    frozen_clock["t"] = 1.7e9
    port, _, port_picks = _store_sequence(port_topology_store, seed)
    assert port.snapshot_rows() == ref.snapshot_rows()
    assert port_picks == ref_picks
    assert port.probe_targets == ref.probe_targets == 5
    for a, b in itertools.product(hosts, repeat=2):
        assert port.avg_rtt_us(a, b) == ref.avg_rtt_us(a, b)
    for h in hosts:
        assert port.probed_count(h) == ref.probed_count(h)
        assert port.pick_targets(h, hosts) == ref.pick_targets(h, hosts)


N_HOSTS = 64


def _cluster(seed: int, clock: dict):
    """A staged 64-host cluster in both packages, one peer per host; each
    host probed the 5 targets its store picked (least-probed first), with
    seeded RTTs, each store from the same clock reading. Returns (ref
    task, port task, ref store, port store, peer ids)."""
    rng = np.random.default_rng(seed)
    topos = _topologies()[:-1]
    total = 16
    hosts = [ref_msg.Host(
        id=f"host-{i}", ip=f"10.0.{i // 250}.{i % 250}", hostname=f"h{i}",
        port=9000 + i, download_port=8000 + i,
        type=ref_msg.HostType(int(rng.choice([0, 0, 0, 1, 2]))),
        topology=topos[int(rng.integers(len(topos)))],
        concurrent_upload_limit=int(rng.choice([0, 2, 3])))
        for i in range(N_HOSTS)]
    states = [rng.choice(["running", "running", "succeeded", "back_source"])
              for _ in range(N_HOSTS)]
    finished = [rng.choice(total, int(rng.integers(1, total)), replace=False)
                for _ in range(N_HOSTS)]
    costs = [rng.integers(5, 400, 6) for _ in range(N_HOSTS)]
    rtts = rng.integers(20, 50_000, (N_HOSTS, N_HOSTS))
    peer_ids = [f"peer-{i}" for i in range(N_HOSTS)]
    host_ids = [h.id for h in hosts]

    def build(res_mod, host_msgs):
        res = res_mod.Resource()
        task = res.get_or_create_task("t" * 64, "file:///origin")
        task.set_content_info(total << 22, 1 << 22, total)
        for i, pid in enumerate(peer_ids):
            peer = res.get_or_create_peer(pid, task,
                                          res.store_host(host_msgs[i]))
            peer.transit(res_mod.PeerState.RUNNING)
            if states[i] != "running":
                peer.transit(res_mod.PeerState(states[i]))
            peer.finished_pieces.update(int(n) for n in finished[i])
            for c in costs[i]:
                peer.observe_piece_cost(int(c))
        return task

    def probe(store_mod):
        clock["t"] = 1.7e9
        store = store_mod.TopologyStore()
        for i, src in enumerate(host_ids):
            for dst in store.pick_targets(src, host_ids):
                store.record(src, dst, int(rtts[i, host_ids.index(dst)]))
        return store

    ref_task = build(ref_resource, hosts)
    port_task = build(port_resource, [_cross(h) for h in hosts])
    return (ref_task, port_task, probe(ref_topology_store),
            probe(port_topology_store), peer_ids)


def _gnn_blob(rows: list[dict]) -> bytes:
    out = training.train_gnn(rows, epochs=3, seed=0, device="cpu")
    assert out is not None
    return out[0]


@pytest.mark.parametrize("case", ["measured", "imputed"])
def test_rtt_evaluator_matches_reference_on_64_hosts(case, frozen_clock):
    ref_task, port_task, ref_store, port_store, ids = _cluster(7,
                                                               frozen_clock)
    assert port_store.snapshot_rows() == ref_store.snapshot_rows()
    assert all(port_store.probed_count(f"host-{i}") == 5
               for i in range(N_HOSTS))
    if case == "imputed":
        blob = _gnn_blob(port_store.snapshot_rows())
        port_store.bind_imputer(port_serving.make_gnn_impute(blob))
        ref_store.bind_imputer(ref_serving.make_gnn_impute(blob))
    ref_ev = ref_evaluator.make_evaluator("nt", topo_store=ref_store)
    port_ev = port_evaluator.make_evaluator("nt", topo_store=port_store)
    assert type(port_ev) is port_evaluator.RTTEvaluator
    total = ref_task.total_piece_count
    substituted = 0
    for c, p in itertools.product(ids, repeat=2):
        if c == p:
            continue
        rc, rp = ref_task.peers[c], ref_task.peers[p]
        pc, pp = port_task.peers[c], port_task.peers[p]
        got = port_ev.explain(pc, pp, total_piece_count=total)
        want = ref_ev.explain(rc, rp, total_piece_count=total)
        assert got == want
        assert port_ev.evaluate(pc, pp, total_piece_count=total) == \
            ref_ev.evaluate(rc, rp, total_piece_count=total) == got["total"]
        if "substituted" in got:
            substituted += 1
            assert got["substituted"] == {"locality": "rtt"}
            assert got["rtt_us"] == port_store.avg_rtt_us(pc.host.id,
                                                          pp.host.id)
    pairs = N_HOSTS * (N_HOSTS - 1)
    if case == "measured":
        # each host probed 5 others; a pair counts when either end did
        assert 5 * N_HOSTS <= substituted < pairs
    else:
        assert substituted == pairs


def test_nt_rulings_and_decision_rows_match_reference(frozen_clock):
    ref_task, port_task, ref_store, port_store, ids = _cluster(
        3, frozen_clock)
    with_rtt = 0
    for i, cid in enumerate(ids[:16]):
        for kind in ("find_parents", "refresh_parents"):
            ref_rows, port_rows = [], []
            random.seed(300 + i)
            ref_sched = RefScheduling(
                ref_config.SchedulerConfig(),
                ref_evaluator.make_evaluator("nt", topo_store=ref_store))
            ref_sched.decision_sink = ref_rows.append
            ref_parents = getattr(ref_sched, kind)(ref_task.peers[cid])
            port_sched = Scheduling(
                port_evaluator.make_evaluator("nt", topo_store=port_store),
                rng=random.Random(300 + i))
            port_sched.decision_sink = port_rows.append
            port_parents = getattr(port_sched, kind)(port_task.peers[cid])
            assert [p.id for p in port_parents] == \
                [p.id for p in ref_parents]
            assert port_rows == ref_rows
            for row in port_rows:
                assert row["evaluator"] == "RTTEvaluator"
                for cand in row["candidates"]:
                    rtt = port_store.avg_rtt_us(row["host_id"],
                                                cand["host_id"])
                    if rtt is None:
                        assert "rtt_us" not in cand
                        continue
                    with_rtt += 1
                    assert cand["substituted"] == {"locality": "rtt"}
                    assert cand["rtt_us"] == rtt
                    assert cand["features"][4] == \
                        port_evaluator.Evaluator._locality_score(
                            port_task.peers[row["peer_id"]],
                            port_task.peers[cand["peer_id"]])
    assert with_rtt > 0


def test_sync_probes_handler_matches_reference(frozen_clock):
    """The handler on the same request stream: same targets, same rows
    recorded, failed links dropped."""
    host_msgs = [ref_msg.Host(id=f"host-{i}", ip=f"10.0.0.{i}",
                              port=9000 + i) for i in range(8)]

    async def drive(svc, msg, hosts):
        async def requests():
            yield msg.SyncProbesRequest(host=hosts[0])
            yield msg.SyncProbesRequest(host=hosts[0], probes=[
                msg.Probe(target_host_id=f"host-{i}", rtt_us=100 * i)
                for i in (1, 2, 3)])
            yield msg.SyncProbesRequest(host=hosts[0],
                                        failed_host_ids=["host-2"])
        return [r async for r in svc.sync_probes(requests(), None)]

    def stack(res_mod, store_mod, service_cls, hosts):
        res = res_mod.Resource()
        for h in hosts:
            res.store_host(h)
        store = store_mod.TopologyStore()
        svc = service_cls.__new__(service_cls)
        svc.resource, svc.topo = res, store
        return svc, store

    ref_svc, ref_store = stack(ref_resource, ref_topology_store,
                               ref_service.SchedulerService, host_msgs)
    want = asyncio.run(drive(ref_svc, ref_msg, host_msgs))
    frozen_clock["t"] = 1.7e9
    port_hosts = [_cross(h) for h in host_msgs]
    port_svc, port_store = stack(port_resource, port_topology_store,
                                 port_service.SchedulerService, port_hosts)
    got = asyncio.run(drive(port_svc, port_msg, port_hosts))
    assert [port_base.dumps(r) for r in got] == \
        [ref_base.dumps(r) for r in want]
    # targets come from the announced and registered hosts only, as in
    # the reference: the rows, clock stamps included, are the reference's
    assert port_store.snapshot_rows() == ref_store.snapshot_rows()
    assert [r["dst"] for r in port_store.snapshot_rows()] == \
        ["host-1", "host-3"]


def test_probers_fill_the_snapshot_and_the_trainer_fits_it(tmp_path,
                                                           monkeypatch):
    """Three port daemons' probers report over the port's transport; the
    scheduler's store then holds a measured RTT for every ordered pair
    among them, and the port's trainer fits a GNN from those rows. The
    scheduler's probe interval is cut from 20 s to 0.2 s."""
    monkeypatch.setattr(port_service, "SyncProbesResponse", functools.partial(
        port_msg.SyncProbesResponse, probe_interval_s=0.2))
    monkeypatch.setattr(networktopology, "REDIAL_S", 0.2)

    async def main():
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                          algorithm="nt"))
        await sched.start()
        daemons = [Daemon(DaemonConfig(
            workdir=str(tmp_path / n), hostname=n, listen_ip="127.0.0.1",
            host_ip="127.0.0.1", device="cpu",
            scheduler=DaemonSched(addresses=[sched.address])))
            for n in ("pa", "pb", "pc")]
        try:
            for d in daemons:
                await d.start()
            ids = {d.host_info().id for d in daemons}
            want = {(a, b) for a, b in itertools.permutations(ids, 2)}
            while True:
                rows = sched.topo.snapshot_rows()
                if {(r["src"], r["dst"]) for r in rows} >= want:
                    break
                await asyncio.sleep(0.05)
            rounds = [d.prober.rounds for d in daemons]
        finally:
            for d in daemons:
                await d.stop()
            await sched.stop()
        return rows, ids, rounds, sched

    rows, ids, rounds, sched = asyncio.run(
        asyncio.wait_for(main(), E2E_LIMIT_S))
    assert type(sched.scheduling.evaluator) is port_evaluator.RTTEvaluator
    assert all(n >= 1 for n in rounds)
    assert all(r["avg_rtt_us"] > 0 and r["count"] >= 1 for r in rows)
    blob, metrics = training.train_gnn(rows, epochs=5, seed=0, device="cpu")
    assert metrics["nodes"] == len(ids) and metrics["edges"] == len(rows)
    impute = port_serving.make_gnn_impute(blob)
    assert impute.version and impute(rows, []) == {}


def test_prober_connect_rtt_and_refusal():
    async def main():
        server = await asyncio.start_server(lambda r, w: w.close(),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        server.close()
        await server.wait_closed()
        live = await asyncio.start_server(lambda r, w: w.close(),
                                          "127.0.0.1", 0)
        try:
            rtt = await networktopology.tcp_rtt_us(
                "127.0.0.1", live.sockets[0].getsockname()[1])
        finally:
            live.close()
            await live.wait_closed()
        return rtt, await networktopology.tcp_rtt_us("127.0.0.1", port)

    rtt, refused = asyncio.run(asyncio.wait_for(main(), E2E_LIMIT_S))
    assert rtt is not None and rtt > 0 and refused is None
