"""The manager and its model registry, against the reference's.

* Store: a database file written by the reference's ``Store`` reads back
  through the port's with equal rows, and the reverse (the DDL is the
  reference's, so one file opens in either package). The port's ``close``
  waits for a query still running on another thread (closing the
  connection under it crashes the process) and later calls raise.
* Searcher: over seeded cluster scopes and peers, the port picks the
  reference's cluster.
* RPC: for the same database, the port's ``ManagerService`` answers
  GetSchedulers, GetSeedPeers, ListApplications and GetModel (with and
  without ``if_none_match``) with the reference's bytes.
* REST: for the same database, the reference's REST (aiohttp, on the
  test side only) and the port's HTTP/1.1 one return equal JSON on every
  ported GET route; what the port's POST routes create reads back the
  same through the reference's.
* Registry to scheduler: an MLP blob fitted by the reference's trainer
  (JAX on the CPU, one device, on the ``tests/data/pr19_datagen_rows.jsonl``
  folds)
  enters the port's manager through ``CreateModel``; the port scheduler's
  ``refresh_model_once`` binds it, and its ``infer`` equals the
  reference's ``make_mlp_infer`` on the same rows. Both are numpy over
  the same weights; the tolerance is 1e-6 relative.
* Refusal: a garbage blob in the registry is refused, journaled, and not
  fetched again; the evaluator stays on its floor.
* GNN: a ``topology_gnn`` blob fitted by the reference, published to the
  port's registry, binds into the port scheduler's topology store on the
  same refresh; ``avg_rtt_us`` of unprobed pairs equals the reference
  store's with the same blob and probes (numpy both; 1e-6 relative), and
  a garbage GNN blob is refused without stopping the MLP's refresh.
* Ports of ``test_ml_loop_end_to_end`` (``tests/test_ml_loop.py``) with
  the trainer on the CPU, and of
  ``test_late_scheduler_heals_daemon_out_of_back_source_only``
  (``tests/test_manager.py``).
* Liveness: with ``keepalive_ttl_s`` small, the sweep marks a seed peer
  whose keepalive stopped inactive and keeps a live one active.
* Applications: the scheduler's refresh pulls the manager's priority
  table, and a register naming the application resolves its priority.

Every test that starts servers runs under ``asyncio.wait_for`` with a
limit of its own.
"""

import asyncio
import dataclasses
import json
import os
import sqlite3
import threading

import aiohttp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.idl import base as ref_base
import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.manager.rest import RestAPI as RefRestAPI
from dragonfly2_tpu.manager.searcher import \
    find_scheduler_cluster as ref_find
from dragonfly2_tpu.manager.service import ManagerService as RefService
from dragonfly2_tpu.manager.store import Store as RefStore
from dragonfly2_tpu.scheduler.topology_store import \
    TopologyStore as RefTopologyStore
from dragonfly2_tpu.trainer import pipeline as ref_pipeline
from dragonfly2_tpu.trainer import serving as ref_serving
from dragonfly2_tpu.trainer import training as ref_training
from dragonfly2_tpu_torch.common.metrics import REGISTRY
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl import base as port_base
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.idl.messages import (CreateModelRequest,
                                               ModelInferRequest,
                                               RegisterSeedPeerRequest,
                                               UrlMeta)
from dragonfly2_tpu_torch.manager import Manager, ManagerConfig
from dragonfly2_tpu_torch.manager.rest import RestAPI
from dragonfly2_tpu_torch.manager.searcher import find_scheduler_cluster
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.manager.store import Store
from dragonfly2_tpu_torch.rpc.manager_link import ManagerLink
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.evaluator import Evaluator
from dragonfly2_tpu_torch.scheduler.evaluator_ml import (MLEvaluator,
                                                         parent_feature_row)
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.trainer import features
from dragonfly2_tpu_torch.trainer.server import Trainer, TrainerConfig

from conftest import run
from test_torch_ml_loop import _simulate_fanout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "pr19_datagen_rows.jsonl")
LIMIT_S = 30.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _limited(coro, limit: float = LIMIT_S):
    return run(asyncio.wait_for(coro, limit))


# ---------------------------------------------------------------- store

def _fill(store, rng: np.random.Generator, topo_cls, cfg_cls) -> None:
    """A seeded database: clusters with scopes and configs, schedulers
    and seed peers (some with topology, some silent), seed-peer clusters,
    applications and model versions."""
    store.create_scheduler_cluster(
        "c-default", is_default=True,
        config=cfg_cls(candidate_parent_limit=int(rng.integers(1, 9))))
    store.create_scheduler_cluster(
        "c-slice", scopes={"slices": ["s1"], "zones": ["z1"],
                           "cidrs": ["10.0.0.0/8"]})
    store.create_seed_peer_cluster("sp-a")
    store.create_seed_peer_cluster("sp-b")
    for i in range(int(rng.integers(3, 7))):
        topo = (topo_cls(slice_name=f"s{i % 2}", worker_index=i,
                         ici_coords=(i, 0, 1), num_chips=4, zone="z1")
                if rng.random() < 0.6 else None)
        store.upsert_scheduler(hostname=f"sched-{i}", ip=f"10.0.0.{i}",
                               port=8000 + i, cluster_id=1 + i % 2,
                               topology=topo)
        store.upsert_seed_peer(hostname=f"seed-{i}", ip=f"10.1.0.{i}",
                               port=9000 + i, download_port=9100 + i,
                               cluster_id=1, topology=topo)
    store.expire_stale(ttl_s=-1.0)          # all silent
    store.keepalive("scheduler", "sched-0", "10.0.0.0", 8000)
    store.keepalive("seed_peer", "seed-1", "10.1.0.1", 9001)
    store.upsert_application("app-a", url="http://a", priority={"value": 3})
    store.upsert_application("app-b", priority={"value": 99})
    store.upsert_application("app-c", priority=None)
    for v in range(3):
        store.create_model(
            name="bandwidth_mlp", version=f"v{v}",
            data=rng.bytes(int(rng.integers(10, 200))),
            metrics={"rows": int(rng.integers(100)), "final_loss": 0.5 / (v + 1)},
            scheduler_cluster_id=v % 2)
    store.create_model(name="topology_gnn", version="g0", data=b"gnn",
                       metrics={})


def _listing(store) -> dict:
    asd = dataclasses.asdict
    return {
        "scheduler_clusters": store.scheduler_clusters(),
        "seed_peer_clusters": store.seed_peer_clusters(),
        "schedulers": [asd(s) for s in store.schedulers()],
        "active_schedulers": [asd(s) for s in
                              store.schedulers(cluster_id=1,
                                               only_active=True)],
        "seed_peers": [asd(s) for s in store.seed_peers()],
        "active_seed_peers": [asd(s) for s in
                              store.seed_peers(only_active=True)],
        "applications": store.applications(),
        "models": store.models(),
        "mlp_models": store.models(name="bandwidth_mlp"),
        "latest": store.get_model("bandwidth_mlp", scheduler_cluster_id=1),
        "pinned": store.get_model("bandwidth_mlp", version="v0"),
        "missing": store.get_model("nope"),
        "cluster_config": asd(store.cluster_config(1)),
        "default": store.default_scheduler_cluster(),
    }


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_file_reads_back_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "m.db")
    cls = (RefStore, Store) if writer == "reference" else (Store, RefStore)
    msgs = ref_msg if writer == "reference" else port_msg
    w = cls[0](path)
    _fill(w, np.random.default_rng(3), msgs.TopologyInfo, msgs.ClusterConfig)
    want = _listing(w)
    w.close()
    r = cls[1](path)
    try:
        assert _listing(r) == want
        # and the reader's own writes agree with the writer's package
        assert r.expire_stale(ttl_s=-1.0) == 2
    finally:
        r.close()


def test_store_close_waits_for_a_query_on_another_thread(tmp_path):
    """A handler cancelled by the server's stop leaves its query running
    on a worker thread; ``close`` must wait for it, then refuse calls."""
    store = Store(str(tmp_path / "m.db"))
    entered, release = threading.Event(), threading.Event()

    def slow() -> int:
        entered.set()
        release.wait(10)
        return 1

    store._db.create_function("slow", 0, slow)
    out = {}
    query = threading.Thread(target=lambda: out.setdefault(
        "rows", store._rows("SELECT slow() AS v")))
    query.start()
    assert entered.wait(10)
    closer = threading.Thread(target=store.close)
    closer.start()
    closer.join(0.3)
    assert closer.is_alive()            # the query still holds the store
    release.set()
    query.join(10)
    closer.join(10)
    assert not closer.is_alive() and out["rows"][0]["v"] == 1
    with pytest.raises(sqlite3.ProgrammingError):
        store.tenants()


# ---------------------------------------------------------------- searcher

@pytest.mark.parametrize("seed", range(4))
def test_searcher_picks_the_reference_cluster(seed):
    rng = np.random.default_rng(seed)
    clusters = []
    for cid in range(1, 7):
        scopes = {}
        if rng.random() < 0.5:
            scopes["slices"] = [f"s{int(x)}" for x in rng.integers(0, 4, 2)]
        if rng.random() < 0.5:
            scopes["zones"] = [f"z{int(rng.integers(0, 3))}"]
        if rng.random() < 0.5:
            scopes["cidrs"] = [f"10.{int(rng.integers(0, 3))}.0.0/16",
                               "not-a-cidr"]
        if rng.random() < 0.3:
            scopes["hostname_regex"] = rng.choice(["^h[0-4]", "[", "x$"])
        clusters.append({"id": cid, "is_default": int(cid == 3),
                         "scopes": json.dumps(scopes) if cid % 2 else scopes})
    for _ in range(64):
        fields = {"hostname": f"h{int(rng.integers(0, 9))}",
                  "ip": f"10.{int(rng.integers(0, 3))}.1.{int(rng.integers(0, 255))}"}
        if rng.random() < 0.8:
            topo = {"slice_name": f"s{int(rng.integers(0, 4))}",
                    "zone": f"z{int(rng.integers(0, 3))}"}
            fields["topology"] = topo
        ref_req = ref_msg.GetSchedulersRequest(**{
            k: ref_msg.TopologyInfo(**v) if k == "topology" else v
            for k, v in fields.items()})
        req = port_msg.GetSchedulersRequest(**{
            k: port_msg.TopologyInfo(**v) if k == "topology" else v
            for k, v in fields.items()})
        assert find_scheduler_cluster(clusters, req) == \
            ref_find(clusters, ref_req)
    assert find_scheduler_cluster([], req) is None


# ---------------------------------------------------------------- RPC

def test_service_answers_with_the_reference_bytes(tmp_path):
    path = str(tmp_path / "m.db")
    w = RefStore(path)
    _fill(w, np.random.default_rng(5), ref_msg.TopologyInfo,
          ref_msg.ClusterConfig)
    w.close()
    ref_store, store = RefStore(path), Store(path)
    ref_svc, svc = RefService(ref_store), ManagerService(store)
    cases = [
        ("get_schedulers", {"__t": "GetSchedulersRequest", "hostname": "h",
                            "ip": "10.2.0.1", "topology": {
                                "__t": "TopologyInfo", "slice_name": "s1"}}),
        ("get_schedulers", {"__t": "GetSchedulersRequest"}),
        ("get_seed_peers", {"__t": "GetSeedPeersRequest"}),
        ("get_seed_peers", {"__t": "GetSeedPeersRequest", "cluster_id": 2}),
        ("list_applications", {"__t": "Empty"}),
        ("get_model", {"__t": "GetModelRequest", "name": "bandwidth_mlp",
                       "scheduler_cluster_id": 1}),
        ("get_model", {"__t": "GetModelRequest", "name": "bandwidth_mlp",
                       "scheduler_cluster_id": 1, "if_none_match": "v2"}),
        ("get_model", {"__t": "GetModelRequest", "name": "bandwidth_mlp",
                       "version": "v0"}),
        ("get_model", {"__t": "GetModelRequest", "name": "nope"}),
    ]

    async def main():
        for method, plain in cases:
            want = await getattr(ref_svc, method)(ref_base.decode(plain),
                                                  None)
            got = await getattr(svc, method)(port_base.decode(plain), None)
            assert port_base.dumps(got) == ref_base.dumps(want), method
        got = await svc.get_model(port_base.decode(cases[6][1]), None)
        assert got.model.version == "v2" and got.model.data == b""

    try:
        _limited(main())
    finally:
        ref_store.close()
        store.close()


# ---------------------------------------------------------------- REST

GET_ROUTES = ["/api/v1/scheduler-clusters", "/api/v1/schedulers",
              "/api/v1/seed-peers", "/api/v1/seed-peer-clusters",
              "/api/v1/applications", "/api/v1/models",
              "/api/v1/models?name=topology_gnn"]


def test_rest_returns_the_reference_json(tmp_path):
    path = str(tmp_path / "m.db")
    w = Store(path)
    _fill(w, np.random.default_rng(6), port_msg.TopologyInfo,
          port_msg.ClusterConfig)
    w.close()
    ref_store, store = RefStore(path), Store(path)
    ref_api = RefRestAPI(ref_store, None, host="127.0.0.1")
    api = RestAPI(store, host="127.0.0.1")

    async def main():
        await ref_api.start()
        await api.start()
        try:
            async with aiohttp.ClientSession() as http:
                async def get(port, route):
                    async with http.get(
                            f"http://127.0.0.1:{port}{route}") as r:
                        return r.status, await r.read()

                for route in GET_ROUTES:
                    (s1, b1), (s2, b2) = (await get(ref_api.port, route),
                                          await get(api.port, route))
                    assert s1 == s2 == 200, route
                    assert json.loads(b2) == json.loads(b1), route
                assert (await get(api.port, "/healthy")) == \
                    (await get(ref_api.port, "/healthy"))
                status, body = await get(api.port, "/metrics")
                assert status == 200 and b"# TYPE df_" in body
                for route in ("/api/v1/nope", "/api/v1/schedulers/1"):
                    assert (await get(api.port, route))[0] == 404

                # what the port's POSTs create reads back the same
                posts = [("/api/v1/scheduler-clusters",
                          {"name": "c-new", "scopes": {"zones": ["z9"]},
                           "config": {"peer_load_limit": 7}}),
                         ("/api/v1/seed-peer-clusters", {"name": "sp-new"}),
                         ("/api/v1/applications",
                          {"name": "app-new", "priority": {"value": 2}})]
                for route, body in posts:
                    async with http.post(f"http://127.0.0.1:{api.port}"
                                         f"{route}", json=body) as r:
                        assert r.status == 201, route
                        assert "id" in await r.json()
                    (s1, b1), (s2, b2) = (await get(ref_api.port, route),
                                          await get(api.port, route))
                    assert json.loads(b2) == json.loads(b1), route
                    assert body["name"] in b2.decode()
                for route, body in (("/api/v1/applications", {}),
                                    ("/api/v1/seed-peer-clusters",
                                     {"name": "sp-new"}),
                                    ("/api/v1/scheduler-clusters",
                                     {"name": "x", "config": {"bogus": 1}})):
                    async with http.post(f"http://127.0.0.1:{api.port}"
                                         f"{route}", json=body) as r:
                        assert r.status == 400, (route, body)
                async with http.delete(
                        f"http://127.0.0.1:{api.port}/api/v1/models") as r:
                    assert r.status == 405
        finally:
            await api.stop()
            await ref_api.stop()

    try:
        _limited(main())
    finally:
        ref_store.close()
        store.close()


# ---------------------------------------------------------------- registry

def _fixture_rows() -> list[dict]:
    with open(FIXTURE) as f:
        return [json.loads(line) for line in f]


def test_reference_blob_through_the_registry_binds_and_scores(tmp_path):
    rows = _fixture_rows()
    folded, source = ref_pipeline.training_rows(rows)
    assert source == "decision_outcomes"
    blob, metrics = ref_training.train_mlp(folded, epochs=60, seed=7,
                                           use_mesh=False)

    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    db_path=str(tmp_path / "m.db")))
        await mgr.start()
        link = ManagerLink([mgr.address])
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                          algorithm="ml"))
        await sched.start()
        # wired after start: no refresh loop races the calls below
        sched.manager = ManagerLink([mgr.address])
        try:
            await link.create_model(CreateModelRequest(
                name=features.MLP_MODEL_NAME, version=metrics["version"],
                data=blob, metrics=metrics, scheduler_cluster_id=1))
            ann, ev = sched.announcer, sched.scheduling.evaluator
            assert await ann.refresh_model_once()
            assert ann.model_version == metrics["version"]
            assert ev.infer.version == metrics["version"]
            assert ann.model_provenance()["metrics"]["rows"] == \
                metrics["rows"]
            assert not await ann.refresh_model_once()   # same version
            feats = [r["features"] for r in folded]
            got = np.asarray(ev.infer(feats))
            want = np.asarray(ref_serving.make_mlp_infer(blob)(feats))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        finally:
            await sched.stop()
            await link.close()
            await mgr.stop()

    _limited(main(), 60.0)


def test_garbage_in_the_registry_is_refused_and_journaled(tmp_path):
    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1"))
        await mgr.start()
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                          algorithm="ml"))
        await sched.start()
        sched.manager = ManagerLink([mgr.address])
        refused = REGISTRY.counter("df_ml_model_refused_total",
                                   labels=("model",))
        before = refused.value(features.MLP_MODEL_NAME)
        try:
            garbage = b"\x00not-an-npz" * 64
            mgr.store.create_model(name=features.MLP_MODEL_NAME,
                                   version="garbage-1", data=garbage)
            ann, ev = sched.announcer, sched.scheduling.evaluator
            assert not await ann.refresh_model_once()
            assert ev.infer is None
            assert "undecodable" in ann.refused["garbage-1"]
            assert ann.model_version == "garbage-1"
            assert refused.value(features.MLP_MODEL_NAME) == before + 1
            # the poll asks with if_none_match: no refetch, no re-journal
            assert not await ann.refresh_model_once()
            assert refused.value(features.MLP_MODEL_NAME) == before + 1
            assert ann.model_provenance()["refused"] == ann.refused
        finally:
            await sched.stop()
            await mgr.stop()

    _limited(main())


def _topo_rows(seed: int, hosts: int, links: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < links:
        a, b = (int(v) for v in rng.integers(0, hosts, 2))
        if a != b and (b, a) not in pairs:
            pairs.add((a, b))
    return [{"src": f"h{a}", "dst": f"h{b}",
             "avg_rtt_us": float(10 ** rng.uniform(1, 4)), "count": 3}
            for a, b in sorted(pairs)]


def test_gnn_through_the_registry_imputes_as_the_reference(tmp_path):
    rows = _topo_rows(8, 12, 30)
    blob, metrics = ref_training.train_gnn(rows, epochs=5, use_mesh=False)

    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1"))
        await mgr.start()
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                          algorithm="ml"))
        await sched.start()
        sched.manager = ManagerLink([mgr.address])
        ref_topo = RefTopologyStore()
        try:
            for r in rows:
                for store in (sched.topo, ref_topo):
                    store.record(r["src"], r["dst"], int(r["avg_rtt_us"]))
            probed = {(r["src"], r["dst"]) for r in rows}
            unprobed = [(f"h{a}", f"h{b}") for a in range(12)
                        for b in range(a + 1, 12)
                        if (f"h{a}", f"h{b}") not in probed
                        and (f"h{b}", f"h{a}") not in probed]
            assert unprobed
            assert sched.topo.avg_rtt_us(*unprobed[0]) is None
            ann = sched.announcer
            garbage = b"\x00" * 64
            mgr.store.create_model(name=features.GNN_MODEL_NAME,
                                   version="gnn-garbage", data=garbage)
            assert not await ann.refresh_model_once()   # no MLP yet
            with pytest.raises(ValueError) as ref_refusal:
                ref_serving.make_gnn_impute(garbage)
            assert ann.refused["gnn-garbage"] == str(ref_refusal.value)
            assert sched.topo.avg_rtt_us(*unprobed[0]) is None
            mgr.store.create_model(name=features.GNN_MODEL_NAME,
                                   version=metrics["version"], data=blob)
            await ann.refresh_model_once()
            assert ann.gnn_version == metrics["version"]
            assert ann.model_provenance()["gnn_version"] == \
                metrics["version"]
            ref_topo.bind_imputer(ref_serving.make_gnn_impute(blob))
            assert all(ref_topo.avg_rtt_us(*p) is not None
                       for p in unprobed)
            for a, b in unprobed + sorted(probed)[:5]:
                got, want = sched.topo.avg_rtt_us(a, b), \
                    ref_topo.avg_rtt_us(a, b)
                assert (got is None) == (want is None), (a, b)
                if want is not None:
                    assert got == pytest.approx(want, rel=1e-6), (a, b)
        finally:
            await sched.stop()
            await mgr.stop()

    _limited(main(), 60.0)


def test_ml_loop_end_to_end(tmp_path):
    """Records -> trainer (CPU) -> manager registry -> ml evaluator."""
    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1", rest_port=0,
                                    grpc_port=0,
                                    db_path=str(tmp_path / "m.db")))
        await mgr.start()
        trainer = Trainer(TrainerConfig(
            listen_ip="127.0.0.1", data_dir=str(tmp_path / "spool"),
            manager_addresses=[mgr.address], device="cpu"))
        await trainer.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", algorithm="ml",
            trainer_address=trainer.address,
            records_dir=str(tmp_path / "records")))
        await sched.start()
        # the manager link normally comes from _attach_manager
        sched.manager = ManagerLink([mgr.address])
        try:
            evaluator = sched.scheduling.evaluator
            assert isinstance(evaluator, MLEvaluator)
            assert evaluator.infer is None          # cold start
            task, child, ici, dcn = _simulate_fanout(sched)
            assert sched.service.records.piece_row_count() >= 64
            base = Evaluator()
            total = task.total_piece_count
            assert base.evaluate(child, ici, total_piece_count=total) > \
                base.evaluate(child, dcn, total_piece_count=total)

            ann = sched.announcer
            assert await ann.upload_once()          # records -> trainer fit
            _, metrics = trainer.service.latest[features.MLP_MODEL_NAME]
            assert metrics["final_loss"] < metrics["first_epoch_loss"]

            assert await ann.refresh_model_once()   # manager -> evaluator
            assert evaluator.infer is not None
            assert ann.model_version == metrics["version"]

            row_ici = parent_feature_row(child, ici, total_piece_count=total)
            row_dcn = parent_feature_row(child, dcn, total_piece_count=total)
            s_ici, s_dcn = evaluator.infer([row_ici, row_dcn])
            assert s_dcn > s_ici, (s_dcn, s_ici)
            assert evaluator.evaluate(child, dcn, total_piece_count=total) > \
                evaluator.evaluate(child, ici, total_piece_count=total)

            resp = await trainer.service.model_infer(
                ModelInferRequest(features=[row_dcn, row_ici]), None)
            assert resp.outputs[0] > resp.outputs[1]
            assert resp.model_version == metrics["version"]

            # the registry is queryable over REST, with the fit's metrics
            async with aiohttp.ClientSession() as http:
                async with http.get(f"http://127.0.0.1:{mgr.rest.port}"
                                    "/api/v1/models") as r:
                    listed = await r.json()
            (mlp,) = [m for m in listed
                      if m["name"] == features.MLP_MODEL_NAME]
            assert mlp["version"] == metrics["version"]
            assert mlp["scheduler_cluster_id"] == 1
            assert mlp["metrics"]["rows"] == metrics["rows"]
            assert mlp["size"] == len(
                trainer.service.latest[features.MLP_MODEL_NAME][0])
        finally:
            await sched.stop()
            await trainer.stop()
            await mgr.stop()

    _limited(main(), 60.0)


def _daemon_cfg(tmp_path, name: str, **kw) -> DaemonConfig:
    return DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                        host_ip="127.0.0.1", listen_ip="127.0.0.1",
                        device="cpu", **kw)


def test_late_scheduler_heals_daemon_out_of_back_source_only(tmp_path):
    """A daemon that boots before any scheduler registered adopts one
    through the manager's refresh loop, without a restart."""
    async def main():
        manager = Manager(ManagerConfig(listen_ip="127.0.0.1"))
        await manager.start()
        cfg = _daemon_cfg(tmp_path, "earlyD",
                          manager_addresses=[manager.address])
        cfg.scheduler.refresh_interval_s = 0.2
        daemon = Daemon(cfg)
        await daemon.start()
        sched = None
        try:
            assert daemon.scheduler is None   # nothing to discover yet
            sched = Scheduler(SchedulerConfig(
                listen_ip="127.0.0.1", manager_addresses=[manager.address]))
            await sched.start()
            for _ in range(100):
                if daemon.scheduler is not None:
                    break
                await asyncio.sleep(0.1)
            assert daemon.scheduler is not None, \
                "refresh loop never adopted the late scheduler"
            assert daemon.ptm.scheduler is daemon.scheduler
            assert f"127.0.0.1:{sched.rpc.port}" in \
                daemon.scheduler.addresses
            # a replaced scheduler reaches the ring too
            manager.store.expire_stale(ttl_s=-1.0)
            manager.store.upsert_scheduler(hostname="other", ip="127.0.0.2",
                                           port=1, cluster_id=1)
            for _ in range(100):
                if daemon.scheduler.addresses == ["127.0.0.2:1"]:
                    break
                await asyncio.sleep(0.1)
            assert daemon.scheduler.addresses == ["127.0.0.2:1"]
        finally:
            if sched is not None:
                await sched.stop()
            await daemon.stop()
            await manager.stop()

    _limited(main())


def test_liveness_sweep_marks_a_silent_seed_peer_inactive():
    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    keepalive_ttl_s=1.0,
                                    sweep_interval_s=0.2))
        await mgr.start()
        links = {}
        try:
            for name in ("alive", "dead"):
                link = links[name] = ManagerLink([mgr.address],
                                                 keepalive_interval_s=0.2)
                await link.register_seed_peer(RegisterSeedPeerRequest(
                    hostname=name, ip="127.0.0.1", port=1,
                    download_port=2))
                link.start_keepalive(source_type="seed_peer", hostname=name,
                                     ip="127.0.0.1", port=1)

            def states():
                return {p.hostname: p.state for p in mgr.store.seed_peers()}

            await asyncio.sleep(0.5)
            assert states() == {"alive": "active", "dead": "active"}
            await links.pop("dead").close()     # its beats stop
            for _ in range(50):
                if states()["dead"] == "inactive":
                    break
                await asyncio.sleep(0.1)
            assert states() == {"alive": "active", "dead": "inactive"}
            resp = await links["alive"].get_seed_peers()
            assert [p.hostname for p in resp.seed_peers] == ["alive"]
        finally:
            for link in links.values():
                await link.close()
            await mgr.stop()

    _limited(main())


def test_applications_refresh_resolves_priority(tmp_path):
    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1"))
        await mgr.start()
        mgr.store.upsert_application("critical-app", priority={"value": 3})
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                          manager_addresses=[mgr.address]))
        await sched.start()
        try:
            for _ in range(50):
                if sched.service.applications:
                    break
                await asyncio.sleep(0.1)
            assert sched.service.applications == {"critical-app": 3}
            resolve = sched.service._resolve_priority
            assert resolve(UrlMeta(application="critical-app")) == 3
            assert resolve(UrlMeta(application="critical-app",
                                   priority=5)) == 5
            assert resolve(UrlMeta(application="unknown")) == 0
        finally:
            await sched.stop()
            await mgr.stop()

    _limited(main())


def test_unported_manager_options_refuse_to_start(tmp_path):
    """No manager option is refused any more: REST auth, the last ported,
    starts, its manager in memory bootstrapping root with no file;
    certificate issuance and the TLS RPC port (item 6c) start, and
    ``grpc_tls`` without ``issue_certs`` is refused, as in the
    reference."""
    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    auth_enabled=True))
        assert mgr.cfg.unported() == []
        await mgr.start()
        try:
            assert [u["name"] for u in mgr.store.users()] == ["root"]
            assert mgr.rest.auth is mgr.auth is not None
        finally:
            await mgr.stop()
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1", grpc_tls=True))
        with pytest.raises(ValueError, match="grpc_tls requires issue_certs"):
            await mgr.start()
        mgr.store.close()
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    workdir=str(tmp_path), issue_certs=True,
                                    grpc_tls=True))
        await mgr.start()
        try:
            assert mgr.rpc.tls is not None and mgr.issue_token
            assert mgr.ca_cert_path == str(tmp_path / "manager-ca" /
                                           "proxy-ca.crt")
        finally:
            await mgr.stop()

    _limited(main())
