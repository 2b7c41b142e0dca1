"""The port's learned-scheduler loop on the CPU, against the reference.

A port scheduler (``algorithm="ml"``, records armed) and a port trainer on
loopback: records flow from a staged fan-out into the scheduler's record
ring, the announcer streams them to the trainer's ``Train`` RPC, the
trainer fits the MLP (on the CPU, named), ``bind_model`` binds the blob
into the ``ml`` evaluator, and the learned evaluator flips the rule-based
choice. Also: the trainer messages' bytes against the reference's, the
decision sink's rows and the schedule it leaves unchanged, and bind-time
refusal of bad blobs.
"""

import gzip
import itertools
import json
import random

import numpy as np
import pytest
import torch

import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.idl import base as ref_base
from dragonfly2_tpu.scheduler import config as ref_config
from dragonfly2_tpu.scheduler.evaluator import Evaluator as RefEvaluator
from dragonfly2_tpu.scheduler.records import \
    DownloadRecords as RefDownloadRecords
from dragonfly2_tpu.scheduler.scheduling import Scheduling as RefScheduling
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.common.metrics import REGISTRY
from dragonfly2_tpu_torch.idl import base as port_base
from dragonfly2_tpu_torch.idl.messages import (Host, HostType,
                                               ModelInferRequest, PeerResult,
                                               PieceInfo, PieceResult,
                                               TopologyInfo)
from dragonfly2_tpu_torch.rpc.client import Channel, ServiceClient
from dragonfly2_tpu_torch.scheduler.announcer import SchedulerAnnouncer
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.decision_ledger import (DecisionLedger,
                                                            stitch_outcomes)
from dragonfly2_tpu_torch.scheduler.evaluator import Evaluator
from dragonfly2_tpu_torch.scheduler.evaluator_ml import (MLEvaluator,
                                                         parent_feature_row)
from dragonfly2_tpu_torch.scheduler.records import DownloadRecords
from dragonfly2_tpu_torch.scheduler.resource import PeerState
from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.trainer import features, params_io, training
from dragonfly2_tpu_torch.trainer.server import Trainer, TrainerConfig
from dragonfly2_tpu_torch.trainer.service import TRAINER_SERVICE

from conftest import run
from test_torch_scheduler import _build_states, _cross


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These fits are small: one intra-op thread each keeps a test's time
    its own when the suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host(hid, *, slice_name="slice-0", coords=(0, 0)):
    return Host(id=hid, ip="127.0.0.1", port=1, download_port=2,
                type=HostType.NORMAL,
                topology=TopologyInfo(slice_name=slice_name, worker_index=0,
                                      ici_coords=coords, num_chips=4,
                                      zone="z-a"))


def _simulate_fanout(scheduler, *, n_pieces=40):
    """Child c pulls from two parents: the same-slice (ICI) parent is
    slow, the cross-slice (DCN) parent fast. The rule-based evaluator
    prefers ICI; the learned model must discover the opposite."""
    res = scheduler.resource
    task = res.get_or_create_task("t" * 64, "http://origin/blob")
    task.set_content_info(n_pieces * (4 << 20), 4 << 20, n_pieces)
    child_host = res.store_host(_host("h-child", coords=(0, 0)))
    ici_host = res.store_host(_host("h-ici", coords=(0, 1)))
    dcn_host = res.store_host(_host("h-dcn", slice_name="slice-1",
                                    coords=(3, 3)))
    child = res.get_or_create_peer("p-child" * 8, task, child_host)
    ici = res.get_or_create_peer("p-ici" * 8, task, ici_host)
    dcn = res.get_or_create_peer("p-dcn" * 8, task, dcn_host)
    for p in (child, ici, dcn):
        p.transit(PeerState.RUNNING)
    ici.finished_pieces.update(range(n_pieces))
    dcn.finished_pieces.update(range(n_pieces))
    records = scheduler.service.records
    for num in range(n_pieces):
        # ICI parent: stalls (~4 MB/s); DCN parent: ~800 MB/s
        for parent, cost in ((ici, 1000), (dcn, 5)):
            info = PieceInfo(piece_num=num, range_start=num * (4 << 20),
                             range_size=4 << 20, download_cost_ms=cost)
            records.on_piece(child, PieceResult(
                task_id=task.id, src_peer_id=child.id,
                dst_peer_id=parent.id, piece_info=info, success=True))
    records.on_peer(child, PeerResult(
        task_id=task.id, peer_id=child.id, success=True,
        content_length=task.content_length, total_piece_count=n_pieces,
        cost_ms=12000))
    return task, child, ici, dcn


def test_ml_loop_end_to_end(tmp_path):
    async def main():
        trainer = Trainer(TrainerConfig(
            listen_ip="127.0.0.1", data_dir=str(tmp_path / "spool"),
            device="cpu"))
        await trainer.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", algorithm="ml",
            trainer_address=f"127.0.0.1:{trainer.port}",
            records_dir=str(tmp_path / "records")))
        await sched.start()
        channel = Channel(f"127.0.0.1:{trainer.port}")
        try:
            evaluator = sched.scheduling.evaluator
            assert isinstance(evaluator, MLEvaluator)
            assert evaluator.infer is None          # cold start
            task, child, ici, dcn = _simulate_fanout(sched)
            assert sched.service.records.piece_row_count() >= 64
            total = task.total_piece_count
            base = Evaluator()
            assert base.evaluate(child, ici, total_piece_count=total) > \
                base.evaluate(child, dcn, total_piece_count=total)

            ann = sched.announcer
            assert await ann.upload_once()          # records -> trainer fit
            assert sched.service.records.piece_row_count() == 0
            assert ann.last_upload["rows"] == 81
            blob, metrics = trainer.service.latest[features.MLP_MODEL_NAME]
            assert metrics["final_loss"] < metrics["first_epoch_loss"]
            assert metrics["supervision"] == "piece_rows"
            assert ann.last_upload["model_version"] == metrics["version"]

            assert await ann.bind_model(blob)       # blob -> evaluator
            assert evaluator.infer is not None
            assert ann.model_version == metrics["version"]
            assert not await ann.bind_model(blob)   # same version: no-op

            row_ici = parent_feature_row(child, ici, total_piece_count=total)
            row_dcn = parent_feature_row(child, dcn, total_piece_count=total)
            s_ici, s_dcn = evaluator.infer([row_ici, row_dcn])
            assert s_dcn > s_ici, (s_dcn, s_ici)
            assert evaluator.evaluate(child, dcn, total_piece_count=total) > \
                evaluator.evaluate(child, ici, total_piece_count=total)
            health = ann.model_provenance()["evaluator"]
            assert health["scored"] > 0 and health["fallbacks"] == 0
            assert health["version"] == metrics["version"]

            # parity surface over the wire: the trainer serves the same model
            resp = await ServiceClient(channel, TRAINER_SERVICE).unary(
                "ModelInfer", ModelInferRequest(features=[row_dcn, row_ici]))
            assert resp.outputs == evaluator.infer([row_dcn, row_ici])
            assert resp.model_version == metrics["version"]
        finally:
            await channel.close()
            await sched.stop()
            await trainer.stop()
        # the record file holds the same rows the ring uploaded
        with open(tmp_path / "records" / "download.jsonl") as f:
            kinds = [json.loads(line)["kind"] for line in f]
        assert kinds.count("piece") == 80 and kinds.count("peer") == 1

    run(main())


def test_records_requeue_on_trainer_outage():
    async def main():
        cfg = SchedulerConfig(listen_ip="127.0.0.1", algorithm="ml",
                              trainer_address="127.0.0.1:1")   # nothing there
        sched = Scheduler(cfg, records=DownloadRecords())
        await sched.start()
        try:
            _simulate_fanout(sched, n_pieces=8)
            before = sched.service.records.piece_row_count()
            assert before > 0
            ann = SchedulerAnnouncer(sched)
            with pytest.raises(Exception):
                await ann.upload_once()
            # rows survived the failed upload
            assert sched.service.records.piece_row_count() == before
            await ann.stop()
        finally:
            await sched.stop()

    run(main())


def test_trainer_rejects_a_device_it_does_not_have(tmp_path, monkeypatch):
    """With no CUDA device the default trainer raises; it never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trainer = Trainer(TrainerConfig(listen_ip="127.0.0.1",
                                    data_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(trainer.start())


_MESSAGES = {
    "TrainRequest": dict(hostname="sched-1", ip="10.0.0.1", cluster_id=3,
                         dataset="networktopology",
                         chunk=bytes(range(256)) * 9, done=True),
    "TrainResponse": dict(ok=False, message="rows={'download': 81}",
                          model_version="0123456789abcdef"),
    "ModelInferRequest": dict(features=[[0.5, 1.0, 0.25, 0.9, 0.4, 64.0,
                                         2.0], [0.0] * 7]),
    "ModelInferResponse": dict(outputs=[0.125, -3.5e-9, 1e300],
                               model_version="fedcba9876543210"),
}


@pytest.mark.parametrize("name", sorted(_MESSAGES))
def test_trainer_messages_match_reference_bytes(name):
    ref_cls, port_cls = getattr(ref_msg, name), getattr(port_msg, name)
    assert port_base.dumps(port_cls()) == ref_base.dumps(ref_cls())
    kw = _MESSAGES[name]
    wire = ref_base.dumps(ref_cls(**kw))
    assert port_base.dumps(port_cls(**kw)) == wire
    assert port_base.loads(wire) == port_cls(**kw)


def _strip_time(row: dict) -> dict:
    return {k: v for k, v in row.items() if k != "created_at"}


@pytest.mark.parametrize("seed", range(4))
def test_decision_rows_match_reference_and_leave_the_schedule(seed):
    """Armed, the decision sink emits the reference's rows and stamps the
    same ``decision_id``; the offers equal the unarmed ruling's (the sink
    never touches the rng or the ordering)."""
    ref_task, port_task, ids = _build_states(seed)
    _, plain_task, _ = _build_states(seed)
    for i, cid in enumerate(ids):
        for kind in ("find_parents", "refresh_parents"):
            ref_rows, port_rows = [], []
            random.seed(seed * 100 + i)
            ref_sched = RefScheduling(ref_config.SchedulerConfig(),
                                      RefEvaluator())
            ref_sched.decision_sink = ref_rows.append
            ref_parents = getattr(ref_sched, kind)(ref_task.peers[cid])
            port_sched = Scheduling(Evaluator(),
                                    rng=random.Random(seed * 100 + i))
            port_sched.decision_sink = port_rows.append
            port_parents = getattr(port_sched, kind)(port_task.peers[cid])
            plain = Scheduling(Evaluator(), rng=random.Random(seed * 100 + i))
            plain_parents = getattr(plain, kind)(plain_task.peers[cid])
            assert [p.id for p in port_parents] == \
                [p.id for p in plain_parents] == [p.id for p in ref_parents]
            assert port_rows == ref_rows and len(port_rows) == 1
            assert port_task.peers[cid].last_decision_id == \
                ref_task.peers[cid].last_decision_id
            assert plain_task.peers[cid].last_decision_id == ""
            for cand in port_rows[0]["candidates"]:
                parent = port_task.peers[cand["peer_id"]]
                assert cand["features"] == parent_feature_row(
                    port_task.peers[cid], parent,
                    total_piece_count=port_task.total_piece_count)


def test_piece_rows_join_their_decision_as_the_reference_does():
    """Ledger -> records -> fold: a ruling and the pieces fetched under it
    give the reference's record rows, a full join, and the reference's
    trainer folds."""
    ref_task, port_task, ids = _build_states(1)
    ref_rec, port_rec = RefDownloadRecords(), DownloadRecords()
    from dragonfly2_tpu.scheduler.decision_ledger import \
        DecisionLedger as RefDecisionLedger
    random.seed(7)
    ref_sched = RefScheduling(ref_config.SchedulerConfig(), RefEvaluator())
    ref_sched.decision_sink = RefDecisionLedger(ref_rec).on_decision
    port_sched = Scheduling(Evaluator(), rng=random.Random(7))
    port_sched.decision_sink = DecisionLedger(port_rec).on_decision
    rng = np.random.default_rng(3)
    for cid in ids:
        parents = [p.id for p in port_sched.find_parents(port_task.peers[cid])]
        assert parents == [p.id for p in ref_sched.find_parents(
            ref_task.peers[cid])]
        for num, pid in enumerate(parents * 2):
            result = ref_msg.PieceResult(
                task_id=ref_task.id, src_peer_id=cid, dst_peer_id=pid,
                success=True, piece_info=ref_msg.PieceInfo(
                    piece_num=num, range_size=1 << 22,
                    download_cost_ms=int(rng.integers(2, 900))))
            ref_rec.on_piece(ref_task.peers[cid], result)
            port_rec.on_piece(port_task.peers[cid], _cross(result))
    ref_rows, port_rows = ref_rec.drain(), port_rec.drain()
    assert [_strip_time(r) for r in port_rows] == \
        [_strip_time(r) for r in ref_rows]
    joined = stitch_outcomes(port_rows)
    assert joined["coverage"]["ratio"] == 1.0
    assert joined["coverage"]["piece_rows"] > 0
    from dragonfly2_tpu.trainer import features as ref_features
    assert features.decision_outcome_rows(port_rows) == \
        ref_features.decision_outcome_rows(ref_rows)


def _blob(params: dict, **meta) -> bytes:
    return params_io.serialize_params(params, dict(
        {"feature_dim": features.FEATURE_DIM}, **meta))


def _good_params(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    dims = [features.FEATURE_DIM, 16, 16, 1]
    return {"layers": [{"b": np.zeros(b, np.float32),
                        "w": rng.normal(size=(a, b)).astype(np.float32)}
                       for a, b in zip(dims, dims[1:])]}


def test_bind_refuses_bad_blobs_and_keeps_the_floor():
    async def main():
        sched = Scheduler(SchedulerConfig(algorithm="ml"))
        ann, ev = sched.announcer, sched.scheduling.evaluator
        refused = REGISTRY.counter("df_ml_model_refused_total",
                                   labels=("model",))
        before = refused.value(features.MLP_MODEL_NAME)
        nan = _good_params()
        nan["layers"][1]["w"][3, 5] = np.nan
        bad = {"garbage": b"\x00not-an-npz" * 50,
               "stale": _blob(_good_params(), feature_dim=5),
               "nan": _blob(nan)}
        for name, blob in bad.items():
            assert not await ann.bind_model(blob), name
            assert ev.infer is None, name
            assert ann.refused[params_io.version_of(blob)], name
        assert refused.value(features.MLP_MODEL_NAME) == before + 3
        assert "undecodable" in ann.refused[params_io.version_of(
            bad["garbage"])]
        assert "feature_dim" in ann.refused[params_io.version_of(
            bad["stale"])]
        assert "non-finite" in ann.refused[params_io.version_of(bad["nan"])]
        # the evaluator rules on its floor: the heuristic's score
        task, child, ici, dcn = _staged_task(sched)
        total = task.total_piece_count
        for parent in (ici, dcn):
            assert ev.evaluate(child, parent, total_piece_count=total) == \
                Evaluator().evaluate(child, parent, total_piece_count=total)
        assert ev.health()["bound"] is False
        # the next good blob binds, and a later bad one leaves it serving
        good = _blob(_good_params(1))
        assert await ann.bind_model(good)
        assert ev.infer.version == params_io.version_of(good)
        assert not await ann.bind_model(bad["nan"])    # seen: no re-journal
        assert ev.infer.version == params_io.version_of(good)

    run(main())


def _staged_task(sched):
    res = sched.resource
    task = res.get_or_create_task("s" * 64, "http://origin/blob")
    task.set_content_info(8 * (4 << 20), 4 << 20, 8)
    child = res.get_or_create_peer("c" * 40, task, res.store_host(
        _host("h-c")))
    ici = res.get_or_create_peer("i" * 40, task, res.store_host(
        _host("h-i", coords=(0, 1))))
    dcn = res.get_or_create_peer("d" * 40, task, res.store_host(
        _host("h-d", slice_name="slice-1", coords=(3, 3))))
    for p in (child, ici, dcn):
        p.transit(PeerState.RUNNING)
    ici.finished_pieces.update(range(8))
    dcn.finished_pieces.update(range(4))
    return task, child, ici, dcn


def test_non_finite_scores_fall_back_to_the_floor():
    """A bound model that answers NaN for a row rules that row on the
    heuristic and says so in ``health()``."""
    sched = Scheduler(SchedulerConfig(algorithm="ml"))
    ev = sched.scheduling.evaluator
    ev.infer = lambda rows: [float("nan")] * len(rows)
    task, child, ici, _ = _staged_task(sched)
    total = task.total_piece_count
    assert ev.evaluate(child, ici, total_piece_count=total) == \
        Evaluator().evaluate(child, ici, total_piece_count=total)
    health = ev.health()
    assert health["degraded"] and health["fallbacks"] == 1
    assert health["last_fallback_reason"].startswith("non_finite")


def test_topology_snapshot_uploads_once_and_fits_the_gnn(tmp_path):
    """The topology store's snapshot rides the same upload; an unchanged
    snapshot is not re-sent."""
    async def main():
        trainer = Trainer(TrainerConfig(
            listen_ip="127.0.0.1", data_dir=str(tmp_path / "spool"),
            device="cpu"))
        await trainer.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", algorithm="ml",
            trainer_address=f"127.0.0.1:{trainer.port}"))
        try:
            rng = np.random.default_rng(0)
            hosts = [f"h{i}" for i in range(12)]
            for a, b in itertools.permutations(hosts, 2):
                if rng.random() < 0.4:
                    sched.topo.record(a, b, int(rng.integers(10, 20000)))
            n_links = len(sched.topo.snapshot_rows())
            assert await sched.announcer.upload_once()
            assert sched.announcer.last_upload["topology_rows"] == n_links
            blob, metrics = trainer.service.latest[features.GNN_MODEL_NAME]
            assert metrics["edges"] == n_links and metrics["nodes"] == 12
            assert features.MLP_MODEL_NAME not in trainer.service.latest
            # unchanged snapshot, no rows: nothing to send
            assert not await sched.announcer.upload_once()
            sched.topo.record("h0", "h1", 99)
            assert await sched.announcer.upload_once()
        finally:
            await sched.stop()
            await trainer.stop()

    run(main())


def test_failed_fit_requeues_the_snapshot(tmp_path, monkeypatch):
    """A fit that raises puts the consumed rows back in the spool."""
    async def main():
        trainer = Trainer(TrainerConfig(
            listen_ip="127.0.0.1", data_dir=str(tmp_path / "spool"),
            device="cpu"))
        await trainer.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", algorithm="ml",
            trainer_address=f"127.0.0.1:{trainer.port}"))
        try:
            _simulate_fanout(sched, n_pieces=20)

            def boom(*a, **k):
                raise MemoryError("out of device memory")

            monkeypatch.setattr(training, "train_gnn", boom)
            from dragonfly2_tpu_torch.trainer import pipeline
            monkeypatch.setattr(pipeline, "train_decision_model", boom)
            with pytest.raises(Exception):
                await sched.announcer.upload_once()
            spooled = trainer.storage.rows("download")
            assert len(spooled) == 41
            # the announcer requeued its side too (at-least-once)
            assert sched.service.records.piece_row_count() == 40
        finally:
            await sched.stop()
            await trainer.stop()

    run(main())


def test_upload_chunks_large_datasets(tmp_path):
    """A dataset past one chunk streams as several ``TrainRequest``s and
    lands whole in the trainer's spool."""
    async def main():
        trainer = Trainer(TrainerConfig(
            listen_ip="127.0.0.1", data_dir=str(tmp_path / "spool"),
            device="cpu"))
        await trainer.start()
        landed = []
        append = trainer.storage.append_chunk

        def spy(dataset, hostname, ip, chunk, **kw):
            landed.append((dataset, gzip.decompress(chunk)))
            return append(dataset, hostname, ip, chunk, **kw)

        trainer.storage.append_chunk = spy
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", algorithm="ml",
            trainer_address=f"127.0.0.1:{trainer.port}"))
        try:
            rng = np.random.default_rng(5)
            rows = [{"kind": "decision", "decision_id": f"d{i}",
                     "noise": rng.bytes(600).hex()} for i in range(2500)]
            for row in rows:
                sched.service.records.on_decision(row)
            assert await sched.announcer.upload_once()
            sizes = sched.announcer.last_upload["compressed_bytes"]
            assert sizes["download"] > 1 << 20       # more than one chunk
            ((dataset, text),) = landed
            assert dataset == "download"
            got = [json.loads(line) for line in text.splitlines()]
            assert [r["decision_id"] for r in got] == \
                [r["decision_id"] for r in rows]
            # no feature rows among them: the MLP fit was skipped
            assert features.MLP_MODEL_NAME not in trainer.service.latest
        finally:
            await sched.stop()
            await trainer.stop()

    run(main())


def test_learned_regret_beats_the_heuristic_on_average():
    """BENCH_pr19's claim, held on the recipe rather than one fit: one
    fit's replay regret on the 170 datagen folds moves with the last bit of
    the arithmetic (the reference's own fits beat the heuristic at 8 of the
    seeds 0-15), so the mean over seeds 0-15 is what must beat 0.1379."""
    import os

    from dragonfly2_tpu_torch.scheduler.decision_ledger import replay_regret
    from dragonfly2_tpu_torch.trainer import pipeline, serving

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "pr19_datagen_rows.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    regrets = []
    for seed in range(16):
        blob, _ = pipeline.train_decision_model(rows, seed=seed, device="cpu")
        ev = replay_regret(rows, ("default", "ml"),
                           serving.make_mlp_infer(blob))["evaluators"]
        assert ev["default"]["mean_regret"] == 0.1379
        regrets.append(ev["ml"]["mean_regret"])
    assert sum(regrets) / len(regrets) < 0.1379, regrets


def test_topology_store_matches_reference():
    """Probe EWMA and snapshot rows (the GNN's dataset) as the
    reference's store keeps them."""
    from dragonfly2_tpu.scheduler.topology_store import \
        TopologyStore as RefTopologyStore
    from dragonfly2_tpu_torch.scheduler.topology_store import TopologyStore

    rng = np.random.default_rng(11)
    ref, port = RefTopologyStore(), TopologyStore()
    for _ in range(500):
        a, b = (f"h{int(v)}" for v in rng.integers(0, 12, 2))
        rtt = int(rng.integers(5, 30000))
        ref.record(a, b, rtt)
        port.record(a, b, rtt)
    strip = [{k: v for k, v in r.items() if k != "updated_at"}
             for r in port.snapshot_rows()]
    assert strip == [{k: v for k, v in r.items() if k != "updated_at"}
                     for r in ref.snapshot_rows()]
    assert features.topology_to_graph(port.snapshot_rows()) is not None
