"""The port's trainer on the CPU, against the JAX package's.

Seeded numpy inputs go through both packages: the feature schema and the
blob format byte for byte, the models' forward passes and gradients on the
reference's ``init_mlp`` / ``init_gnn`` params carried across by
``params_from_numpy``, 600 optimizer steps against ``make_train_step`` +
optax, the seeded fits, the pipeline, and the learned-vs-heuristic replay
on the pinned datagen rows of ``BENCH_pr19.json``.

Tolerances. ``_dense`` rounds its operands to bf16. The f32 values that
are rounded differ between the packages in the last bit now and then
(another summation order in the matmul, another ``tanh``, another order
in the segment sums), and where such a value sits on a bf16 rounding
boundary the rounded operand moves by a whole bf16 step, 2**-8 of its
size. Whether a draw has such a value is luck: over seeds the largest
forward difference of the 512-row MLP ranged from 4e-6 to 1e-3, that of
the 32-node GNN from 6e-8 to 1.2e-3 (one moved node embedding reaches
every edge it touches). So the median element is held to 1e-5 and the
largest difference to one bf16 step of the output's scale (5e-3 at the
largest buckets). Gradients also flow back through bf16 casts: their
maximum is held to 1e-2 of the leaf's largest entry, and for the MLP
their median to 1e-5 of it.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.scheduler import decision_ledger as ref_ledger
from dragonfly2_tpu.tools.dfbench import run_bench
from dragonfly2_tpu.trainer import features as ref_features
from dragonfly2_tpu.trainer import models as ref_models
from dragonfly2_tpu.trainer import params_io as ref_params_io
from dragonfly2_tpu.trainer import pipeline as ref_pipeline
from dragonfly2_tpu.trainer import serving as ref_serving
from dragonfly2_tpu.trainer import training as ref_training
from dragonfly2_tpu_torch.scheduler import decision_ledger
from dragonfly2_tpu_torch.trainer import (features, models, params_io,
                                          pipeline, serving, training)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "pr19_datagen_rows.jsonl")
CPU = torch.device("cpu")
BF16_STEP = 2.0 ** -8
# BENCH_pr19.json: the heuristic's observed-bandwidth regret on these rows
HEURISTIC_REGRET = 0.1379


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These fits are small: one intra-op thread each keeps a test's time
    its own when the suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fixture_rows() -> list[dict]:
    with open(FIXTURE) as f:
        return [json.loads(line) for line in f]


def _host_tree(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


def _close_forward(got: np.ndarray, want: np.ndarray, max_abs=None) -> None:
    diff = np.abs(got - want)
    assert np.median(diff) <= 1e-5, np.median(diff)
    bound = BF16_STEP * np.abs(want).max() if max_abs is None else max_abs
    assert diff.max() <= bound, diff.max()


def _close_grads(model: torch.nn.Module, ref_grads: dict, *,
                 median: bool = True) -> None:
    flat = params_io._flatten(_host_tree(ref_grads))
    named = dict(model.named_parameters())
    assert len(flat) == len(named)
    for key, want in flat.items():
        got = named[key.replace("/", ".")].grad.numpy()
        scale = np.abs(want).max()
        rel = np.abs(got - want) / scale
        if median:
            assert np.median(rel) <= 1e-5, (key, np.median(rel))
        assert rel.max() <= 1e-2, (key, rel.max())


# ---------------------------------------------------------------- features

def _record_rows(rng, n: int) -> list[dict]:
    rows = []
    for i in range(n):
        r = rng.random()
        if r < 0.1:
            rows.append({"kind": "peer", "task_id": "t"})
        elif r < 0.15:
            rows.append({"kind": "piece", "features": [0.5] * 5,
                         "label": 0.3})
        else:
            rows.append({"kind": "piece",
                         "features": rng.uniform(0, 64, 7).tolist(),
                         "label": features.label_from_cost(
                             4 << 20, float(rng.uniform(1, 900)))})
    return rows


def test_schema_constants_match_reference():
    for name in ("MLP_MODEL_NAME", "GNN_MODEL_NAME", "PARENT_FEATURES",
                 "FEATURE_DIM", "FEATURE_SCHEMA_VERSION", "NODE_FEATURES",
                 "EDGE_FEATURES", "_EDGE_BUCKETS", "_NODE_BUCKETS"):
        assert getattr(features, name) == getattr(ref_features, name), name
    for size, cost in ((4 << 20, 4.0), (4 << 20, 40.0), (1 << 20, 0.0),
                       (64 << 20, 1e6), (0, 5.0)):
        assert features.label_from_cost(size, cost) == \
            ref_features.label_from_cost(size, cost)


def test_records_to_arrays_matches_reference():
    rows = _record_rows(np.random.default_rng(0), 400)
    got, want = features.records_to_arrays(rows), \
        ref_features.records_to_arrays(rows)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert features.records_to_arrays([{"kind": "peer"}]) is None


def _decision(did, cands, *, v1, pod="pod-a"):
    row = {"kind": "decision", "decision_id": did, "task_id": "t1",
           "peer_id": "c-" + did, "host_id": "h-" + did,
           "candidates": [], "chosen": [cands[0][0]]}
    for rank, (pid, feats) in enumerate(cands, 1):
        cand = {"peer_id": pid, "rank": rank, "features": feats}
        if not v1:
            cand["link_tier"] = "ici" if rank == 1 else "dcn"
        row["candidates"].append(cand)
    if not v1:
        row["federation"] = {"pod": pod}
    return row


@pytest.mark.parametrize("schema", ["v1", "v2", "mixed"])
def test_decision_outcome_rows_match_reference(schema):
    rng = np.random.default_rng({"v1": 1, "v2": 2, "mixed": 3}[schema])
    rows = []
    for d in range(30):
        v1 = schema == "v1" or (schema == "mixed" and d % 2 == 0)
        cands = [(f"p{d}-{k}", rng.uniform(0, 1, 7).tolist())
                 for k in range(3)]
        if d % 7 == 3:
            cands[1] = (cands[1][0], [0.1] * 6)      # wrong-dim: skipped
        rows.append(_decision(f"d{d:03d}", cands, v1=v1))
        for _ in range(int(rng.integers(0, 12))):
            pid = cands[int(rng.integers(3))][0]
            rows.append({"kind": "piece", "decision_id": f"d{d:03d}",
                         "parent_peer_id": pid,
                         "label": float(rng.uniform())})
    rows.append({"kind": "piece", "decision_id": "d-unknown",
                 "parent_peer_id": "x", "label": 1.0})
    got = features.decision_outcome_rows(rows)
    assert got == ref_features.decision_outcome_rows(rows)
    assert got and all(len(r["features"]) == 7 for r in got)


@pytest.mark.parametrize("hosts,links", [(40, 150), (300, 2500),
                                         (1100, 9000)])
def test_topology_to_graph_matches_reference(hosts, links):
    """Padding to the node/edge buckets, and truncation past the largest
    (1024 hosts, 8192 links) kept the reference's way."""
    rng = np.random.default_rng(hosts)
    ids = [f"host-{i}" for i in range(hosts)]
    rows = [{"src": ids[int(rng.integers(hosts))],
             "dst": ids[int(rng.integers(hosts))],
             "avg_rtt_us": float(rng.uniform(5, 50000)),
             "count": int(rng.integers(1, 9)),
             "link_class": float(rng.integers(0, 4))}
            for _ in range(links)]
    host_rows = {h: {"host_type": float(rng.uniform()),
                     "slice_id": int(rng.integers(4)),
                     "pod_id": int(rng.integers(2))} for h in ids[::3]}
    got = features.topology_to_graph(rows, host_rows)
    want = ref_features.topology_to_graph(rows, host_rows)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["nodes"].shape[0] == min(1024, got["nodes"].shape[0])
    assert features.topology_to_graph([]) is None


# ---------------------------------------------------------------- blobs

def test_serialize_params_bytes_match_reference():
    tree = _host_tree(ref_models.init_gnn(jax.random.PRNGKey(4)))
    meta = {"model": "topology_gnn", "seed": 4, "final_loss": 0.125}
    blob = params_io.serialize_params(tree, meta)
    assert blob == ref_params_io.serialize_params(tree, meta)
    assert params_io.version_of(blob) == ref_params_io.version_of(blob)
    back, back_meta = params_io.deserialize_params(blob)
    assert back_meta == meta
    # the port's own param tree has the reference's key order and layout
    port_blob = params_io.serialize_params(
        models.params_to_numpy(models.params_from_numpy(tree)), meta)
    assert port_blob == blob


def _mlp_rows(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        feats = rng.uniform(size=features.FEATURE_DIM)
        rows.append({"features": feats.tolist(),
                     "label": float(np.clip(feats[0] * 0.8 + 0.1, 0, 1))})
    return rows


def _topo_rows(seed: int, hosts: int, links: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"src": f"h{int(rng.integers(hosts))}",
             "dst": f"h{int(rng.integers(hosts))}",
             "avg_rtt_us": float(10 ** rng.uniform(1, 4)), "count": 1}
            for _ in range(links)]


def test_blobs_bind_in_both_packages():
    """A port blob binds in the reference's serving side and a reference
    blob in the port's, with the same scores; so do GNN blobs."""
    x = np.random.default_rng(9).uniform(size=(32, 7)).tolist()
    port_mlp, _ = training.train_mlp(_mlp_rows(1, 64), epochs=3,
                                     device=CPU)
    ref_mlp, _ = ref_training.train_mlp(_mlp_rows(1, 64), epochs=3,
                                        use_mesh=False)
    for blob in (port_mlp, ref_mlp):
        assert serving.make_mlp_infer(blob)(x) == \
            ref_serving.make_mlp_infer(blob)(x)
    topo = _topo_rows(2, 20, 80)
    pairs = [("h1", "h2"), ("h3", "h7"), ("h0", "h19")]
    port_gnn, _ = training.train_gnn(topo, epochs=3, device=CPU)
    ref_gnn, _ = ref_training.train_gnn(topo, epochs=3, use_mesh=False)
    for blob in (port_gnn, ref_gnn):
        got = serving.make_gnn_impute(blob)(topo, pairs)
        assert got and got == ref_serving.make_gnn_impute(blob)(topo, pairs)


# ---------------------------------------------------------------- models

def test_mlp_forward_and_grads_match_reference():
    rng = np.random.default_rng(0)
    params = _host_tree(ref_models.init_mlp(jax.random.PRNGKey(0)))
    x = rng.uniform(size=(512, 7)).astype(np.float32)
    y = rng.uniform(size=(512,)).astype(np.float32)
    ref_loss, ref_grads = jax.value_and_grad(ref_models.mlp_loss)(
        params, {"x": x, "y": y})
    model = models.params_from_numpy(params)
    _close_forward(model(torch.from_numpy(x)).detach().numpy(),
                   np.asarray(ref_models.mlp_forward(params, x)))
    loss = models.mlp_loss(model, {"x": torch.from_numpy(x),
                                   "y": torch.from_numpy(y)})
    loss.backward()
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss)
    _close_grads(model, ref_grads)


def _graph(seed: int, n: int, e: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"nodes": rng.uniform(size=(n, 7)).astype(np.float32),
            "edge_src": rng.integers(0, n, e).astype(np.int32),
            "edge_dst": rng.integers(0, n, e).astype(np.int32),
            "edge_feat": rng.uniform(size=(e, 2)).astype(np.float32),
            "edge_mask": (rng.uniform(size=e) < 0.9).astype(np.float32),
            "y": rng.uniform(size=e).astype(np.float32)}


@pytest.mark.parametrize("n,e", [(32, 128), (1024, 8192)])
def test_gnn_forward_and_grads_match_reference(n, e):
    graph = _graph(n, n, e)
    params = _host_tree(ref_models.init_gnn(jax.random.PRNGKey(1)))
    want = np.asarray(ref_models.gnn_forward(
        params, graph["nodes"], graph["edge_src"], graph["edge_dst"],
        graph["edge_feat"], graph["edge_mask"]))
    ref_loss, ref_grads = jax.value_and_grad(ref_models.gnn_loss)(
        params, graph)
    model = models.params_from_numpy(params)
    batch = training.graph_batch(graph, CPU)
    got = model(batch["nodes"], batch["edge_src"], batch["edge_dst"],
                batch["edge_feat"], batch["edge_mask"]).detach().numpy()
    # at the largest buckets: 2 message-passing layers of 8192 edges
    _close_forward(got, want, max_abs=None if n == 32 else 5e-3)
    loss = models.gnn_loss(model, batch)
    loss.backward()
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * float(ref_loss)
    # message passing spreads one moved cotangent over a node's edges, so
    # the GNN's gradients are held by their maximum only
    _close_grads(model, ref_grads, median=False)


def test_600_adamw_steps_track_optax():
    """The port's train step (AdamW) against ``make_train_step`` + optax
    from the same params over the same 600 batches."""
    rng = np.random.default_rng(6)
    params = _host_tree(ref_models.init_mlp(jax.random.PRNGKey(6)))
    w = np.linspace(1.0, 0.2, 7).astype(np.float32)
    batches = []
    for _ in range(8):
        x = rng.uniform(size=(128, 7)).astype(np.float32)
        batches.append({"x": x, "y": (x @ w + 0.05 * rng.normal(
            size=128)).astype(np.float32)})
    opt = ref_models.make_optimizer()
    step = jax.jit(ref_models.make_train_step(ref_models.mlp_loss, opt))
    ref_p, opt_state = params, opt.init(params)
    model = models.params_from_numpy(params)
    port_step = models.make_train_step(models.mlp_loss,
                                       models.make_optimizer(model))
    losses = []
    for i in range(600):
        b = batches[i % len(batches)]
        ref_p, opt_state, ref_loss = step(ref_p, opt_state, b)
        loss = port_step(model, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
        losses.append((float(loss), float(ref_loss)))
    assert losses[-1][1] < 0.05 * losses[0][1]          # it learned
    assert abs(losses[-1][0] - losses[-1][1]) <= 0.01 * losses[-1][1]


# ---------------------------------------------------------------- fits

def _meta(blob: bytes) -> dict:
    return params_io.deserialize_params(blob)[1]


def test_train_mlp_is_deterministic_and_learns():
    rows = _mlp_rows(3, 700)
    a = training.train_mlp(rows, epochs=6, device=CPU)
    b = training.train_mlp(rows, epochs=6, device=CPU)
    assert a[0] == b[0] and a[1]["version"] == b[1]["version"]
    assert a[1]["final_loss"] < a[1]["first_epoch_loss"]
    ref_blob, ref_metrics = ref_training.train_mlp(rows, epochs=2,
                                                   use_mesh=False)
    assert list(_meta(a[0])) == list(_meta(ref_blob))
    assert a[1].keys() == ref_metrics.keys()
    assert _meta(a[0])["devices"] == 1 and a[1]["rows"] == 700
    infer = serving.make_mlp_infer(a[0])
    hi = [1.0] + [0.5] * 6
    lo = [0.0] + [0.5] * 6
    assert infer([hi])[0] > infer([lo])[0]
    assert training.train_mlp([], device=CPU) is None


def test_train_gnn_is_deterministic_and_learns():
    topo = _topo_rows(4, 60, 400)
    a = training.train_gnn(topo, epochs=30, device=CPU)
    b = training.train_gnn(topo, epochs=30, device=CPU)
    assert a[0] == b[0]
    assert a[1]["final_loss"] < a[1]["first_epoch_loss"]
    ref_blob, ref_metrics = ref_training.train_gnn(topo, epochs=2,
                                                   use_mesh=False)
    assert list(_meta(a[0])) == list(_meta(ref_blob))
    assert a[1].keys() == ref_metrics.keys()
    assert training.train_gnn(topo[:2], device=CPU) is None


def test_fits_restore_the_process_numerics():
    det = torch.are_deterministic_algorithms_enabled()
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with training.fit_numerics():
            assert torch.are_deterministic_algorithms_enabled()
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.are_deterministic_algorithms_enabled() == det
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prec)


def test_fits_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.train_mlp(_mlp_rows(0, 64), epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.train_gnn(_topo_rows(0, 8, 20), epochs=1, device="cuda")


# ---------------------------------------------------------------- pipeline

def _write_jsonl(path, rows, tail: str = "") -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write(tail)


def test_load_records_jsonl_order_and_torn_tail(tmp_path):
    old = [{"kind": "decision", "decision_id": f"d{i}"} for i in range(3)]
    new = [{"kind": "piece", "decision_id": f"d{i}"} for i in range(4)]
    _write_jsonl(tmp_path / "download.jsonl.1", old)
    _write_jsonl(tmp_path / "download.jsonl", new, tail='{"kind": "pie')
    got = pipeline.load_records_jsonl(str(tmp_path))
    assert got == old + new
    assert got == ref_pipeline.load_records_jsonl(str(tmp_path))
    assert pipeline.load_records_jsonl(
        str(tmp_path / "download.jsonl")) == new
    with pytest.raises(FileNotFoundError):
        pipeline.load_records_jsonl(str(tmp_path / "nothing-here"))


def test_training_rows_and_the_piece_row_fallback():
    rows = _fixture_rows()
    folded, source = pipeline.training_rows(rows)
    assert (folded, source) == ref_pipeline.training_rows(rows)
    assert source == "decision_outcomes" and len(folded) == 170
    # too few joined decisions: the fit falls back to raw piece rows
    few = [r for r in rows if r["kind"] == "decision"][:1] + [
        r for r in rows if r["kind"] == "piece"][:60]
    assert len(pipeline.training_rows(few)[0]) < pipeline.MIN_TRAIN_ROWS
    blob, metrics = pipeline.train_decision_model(few, seed=1, epochs=3,
                                                  device=CPU)
    assert metrics["supervision"] == "piece_rows"
    assert metrics["record_rows"] == 61 and metrics["rows"] == 60
    assert pipeline.train_decision_model(few[:1], device=CPU) is None
    assert pipeline.DEFAULT_EPOCHS == ref_pipeline.DEFAULT_EPOCHS == 600


def _cli(*args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.trainer.pipeline",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


def test_pipeline_cli_exit_codes(tmp_path):
    out = tmp_path / "mlp.npz"
    ok = _cli("--records", FIXTURE, "--out", str(out), "--seed", "7",
              "--epochs", "20", "--device", "cpu", "--json")
    assert ok.returncode == 0, ok.stderr
    metrics = json.loads(ok.stdout)
    assert metrics["supervision"] == "decision_outcomes"
    assert params_io.version_of(out.read_bytes()) == metrics["version"]
    missing = _cli("--records", str(tmp_path / "none.jsonl"),
                   "--device", "cpu")
    assert missing.returncode == 1 and "FileNotFoundError" in missing.stderr
    _write_jsonl(tmp_path / "few.jsonl", [{"kind": "peer"}])
    few = _cli("--records", str(tmp_path / "few.jsonl"), "--device", "cpu")
    assert few.returncode == 1 and "too few" in few.stderr


# ---------------------------------------------------------------- fixture

def test_fixture_is_the_reference_datagen_run():
    gen = run_bench(seed=7, daemons=8, pieces=64, piece_size=4 << 20,
                    parallelism=4, collect_decisions=True,
                    collect_outcomes=True)
    rows = _fixture_rows()
    assert len(gen["decisions"]) == 64 and len(gen["outcomes"]) == 512
    assert rows == json.loads(json.dumps(gen["decisions"] +
                                         gen["outcomes"]))


def test_replay_on_the_fixture_matches_reference():
    rows = _fixture_rows()
    decisions = [r for r in rows if r["kind"] == "decision"]
    infer = ref_ledger.standin_ml_infer
    for evaluators in (("default", "ml"), ("default", "nt", "ml")):
        assert decision_ledger.replay_decisions(
            decisions, evaluators, infer) == ref_ledger.replay_decisions(
                decisions, evaluators, infer)
    got = decision_ledger.replay_regret(rows, ("default", "ml"), infer)
    assert got == ref_ledger.replay_regret(rows, ("default", "ml"), infer)
    assert got["evaluators"]["default"]["mean_regret"] == HEURISTIC_REGRET
    assert decision_ledger.stitch_outcomes(rows) == \
        ref_ledger.stitch_outcomes(rows)


def test_port_trained_mlp_beats_the_heuristic_on_the_fixture():
    rows = _fixture_rows()
    blob, metrics = pipeline.train_decision_model(rows, seed=7, device=CPU)
    again, _ = pipeline.train_decision_model(rows, seed=7, device=CPU)
    assert blob == again
    assert metrics["supervision"] == "decision_outcomes"
    assert metrics["rows"] == 170
    infer = serving.make_mlp_infer(blob)
    regret = decision_ledger.replay_regret(rows, ("default", "ml"), infer)
    ev = regret["evaluators"]
    assert ev["default"]["mean_regret"] == HEURISTIC_REGRET
    assert ev["ml"]["mean_regret"] < ev["default"]["mean_regret"]
    # the reference's replay judges the port's model the same way
    assert regret == ref_ledger.replay_regret(rows, ("default", "ml"), infer)
    replay = decision_ledger.replay_decisions(rows, ("default", "ml"), infer)
    assert replay["logged_choice_agreement"]["default"] == 1.0
