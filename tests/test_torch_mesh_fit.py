"""The trainer's fits on the mesh, on the CPU.

``train_mlp`` and ``train_gnn`` take the mesh path when ``use_mesh`` is on
and more than one card is visible. Here the card count is patched to 4
and ``fit_on_mesh`` runs its ranks on the CPU (Gloo, dp=2, tp=2, one
torch thread each), so the whole path runs: the spawned ranks, the
sharded fit, rank 0's gathered params, the blob and ``devices``. Each
model is fitted twice, and once more through the trainer service's
default device (six 4-rank groups in all, each given a 120 s limit, so a
hung rendezvous fails its test): the mesh path must give the same blob
run to run at a fixed world size, because the rollout dedupes on the
version. It need not give the single-device blob: elements whose
gradient is below the bf16 rounding of the ranks' partial gradients may
step the other way (see ``test_torch_mesh.py``), and later steps carry
that on. So the mesh fit's first epoch loss is held to the single-device
fit's within 1e-3 relative, and its last (a few epochs on) within 1e-2.
"""

import asyncio
import functools
import gzip
import json

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.idl.messages import TrainRequest
from dragonfly2_tpu_torch.trainer import params_io, ranks, training
from dragonfly2_tpu_torch.trainer.service import TrainerService
from dragonfly2_tpu_torch.trainer.storage import TrainerStorage

WORLD = 4
RANKS_TIMEOUT_S = 120.0


def _mlp_rows(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        feats = rng.uniform(size=7)
        rows.append({"features": feats.tolist(),
                     "label": float(np.clip(feats[0] * 0.8 + 0.1, 0, 1))})
    return rows


def _topo_rows(seed: int, hosts: int, links: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"src": f"h{int(rng.integers(hosts))}",
             "dst": f"h{int(rng.integers(hosts))}",
             "avg_rtt_us": float(10 ** rng.uniform(1, 4)), "count": 1}
            for _ in range(links)]


FITS = {"mlp": (training.train_mlp, lambda: _mlp_rows(1, 150),
                {"epochs": 6, "batch_size": 64, "seed": 3}),
        "gnn": (training.train_gnn, lambda: _topo_rows(2, 20, 80),
                {"epochs": 5, "seed": 5})}


def _mesh_on_cpu(mp: pytest.MonkeyPatch) -> list:
    """WORLD visible cards, whose ranks ``fit_on_mesh`` runs on the CPU,
    each group under RANKS_TIMEOUT_S; returns the list its calls are
    logged in."""
    real = training.fit_on_mesh
    calls = []

    def on_cpu(kind, world, device_type, data, **kw):
        calls.append((kind, world, device_type))
        return real(kind, world, "cpu", data, **kw)

    mp.setattr(ranks, "run_ranks", functools.partial(
        ranks.run_ranks, timeout_s=RANKS_TIMEOUT_S))
    mp.setattr(ranks, "visible_cards", lambda: WORLD)
    mp.setattr(training, "resolve_device", lambda device: torch.device("cpu"))
    mp.setattr(training, "fit_on_mesh", on_cpu)
    return calls


@pytest.fixture(scope="module")
def mesh_fits():
    """Each model fitted twice through the mesh path (4 CPU ranks)."""
    mp = pytest.MonkeyPatch()
    calls = _mesh_on_cpu(mp)
    try:
        out = {name: [fit(rows(), **kw) for _ in range(2)]
               for name, (fit, rows, kw) in FITS.items()}
    finally:
        mp.undo()
    return out, calls


@pytest.mark.parametrize("name", ["mlp", "gnn"])
def test_mesh_fit_runs_on_every_card_and_repeats_its_blob(mesh_fits, name):
    out, calls = mesh_fits
    (blob_a, met_a), (blob_b, met_b) = out[name]
    assert calls.count((name, WORLD, "cuda")) == 2
    assert met_a["devices"] == met_b["devices"] == WORLD
    assert blob_a == blob_b
    assert met_a["version"] == met_b["version"]
    tree, meta = params_io.deserialize_params(blob_a)
    assert meta["devices"] == WORLD and meta["seed"] == FITS[name][2]["seed"]


@pytest.mark.parametrize("name", ["mlp", "gnn"])
def test_mesh_fit_loss_tracks_the_single_device_fit(mesh_fits, name):
    fit, rows, kw = FITS[name]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        blob, met = fit(rows(), device="cpu", **kw)
    finally:
        torch.set_num_threads(before)
    mesh_met = mesh_fits[0][name][0][1]
    assert met["devices"] == 1
    assert mesh_met["first_epoch_loss"] == pytest.approx(
        met["first_epoch_loss"], rel=1e-3)
    assert mesh_met["final_loss"] == pytest.approx(met["final_loss"],
                                                   rel=1e-2)


class _Registry:
    """A manager link that keeps what the service publishes."""

    def __init__(self):
        self.published = []

    async def create_model(self, req):
        self.published.append(req)


def _upload(dataset: str, rows: list[dict]) -> TrainRequest:
    text = "".join(json.dumps(r) + "\n" for r in rows)
    return TrainRequest(hostname="sched-1", ip="10.0.0.1", cluster_id=3,
                        dataset=dataset, chunk=gzip.compress(text.encode()),
                        done=True)


def test_service_fits_take_the_mesh_by_default(monkeypatch, tmp_path):
    """The trainer service's default device is an unnamed card, so with
    several visible its fits run on the mesh and publish its size."""
    calls = _mesh_on_cpu(monkeypatch)
    registry = _Registry()
    svc = TrainerService(TrainerStorage(str(tmp_path)), manager=registry)
    assert svc.device == torch.device("cpu")

    async def uploads():
        yield _upload("download", _mlp_rows(4, 40))
        yield _upload("networktopology", _topo_rows(6, 12, 40))

    resp = asyncio.run(svc.train(uploads(), None))
    assert resp.ok and resp.model_version
    assert calls == [("mlp", WORLD, "cuda"), ("gnn", WORLD, "cuda")]
    assert sorted(r.name for r in registry.published) == sorted(
        [training.MLP_MODEL_NAME, training.GNN_MODEL_NAME])
    for req in registry.published:
        assert req.metrics["devices"] == WORLD
        assert req.scheduler_cluster_id == 3
        assert params_io.deserialize_params(req.data)[1]["devices"] == WORLD


@pytest.mark.parametrize("device,use_mesh,cards,world", [
    (None, True, 8, 8), ("cuda", True, 8, 8), (None, False, 8, 1),
    ("cpu", True, 8, 1), ("cuda:1", True, 8, 1), (None, True, 1, 1),
    (None, True, 0, 1), (None, True, 3, 3), (None, True, 5, 4),
    ("cuda", True, 7, 6)])
def test_mesh_world(monkeypatch, device, use_mesh, cards, world):
    monkeypatch.setattr(ranks, "visible_cards", lambda: cards)
    assert training.mesh_world(device, use_mesh) == world
