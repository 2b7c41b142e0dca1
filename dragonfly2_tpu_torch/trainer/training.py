"""Training runs: fit the MLP/GNN on uploaded scheduler records.

Counterpart of ``dragonfly2_tpu/trainer/training.py``: minibatch AdamW
over ``models.make_train_step`` on one explicit device (default: the first
CUDA card; the CPU only when named), with npz serialization and
content-addressed versioning. With ``use_mesh`` (the default) and more
than one visible card, the fit runs on every card instead: one rank each
(``ranks.run_ranks``), batch dp-sharded and weights tp-sharded
(``models.sharded_train_step``), rank 0's gathered params serialized.
The blob's ``devices`` meta is the reference's ``len(jax.devices())``:
every visible device of the fit's type, whatever the mesh (5 cards give
a world of 4 and ``devices`` 5); the world goes into the log line only.

Same (rows, seed) gives the same blob bytes, hence the same
``version_of``: the rollout path dedupes on it. The fit therefore runs
under ``fit_numerics`` (deterministic algorithms, full-f32 matmuls), the
data order is ``np.random.default_rng(seed)``'s as in the reference, and
wall time and version stay out of the serialized meta. The initial weights
come from ``torch.Generator().manual_seed(seed)``: torch cannot draw
``jax.random``'s numbers, so a port blob's version differs from the
reference's for the same seed.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

import numpy as np
import torch

from ..tpu.mesh import cuda_devices
from . import features, models, ranks
from .params_io import serialize_params, version_of

log = logging.getLogger("df.trainer.training")

MLP_MODEL_NAME = features.MLP_MODEL_NAME
GNN_MODEL_NAME = features.GNN_MODEL_NAME

# the flags fit_numerics sets are process-wide; fits hold this lock so a
# fit finishing in one thread cannot restore them under another's
_NUMERICS_LOCK = threading.Lock()


@contextlib.contextmanager
def fit_numerics():
    """Deterministic algorithms and full-f32 matmuls (no TF32) for one fit,
    with the process's previous settings restored afterwards."""
    with _NUMERICS_LOCK:
        det = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        precision = torch.get_float32_matmul_precision()
        torch.use_deterministic_algorithms(True)
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(det, warn_only=warn_only)
            torch.set_float32_matmul_precision(precision)


def resolve_device(device) -> torch.device:
    """``None`` or ``"cuda"`` = the first CUDA card (raises when there is
    none); anything else names a device."""
    if device is None or device == "cuda":
        return cuda_devices()[0]
    return torch.device(device)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _finish(tree: dict, metrics: dict, t0: float) -> tuple[bytes, dict]:
    data_bytes = serialize_params(tree, metrics)
    # version + wall clock ride in the RETURNED metrics only: the
    # serialized meta is a function of (rows, seed) alone
    metrics["version"] = version_of(data_bytes)
    metrics["train_seconds"] = time.monotonic() - t0
    return data_bytes, metrics


def mesh_world(device, use_mesh: bool) -> int:
    """Ranks a fit runs on: the mesh's dp * tp over the visible cards
    when ``use_mesh`` and the caller named no single device (``None`` or
    ``"cuda"``), else 1."""
    if not use_mesh or (device is not None and str(device) != "cuda"):
        return 1
    dp, tp = models.mesh_shape(max(ranks.visible_cards(), 1))
    return dp * tp


def visible_devices(device) -> int:
    """A fit's ``devices`` meta, the reference's ``len(jax.devices())``:
    every visible device of the fit's type, whatever its mesh. The
    visible cards, or 1 for a fit the caller put on the CPU."""
    if device is not None and str(device).startswith("cpu"):
        return 1
    return max(ranks.visible_cards(), 1)


def _fit_mlp(data: dict, *, epochs: int, batch_size: int, lr: float,
             seed: int, dev: torch.device, mesh=None):
    """The MLP's fit loop; with ``mesh``, this rank's share of the
    sharded fit. Returns (model, first epoch's loss, last epoch's)."""
    n = data["x"].shape[0]
    rng = np.random.default_rng(seed)
    bs = min(batch_size, n)
    # static batch shape: pad the epoch to a multiple of bs via wraparound
    steps_per_epoch = max(1, n // bs)
    first_loss = last_loss = None
    model = models.init_mlp(_generator(seed)).to(dev)
    if mesh is None:
        step = models.make_train_step(models.mlp_loss,
                                      models.make_optimizer(model, lr))
    else:
        models.shard_params(model, mesh)
        step = models.sharded_train_step(
            models.mlp_loss, models.make_optimizer(model, lr), mesh)
    # the rows go to the device once; each epoch uploads its batch
    # indices (the reference's order) and the steps index on the device
    x = torch.from_numpy(data["x"]).to(dev)
    y = torch.from_numpy(data["y"]).to(dev)
    for _ in range(epochs):
        order = rng.permutation(n)
        idx = np.empty((steps_per_epoch, bs), np.int64)
        for s in range(steps_per_epoch):
            part = order[(s * bs) % n:(s * bs) % n + bs]
            if part.size < bs:
                part = np.concatenate([part, order[:bs - part.size]])
            idx[s] = part
        idx_dev = torch.from_numpy(idx).to(dev)
        for s in range(steps_per_epoch):
            batch = {"x": x.index_select(0, idx_dev[s]),
                     "y": y.index_select(0, idx_dev[s])}
            loss = step(model, batch)
        loss_f = float(loss)
        if first_loss is None:
            first_loss = loss_f
        last_loss = loss_f
    return model, first_loss, last_loss


def _fit_gnn(batch: dict, *, epochs: int, lr: float, seed: int,
             dev: torch.device, mesh=None):
    """The GNN's fit loop over one graph batch on ``dev``; with ``mesh``,
    this rank's share of the sharded fit."""
    first_loss = last_loss = None
    model = models.init_gnn(_generator(seed)).to(dev)
    if mesh is None:
        step = models.make_train_step(models.gnn_loss,
                                      models.make_optimizer(model, lr))
    else:
        models.shard_params(model, mesh)
        step = models.sharded_train_step(
            models.gnn_loss, models.make_optimizer(model, lr), mesh)
    for _ in range(epochs):
        loss_f = float(step(model, batch))
        if first_loss is None:
            first_loss = loss_f
        last_loss = loss_f
    return model, first_loss, last_loss


def _fit_rank(mesh, device: torch.device, kind: str, data: dict,
              kw: dict) -> dict:
    """One rank of a sharded fit (``ranks.run_ranks`` target)."""
    with fit_numerics():
        if kind == "mlp":
            model, first, last = _fit_mlp(data, dev=device, mesh=mesh, **kw)
        else:
            model, first, last = _fit_gnn(graph_batch(data, device),
                                          dev=device, mesh=mesh, **kw)
    return {"tree": models.gather_params(model), "first": first,
            "last": last}


def fit_on_mesh(kind: str, world: int, device_type: str, data: dict,
                **kw) -> tuple[dict, float, float]:
    """The ``kind`` ("mlp" on ``records_to_arrays`` output, "gnn" on a
    ``topology_to_graph`` graph) fit on ``world`` ranks; (whole numpy
    param tree, first epoch's loss, last epoch's)."""
    out = ranks.run_ranks(world, device_type, _fit_rank, kind, data, kw)
    return out["tree"], out["first"], out["last"]


def train_mlp(rows: list[dict], *, epochs: int = 40, batch_size: int = 512,
              lr: float = 1e-3, seed: int = 0, use_mesh: bool = True,
              device=None) -> tuple[bytes, dict] | None:
    """Fit the parent-goodness MLP on download-record rows.

    Returns (model_bytes, metrics) or None when the rows hold no usable
    feature/label pairs. Batch dp-sharded and weights tp-sharded over
    every visible card when there is more than one (``mesh_world``)."""
    dev = resolve_device(device)
    data = features.records_to_arrays(rows)
    if data is None or data["x"].shape[0] < 8:
        return None
    n = data["x"].shape[0]
    world = mesh_world(device, use_mesh)
    kw = {"epochs": epochs, "batch_size": batch_size, "lr": lr,
          "seed": seed}
    t0 = time.monotonic()
    if world > 1:
        tree, first_loss, last_loss = fit_on_mesh("mlp", world, "cuda",
                                                  data, **kw)
    else:
        with fit_numerics():
            model, first_loss, last_loss = _fit_mlp(data, dev=dev, **kw)
        tree = models.params_to_numpy(model)
    metrics = {
        "model": MLP_MODEL_NAME,
        "rows": int(n),
        "epochs": epochs,
        "seed": int(seed),
        "first_epoch_loss": first_loss,
        "final_loss": last_loss,
        "feature_dim": features.FEATURE_DIM,
        "feature_names": list(features.PARENT_FEATURES),
        "schema_version": features.FEATURE_SCHEMA_VERSION,
        "devices": visible_devices(device),
    }
    blob, metrics = _finish(tree, metrics, t0)
    log.info("mlp fit: rows=%d loss %.4f -> %.4f (%.1fs on %s, %d ranks)",
             n, first_loss, last_loss, metrics["train_seconds"], dev, world)
    return blob, metrics


def graph_batch(graph: dict, device: torch.device) -> dict:
    """A ``features.topology_to_graph`` batch as tensors on ``device``."""
    out = {}
    for k, v in graph.items():
        if k == "host_ids":
            continue
        dtype = torch.int64 if k in ("edge_src", "edge_dst") else None
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(device=device, dtype=dtype)
    return out


def train_gnn(topo_rows: list[dict], *, epochs: int = 60, lr: float = 1e-3,
              seed: int = 0, use_mesh: bool = True, device=None
              ) -> tuple[bytes, dict] | None:
    """Fit the host-graph GNN on topology snapshot rows (bandwidth
    imputation for unprobed links); on every visible card when there is
    more than one, the graph whole on each (``mesh_world``)."""
    dev = resolve_device(device)
    graph = features.topology_to_graph(topo_rows)
    if graph is None or float(graph["edge_mask"].sum()) < 4:
        return None
    world = mesh_world(device, use_mesh)
    kw = {"epochs": epochs, "lr": lr, "seed": seed}
    t0 = time.monotonic()
    if world > 1:
        tree, first_loss, last_loss = fit_on_mesh("gnn", world, "cuda",
                                                  graph, **kw)
    else:
        with fit_numerics():
            model, first_loss, last_loss = _fit_gnn(
                graph_batch(graph, dev), dev=dev, **kw)
        tree = models.params_to_numpy(model)
    metrics = {
        "model": GNN_MODEL_NAME,
        "edges": int(graph["edge_mask"].sum()),
        "nodes": int(len(graph["host_ids"])),
        "node_features": list(features.NODE_FEATURES),
        "schema_version": features.FEATURE_SCHEMA_VERSION,
        "epochs": epochs,
        "seed": int(seed),
        "first_epoch_loss": first_loss,
        "final_loss": last_loss,
        "devices": visible_devices(device),
    }
    blob, metrics = _finish(tree, metrics, t0)
    log.info("gnn fit: edges=%d loss %.4f -> %.4f (%.1fs on %s, %d ranks)",
             metrics["edges"], first_loss, last_loss,
             metrics["train_seconds"], dev, world)
    return blob, metrics
