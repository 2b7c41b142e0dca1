"""Torch models: MLP bandwidth predictor + host-graph GNN.

Counterpart of ``dragonfly2_tpu/trainer/models.py:25-160`` (init, forward,
losses, optimizer, train step). The numerics are the reference's:

* ``_dense`` multiplies bf16-rounded operands and keeps an f32 result
  (``dot_general(..., preferred_element_type=float32)``): here both
  operands are rounded to bf16 and multiplied as f32, which is exact per
  product, so the sum is the reference's f32 sum. A bf16 ``matmul`` would
  round the output too; TF32 is kept off (``training.fit_numerics``);
* GELU is the tanh form, ``jax.nn.gelu``'s default;
* AdamW with one parameter group decays every leaf, biases included, as
  ``optax.adamw(lr, weight_decay=1e-4)`` does;
* the GNN's gathers are ``index_select`` and its two segment sums
  ``index_add_`` over dim 0, both deterministic on CUDA under
  ``torch.use_deterministic_algorithms(True)``.

Parameters cross to and from the reference as the numpy form of its param
pytree (``params_to_numpy`` / ``params_from_numpy``), with the key order
``jax.tree_util`` gives (sorted), so a port blob's npz layout is the
reference's.

The mesh half (``make_mesh``, ``shard_params``, ``shard_batch``,
``sharded_train_step``; reference ``models.py:165-212``) runs one process
per rank (``trainer/ranks.py`` starts them) on a ``torch.distributed``
``DeviceMesh`` with axes ``("dp", "tp")``, split as the reference splits
its mesh. The layout is the reference's ``_param_spec``: a 2-D weight
shards its output dim over tp when that dim tiles evenly, biases and the
1-wide head replicate, the batch splits over dp. The step is the global
step, as the reference's jitted one: its loss and gradients are the
single-device step's on the whole batch, up to reduction order.

The collectives are explicit autograd functions, not DTensor. DTensor
has no sharding rule for the GNN's ``index_add_``, and one explicit path
serves both models. A tp-sharded ``Dense`` is Megatron's column-parallel
layer: its input enters with an identity that all-reduces the input's
gradient over tp (``_ToTP``), and its output columns are all-gathered
with a backward that keeps this rank's columns (``_GatherCols``).
``torch.distributed.nn.functional.all_gather`` would reduce-scatter the
output gradient instead, which counts a consumer replicated over tp tp
times. Gradients are summed over dp in one flat all-reduce per step. The
GNN's graph is held whole on every rank (its edges point at nodes any
rank may hold), and dp splits the loss's edges; the reference's GSPMD
keeps the same computation global.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# deterministic cuBLAS needs a fixed workspace, set before the process's
# first cuBLAS call; without it deterministic mode makes matmuls raise
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

MLP_FEATURES = 7          # scheduler/evaluator_ml.py feature row length
GNN_NODE_FEATURES = 7     # host features (features.NODE_FEATURES v2)
GNN_EDGE_FEATURES = 2     # log-rtt, link-class


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_in, n_out))
        self.b = nn.Parameter(torch.zeros(n_out))
        # (group, rank, size) of the tp axis once shard_params has cut
        # ``w`` to this rank's output columns; None while whole
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # bf16 operands, f32 products and sum (reference _dense)
        if self.tp is None:
            return _bf16(x) @ _bf16(self.w) + self.b
        x = _ToTP.apply(x, self.tp)
        return _GatherCols.apply(_bf16(x) @ _bf16(self.w), self.tp) + self.b


class MLP(nn.Module):
    def __init__(self, *, in_dim: int = MLP_FEATURES, hidden: int = 128,
                 depth: int = 2, out_dim: int = 1):
        super().__init__()
        dims = [in_dim] + [hidden] * depth + [out_dim]
        self.layers = nn.ModuleList(Dense(a, b)
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [batch, MLP_FEATURES] -> [batch] predicted goodness."""
        h = x.to(torch.float32)
        for layer in self.layers[:-1]:
            h = gelu(layer(h))
        return self.layers[-1](h)[..., 0]


class GNN(nn.Module):
    def __init__(self, *, node_dim: int = GNN_NODE_FEATURES,
                 edge_dim: int = GNN_EDGE_FEATURES, hidden: int = 128,
                 layers: int = 2):
        super().__init__()
        self.encode = Dense(node_dim, hidden)
        self.msg = nn.ModuleList(Dense(2 * hidden + edge_dim, hidden)
                                 for _ in range(layers))
        self.upd = nn.ModuleList(Dense(2 * hidden, hidden)
                                 for _ in range(layers))
        # the head reads node embeddings only: edge_feat carries the
        # observed log-RTT the label is computed from (no label leak)
        self.head = Dense(2 * hidden, 1)

    def forward(self, nodes: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor, edge_feat: torch.Tensor,
                edge_mask: torch.Tensor) -> torch.Tensor:
        """nodes [N, node_dim], edge_src/dst [E] int64, edge_feat
        [E, edge_dim], edge_mask [E] {0,1} -> [E] score for every edge
        index (masked query edges send no message but are scored)."""
        n = nodes.shape[0]
        h = gelu(self.encode(nodes))
        mask = edge_mask[:, None].to(torch.float32)
        deg = torch.zeros(n, 1, dtype=torch.float32, device=h.device)
        deg = deg.index_add(0, edge_dst, mask).clamp_min(1.0)
        for msg_p, upd_p in zip(self.msg, self.upd):
            src_h = h.index_select(0, edge_src)
            dst_h = h.index_select(0, edge_dst)
            m = gelu(msg_p(torch.cat([src_h, dst_h, edge_feat], -1))) * mask
            agg = torch.zeros(n, m.shape[-1], dtype=m.dtype, device=m.device)
            agg = agg.index_add(0, edge_dst, m) / deg
            h = gelu(upd_p(torch.cat([h, agg], -1)))
        return self.head(torch.cat([h.index_select(0, edge_src),
                                    h.index_select(0, edge_dst)], -1))[..., 0]


# ------------------------------------------------------------------ init

def _dense_init(layer: Dense, gen: torch.Generator) -> None:
    n_in = layer.w.shape[0]
    with torch.no_grad():
        layer.w.copy_(torch.randn(layer.w.shape, generator=gen)
                      * (2.0 / n_in) ** 0.5)
        layer.b.zero_()


def init_mlp(gen: torch.Generator, **dims) -> MLP:
    """He-normal weights from ``gen`` (a CPU generator, so the draw is the
    same whatever device the model moves to), zero biases."""
    model = MLP(**dims)
    for layer in model.layers:
        _dense_init(layer, gen)
    return model


def init_gnn(gen: torch.Generator, **dims) -> GNN:
    model = GNN(**dims)
    _dense_init(model.encode, gen)
    for msg_p, upd_p in zip(model.msg, model.upd):
        _dense_init(msg_p, gen)
        _dense_init(upd_p, gen)
    _dense_init(model.head, gen)
    return model


# ------------------------------------------------------------------ param trees

def _dense_np(layer: Dense) -> dict:
    return {"b": layer.b.detach().cpu().numpy().astype(np.float32),
            "w": layer.w.detach().cpu().numpy().astype(np.float32)}


def params_to_numpy(model: nn.Module, leaf=_dense_np) -> dict:
    """The reference's param pytree as numpy, keys in ``jax.tree_util``
    order (sorted): ``{"layers": [{"b", "w"}, ...]}`` or ``{"encode",
    "head", "msg": [...], "upd": [...]}``; ``leaf`` maps one ``Dense``."""
    if isinstance(model, MLP):
        return {"layers": [leaf(layer) for layer in model.layers]}
    if isinstance(model, GNN):
        return {"encode": leaf(model.encode),
                "head": leaf(model.head),
                "msg": [leaf(p) for p in model.msg],
                "upd": [leaf(p) for p in model.upd]}
    raise TypeError(f"not a trainer model: {type(model).__name__}")


def _load_dense(layer: Dense, leaf: dict) -> None:
    for name in ("w", "b"):
        arr = np.asarray(leaf[name], np.float32)
        param = getattr(layer, name)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"param {name} shape {arr.shape} != "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(arr.copy()))


def params_from_numpy(tree: dict) -> nn.Module:
    """A model (on the CPU) holding the numpy param tree of either package
    (``params_io.deserialize_params`` output, or the reference's params
    mapped through ``np.asarray``)."""
    if "layers" in tree:
        layers = tree["layers"]
        w0 = np.shape(layers[0]["w"])
        model = MLP(in_dim=w0[0], hidden=w0[1], depth=len(layers) - 1,
                    out_dim=np.shape(layers[-1]["w"])[1])
        for layer, leaf in zip(model.layers, layers):
            _load_dense(layer, leaf)
        return model
    if "encode" in tree:
        node_dim, hidden = np.shape(tree["encode"]["w"])
        edge_dim = np.shape(tree["msg"][0]["w"])[0] - 2 * hidden
        model = GNN(node_dim=node_dim, edge_dim=edge_dim, hidden=hidden,
                    layers=len(tree["msg"]))
        _load_dense(model.encode, tree["encode"])
        for i, (msg_p, upd_p) in enumerate(zip(model.msg, model.upd)):
            _load_dense(msg_p, tree["msg"][i])
            _load_dense(upd_p, tree["upd"][i])
        _load_dense(model.head, tree["head"])
        return model
    raise ValueError(f"unknown param tree with keys {sorted(tree)}")


# ------------------------------------------------------------------ training

def mlp_loss(model: MLP, batch: dict) -> torch.Tensor:
    pred = model(batch["x"])
    return torch.mean((pred - batch["y"]) ** 2)


def gnn_loss(model: GNN, batch: dict) -> torch.Tensor:
    pred = model(batch["nodes"], batch["edge_src"], batch["edge_dst"],
                 batch["edge_feat"], batch["edge_mask"])
    err = (pred - batch["y"]) ** 2 * batch["edge_mask"]
    return torch.sum(err) / torch.clamp_min(torch.sum(batch["edge_mask"]),
                                            1.0)


def make_optimizer(model: nn.Module, lr: float = 1e-3
                   ) -> torch.optim.Optimizer:
    """``optax.adamw(lr, weight_decay=1e-4)``: one group, every leaf
    decayed."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def make_train_step(loss_fn, optimizer: torch.optim.Optimizer):
    """(model, batch) -> loss before the update (the reference's step
    returns the loss its grads came from)."""

    def step(model: nn.Module, batch: dict) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# ------------------------------------------------------------------ sharding

class _ToTP(torch.autograd.Function):
    """Identity forward; the input's gradient summed over tp backward
    (each tp rank holds only its columns' share of it)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.tp[0])
        return grad, None


class _GatherCols(torch.autograd.Function):
    """All-gather the output columns over tp forward; this rank's columns
    of the gradient backward (every tp rank computes the same consumer)."""

    @staticmethod
    def forward(ctx, y, tp):
        group, rank, size = tp
        ctx.cols = (rank * y.shape[-1], (rank + 1) * y.shape[-1])
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.cols
        return grad[..., lo:hi].contiguous(), None


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(dp, tp) for ``n_devices``: dp takes half (at least 1), tp the
    residue (reference ``make_mesh``). dp * tp falls one short of an odd
    ``n_devices`` above 3: the mesh leaves the last device out."""
    dp = max(1, n_devices // 2)
    return dp, n_devices // dp


def make_mesh(n_devices: int | None = None, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` with axes ``("dp", "tp")`` over the ranks of the
    initialized process group (one rank per device; the group's size
    must be ``mesh_shape``'s dp * tp)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = n_devices or dist.get_world_size()
    return init_device_mesh(device_type, mesh_shape(n),
                            mesh_dim_names=("dp", "tp"))


def _param_spec(shape, tp: int) -> tuple:
    """The reference's ``PartitionSpec`` as a tuple: ``(None, "tp")`` for
    a weight matrix whose output dim tiles evenly over tp, ``()``
    (replicated) for biases, scalars and the 1-wide head."""
    if len(shape) == 2 and tp > 1 and shape[1] % tp == 0 \
            and shape[1] >= tp:
        return (None, "tp")
    return ()


def _tp(mesh) -> tuple:
    return (mesh.get_group("tp"), mesh.get_local_rank("tp"),
            mesh.size(1))


def _denses(model: nn.Module) -> list[Dense]:
    return [m for m in model.modules() if isinstance(m, Dense)]


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Cut each weight ``_param_spec`` shards to this rank's output
    columns, in place; call before the optimizer is made."""
    group, rank, size = tp = _tp(mesh)
    for layer in _denses(model):
        if _param_spec(tuple(layer.w.shape), size) != (None, "tp"):
            continue
        k = layer.w.shape[1] // size
        layer.w = nn.Parameter(
            layer.w.detach()[:, rank * k:(rank + 1) * k].contiguous())
        layer.tp = tp
    return model


def _dp_part(n: int, mesh) -> tuple[int, int]:
    """This rank's [lo, hi) of ``n`` rows over dp (``tensor_split``'s
    split: the first ``n % dp`` parts one row longer)."""
    dp, r = mesh.size(0), mesh.get_local_rank("dp")
    base, extra = divmod(n, dp)
    lo = r * base + min(r, extra)
    return lo, lo + base + (r < extra)


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's dp slice of every leaf with a leading dim (the
    reference's ``P("dp")``)."""
    out = {}
    for k, v in batch.items():
        if v.ndim >= 1:
            lo, hi = _dp_part(v.shape[0], mesh)
            v = v[lo:hi]
        out[k] = v
    return out


def _mlp_loss_part(model: MLP, batch: dict, mesh) -> torch.Tensor:
    """This rank's share of the whole batch's MSE: its rows' mean times
    their fraction of the batch (exactly the mean at dp = 1)."""
    local = shard_batch(batch, mesh)
    n = batch["y"].shape[0]
    return mlp_loss(model, local) * (local["y"].shape[0] / n)


def _gnn_loss_part(model: GNN, batch: dict, mesh) -> torch.Tensor:
    """The whole graph's forward; this rank's dp slice of the edges'
    masked squared error over the whole graph's mask count."""
    pred = model(batch["nodes"], batch["edge_src"], batch["edge_dst"],
                 batch["edge_feat"], batch["edge_mask"])
    lo, hi = _dp_part(pred.shape[0], mesh)
    mask = batch["edge_mask"]
    err = (pred[lo:hi] - batch["y"][lo:hi]) ** 2 * mask[lo:hi]
    return torch.sum(err) / torch.clamp_min(torch.sum(mask), 1.0)


_LOSS_PARTS = {mlp_loss: _mlp_loss_part, gnn_loss: _gnn_loss_part}


def sharded_train_step(loss_fn, optimizer: torch.optim.Optimizer, mesh):
    """(model, batch) -> the whole batch's loss before the update, for a
    model through ``shard_params``; ``batch`` is the whole batch on this
    rank's device (the step takes its dp slice)."""
    part_fn = _LOSS_PARTS[loss_fn]
    dp_group = mesh.get_group("dp")

    def step(model: nn.Module, batch: dict) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        part = part_fn(model, batch, mesh)
        part.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=dp_group)
        off = 0
        for p in params:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
            off += p.numel()
        optimizer.step()
        loss = part.detach().clone()
        dist.all_reduce(loss, group=dp_group)
        return loss

    return step


def gather_params(model: nn.Module, *, grads: bool = False) -> dict:
    """The whole numpy param tree (or its gradients) of a sharded model,
    every tp-sharded weight all-gathered over tp. Collective: every rank
    calls it, and each gets the whole tree."""
    def leaf(layer: Dense) -> dict:
        w, b = ((layer.w.grad, layer.b.grad) if grads
                else (layer.w.detach(), layer.b.detach()))
        if layer.tp is not None:
            group, _, size = layer.tp
            parts = [torch.empty_like(w) for _ in range(size)]
            dist.all_gather(parts, w.contiguous(), group=group)
            w = torch.cat(parts, 1)
        return {"b": b.cpu().numpy().astype(np.float32),
                "w": w.cpu().numpy().astype(np.float32)}
    return params_to_numpy(model, leaf=leaf)


# ------------------------------------------------------------------ synthetic data

def synthetic_mlp_batch(seed: int = 0, batch_size: int = 256) -> dict:
    """The reference's synthetic MLP batch (shapes, dtypes, label
    formula) from ``np.random.default_rng(seed)``: ``jax.random`` streams
    cannot be reproduced, so parity tests feed both packages this batch."""
    rng = np.random.default_rng(seed)
    x = rng.random((batch_size, MLP_FEATURES), dtype=np.float32)
    w = np.linspace(1.0, 0.2, MLP_FEATURES, dtype=np.float32)
    noise = rng.standard_normal(batch_size, dtype=np.float32)
    return {"x": x, "y": (x @ w + np.float32(0.05) * noise).astype(np.float32)}


def synthetic_gnn_batch(seed: int = 0, n_nodes: int = 32,
                        n_edges: int = 128) -> dict:
    """The reference's synthetic host graph, from numpy (see
    ``synthetic_mlp_batch``)."""
    rng = np.random.default_rng(seed)
    nodes = rng.random((n_nodes, GNN_NODE_FEATURES), dtype=np.float32)
    edge_src = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    edge_dst = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    edge_feat = rng.random((n_edges, GNN_EDGE_FEATURES), dtype=np.float32)
    y = (1.0 / (1.0 + edge_feat[:, 0])).astype(np.float32)
    return {"nodes": nodes, "edge_src": edge_src, "edge_dst": edge_dst,
            "edge_feat": edge_feat,
            "edge_mask": np.ones((n_edges,), np.float32), "y": y}


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``; index leaves as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        dtype = torch.int64 if t.dtype in (torch.int32, torch.int64) \
            else None
        out[k] = t.to(device=device, dtype=dtype)
    return out
