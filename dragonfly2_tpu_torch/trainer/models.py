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
reference's. The mesh half (``make_mesh``, ``shard_*``,
``sharded_train_step``) and ``synthetic_*_batch`` are not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # bf16 operands, f32 products and sum (reference _dense)
        return _bf16(x) @ _bf16(self.w) + self.b


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


def params_to_numpy(model: nn.Module) -> dict:
    """The reference's param pytree as numpy, keys in ``jax.tree_util``
    order (sorted): ``{"layers": [{"b", "w"}, ...]}`` or ``{"encode",
    "head", "msg": [...], "upd": [...]}``."""
    if isinstance(model, MLP):
        return {"layers": [_dense_np(layer) for layer in model.layers]}
    if isinstance(model, GNN):
        return {"encode": _dense_np(model.encode),
                "head": _dense_np(model.head),
                "msg": [_dense_np(p) for p in model.msg],
                "upd": [_dense_np(p) for p in model.upd]}
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
