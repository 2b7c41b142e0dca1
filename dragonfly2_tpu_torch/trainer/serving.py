"""Model serving: turn a model blob into an ``infer`` callable.

Counterpart of ``dragonfly2_tpu/trainer/serving.py``, copied whole. The
evaluator scores a handful of candidates per ruling, thousands of times a
second, so the scheduler binds the fitted blob and scores in-process with a
pure-numpy forward pass on its own CPU (the card is for training only); the
trainer also exposes a ``ModelInfer`` RPC for parity and tests
(``trainer/service.py``).
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np

from . import features, params_io

log = logging.getLogger("df.trainer.serving")

Infer = Callable[[list[list[float]]], list[float]]


def _gelu(x: np.ndarray) -> np.ndarray:
    # tanh approximation, the form the trainer's models use
    return 0.5 * x * (1.0 + np.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))


def mlp_forward_np(params: dict, x: np.ndarray) -> np.ndarray:
    h = x.astype(np.float32)
    layers = params["layers"]
    for layer in layers[:-1]:
        h = _gelu(h @ layer["w"] + layer["b"])
    out = h @ layers[-1]["w"] + layers[-1]["b"]
    return out[..., 0]


def make_mlp_infer(model_bytes: bytes) -> Infer:
    """Deserialize a ``bandwidth_mlp`` blob into ``infer(rows) -> scores``.

    Raises ValueError when the blob must be refused at bind time — the
    scheduler must not score with it: undecodable bytes (garbage rollout),
    a feature-schema mismatch (model trained on a different layout), or
    non-finite weights (a diverged fit would NaN every ranking). The
    refresh loop catches the refusal, keeps the current evaluator on its
    heuristic floor, and remembers the refused version (same discipline as
    ``make_gnn_impute``'s stale-schema gate).
    """
    try:
        params, meta = params_io.deserialize_params(model_bytes)
    except Exception as exc:  # noqa: BLE001 - np.load raises zoo-of-errors
        raise ValueError(f"model blob undecodable: {exc}") from exc
    dim = int(meta.get("feature_dim", features.FEATURE_DIM))
    if dim != features.FEATURE_DIM:
        raise ValueError(
            f"model feature_dim {dim} != scheduler {features.FEATURE_DIM}")
    version = meta.get("version", params_io.version_of(model_bytes))
    # bind-time probe: one forward pass over a zero row. A model whose
    # weights went non-finite (NaN/Inf anywhere on the path) fails HERE,
    # once, instead of on every scheduling tick
    try:
        probe = mlp_forward_np(params, np.zeros((1, dim), np.float32))
    except Exception as exc:  # noqa: BLE001 - malformed layer shapes
        raise ValueError(f"model forward pass broken: {exc}") from exc
    if not np.all(np.isfinite(probe)):
        raise ValueError(
            f"model {version} emits non-finite scores — diverged fit "
            "refused at bind time; the heuristic floor keeps ruling")

    def infer(rows: list[list[float]]) -> list[float]:
        x = np.asarray(rows, np.float32)
        if x.ndim != 2 or x.shape[1] != dim:
            raise ValueError(f"expected [n, {dim}] features, got {x.shape}")
        return mlp_forward_np(params, x).tolist()

    infer.version = version          # type: ignore[attr-defined]
    infer.meta = meta                # type: ignore[attr-defined]
    return infer


# ------------------------------------------------------------------ GNN

def gnn_forward_np(params: dict, graph: dict) -> np.ndarray:
    """Numpy version of ``models.gnn_forward`` (same rationale as the MLP:
    the scheduler imputes in-process, no RPC and no torch on the hot
    path)."""
    nodes = graph["nodes"].astype(np.float32)
    edge_src = graph["edge_src"]
    edge_dst = graph["edge_dst"]
    edge_feat = graph["edge_feat"].astype(np.float32)
    mask = graph["edge_mask"].astype(np.float32)[:, None]
    n = nodes.shape[0]

    def dense(p, x):
        return x @ p["w"] + p["b"]

    h = _gelu(dense(params["encode"], nodes))
    for msg_p, upd_p in zip(params["msg"], params["upd"]):
        src_h = h[edge_src]
        dst_h = h[edge_dst]
        m = _gelu(dense(msg_p, np.concatenate(
            [src_h, dst_h, edge_feat], axis=-1))) * mask
        agg = np.zeros((n, m.shape[-1]), np.float32)
        np.add.at(agg, edge_dst, m)
        deg = np.zeros((n, 1), np.float32)
        np.add.at(deg, edge_dst, mask)
        agg = agg / np.maximum(deg, 1.0)
        h = _gelu(dense(upd_p, np.concatenate([h, agg], axis=-1)))
    # head scores every edge index from node embeddings only (query edges
    # ride with mask=0: excluded from aggregation, still scored)
    return dense(params["head"], np.concatenate(
        [h[edge_src], h[edge_dst]], axis=-1))[..., 0]


def make_gnn_impute(model_bytes: bytes):
    """Deserialize a ``topology_gnn`` blob into
    ``impute(topo_rows, pairs) -> {(src, dst): rtt_us}``.

    Query links are appended to the observed graph with ``edge_mask=0``:
    they contribute NOTHING to message passing (a fabricated edge must not
    perturb the embeddings that score it), but the head — which reads only
    the two node embeddings — still scores them; the score is inverted
    back to an RTT estimate (``features.topology_to_graph`` label
    transform; reference intent:
    ``scheduler/networktopology/network_topology.go:334`` Neighbours).
    """
    import math

    params, meta = params_io.deserialize_params(model_bytes)
    version = meta.get("version", params_io.version_of(model_bytes))
    # schema gate: a blob trained against an older NODE_FEATURES layout
    # (v1 had no pod_id column) would crash the evaluator hot path with
    # a shape error on the first imputation — refuse it HERE, at bind
    # time, so the refresh loop logs and keeps the current imputer (or
    # the static-locality fallback) until the trainer refits
    node_dim = int(params["encode"]["w"].shape[0])
    if node_dim != len(features.NODE_FEATURES):
        raise ValueError(
            f"topology_gnn node dim {node_dim} != schema "
            f"{len(features.NODE_FEATURES)} (feature schema "
            f"v{features.FEATURE_SCHEMA_VERSION}) — stale model refused; "
            "retrain against the current NODE_FEATURES")

    def impute(topo_rows: list[dict],
               pairs: list[tuple[str, str]]) -> dict[tuple[str, str], float]:
        if not topo_rows or not pairs:
            return {}
        graph = features.topology_to_graph(topo_rows)
        if graph is None:
            return {}
        index = {hid: i for i, hid in enumerate(graph["host_ids"].tolist())}
        known = [(s, d) for s, d in pairs if s in index and d in index]
        if not known:
            return {}
        # append query edges (numpy arrays: shape changes are free)
        q = len(known)
        graph = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                 for k, v in graph.items()}
        graph["edge_src"] = np.concatenate(
            [graph["edge_src"],
             np.asarray([index[s] for s, _ in known], np.int32)])
        graph["edge_dst"] = np.concatenate(
            [graph["edge_dst"],
             np.asarray([index[d] for _, d in known], np.int32)])
        graph["edge_feat"] = np.concatenate(
            [graph["edge_feat"], np.zeros((q, graph["edge_feat"].shape[1]),
                                          np.float32)])
        graph["edge_mask"] = np.concatenate(
            [graph["edge_mask"], np.zeros((q,), np.float32)])
        scores = gnn_forward_np(params, graph)[-q:]
        out: dict[tuple[str, str], float] = {}
        for (s, d), y in zip(known, scores):
            y = float(np.clip(y, 1e-3, 1.0))
            # invert the label transform: y = 1/(1+max(0, log10(rtt)-1))
            log_rtt = 1.0 + (1.0 / y - 1.0)
            out[(s, d)] = float(math.pow(10.0, min(log_rtt, 7.0)))
        return out

    impute.version = version         # type: ignore[attr-defined]
    impute.meta = meta               # type: ignore[attr-defined]
    return impute
