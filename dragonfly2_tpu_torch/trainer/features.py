"""Shared feature schema: scheduler records -> model tensors.

Counterpart of ``dragonfly2_tpu/trainer/features.py``, copied whole (it is
numpy only). The schema is the contract between three parties:

* ``scheduler/records.py`` writes rows with ``PARENT_FEATURES`` +
  ``label_from_cost`` labels at piece-report time;
* ``scheduler/evaluator_ml.py`` builds the identical row at scoring time;
* this module turns accumulated rows into dense numpy arrays for
  ``trainer/models.py`` (MLP) and topology snapshots into padded graph
  batches (GNN).
"""

from __future__ import annotations

import logging
import math

import numpy as np

_log = logging.getLogger("df.trainer.features")

# Feature layout for one (child, parent) candidate row. Any change here is
# a model-version bump: the scheduler refuses models whose feature_dim
# doesn't match (see trainer/training.py metadata).
# Registry names (numpy-only module so the scheduler can import them
# without importing torch)
MLP_MODEL_NAME = "bandwidth_mlp"
GNN_MODEL_NAME = "topology_gnn"

PARENT_FEATURES = (
    "piece_score",            # parent finished pieces / total
    "upload_success_ratio",   # parent host historical upload success
    "free_upload_score",      # free slots / limit on parent host
    "host_type_score",        # seed classes rank above normal peers
    "locality_score",         # LOCAL > ICI > DCN > WAN (tpu/topology.py)
    "finished_pieces",        # absolute piece count held by parent
    "concurrent_uploads",     # in-flight uploads on parent host
)
FEATURE_DIM = len(PARENT_FEATURES)

# Schema version, stamped into trained-model metadata so the scheduler
# refuses mismatched arrays. v2 (cross-pod federation): NODE_FEATURES
# grew ``pod_id`` and decision-outcome rows carry ``link_tier``/``pod``
# METADATA columns — PARENT_FEATURES (and therefore FEATURE_DIM and the
# committed BENCH_pr8 candidate rows) is deliberately UNCHANGED, so
# every logged v1 decision row still parses and replays byte-identically.
FEATURE_SCHEMA_VERSION = 2

# GNN graph schema: nodes = hosts, edges = probed (src, dst) links.
# ``pod_id`` is a dense integer the caller assigns per pod (e.g. index
# into the sorted pod list; -1 = no pod identity) — the GNN sees the
# federation boundary the scheduler routes by, so learned imputation can
# tell "slow because pod-crossing" from "slow because that host".
NODE_FEATURES = ("host_type", "upload_ratio", "upload_load", "slice_id",
                 "coord_x", "coord_y", "pod_id")
EDGE_FEATURES = ("log_rtt", "link_class")

# Pad edge lists to the next bucket: a graph's shapes change only on
# bucket growth (the reference's static shapes for XLA; kept so a port
# blob and a reference blob see the same padded batches).
_EDGE_BUCKETS = (32, 128, 512, 2048, 8192)
_NODE_BUCKETS = (16, 64, 256, 1024)


def label_from_cost(piece_length: int, cost_ms: float) -> float:
    """Observed goodness of a parent from one piece download.

    Bounded (0, 1]: log-throughput squashed so the MLP regresses a target
    in the same range as the rule-based score it replaces. 4 MiB in 40 ms
    (~100 MB/s) ≈ 0.62; 4 MiB in 4 ms (1 GB/s, ICI-class) ≈ 0.78; stalls
    (<1 MB/s) fall below 0.3.
    """
    mbps = (piece_length / 1e6) / (max(cost_ms, 0.1) / 1e3)
    return 1.0 / (1.0 + math.exp(-0.7 * (math.log10(max(mbps, 1e-3)) - 0.5)))


def records_to_arrays(rows: list[dict]) -> dict[str, np.ndarray] | None:
    """Download-record rows → {"x": [N, FEATURE_DIM] f32, "y": [N] f32}.

    Rows missing features (back-source records have no parent) are skipped.
    """
    xs, ys = [], []
    for row in rows:
        feats = row.get("features")
        label = row.get("label")
        if feats is None or label is None or len(feats) != FEATURE_DIM:
            continue
        xs.append(feats)
        ys.append(label)
    if not xs:
        return None
    return {"x": np.asarray(xs, np.float32), "y": np.asarray(ys, np.float32)}


def decision_outcome_rows(rows: list[dict]) -> list[dict]:
    """The decision-ledger join contract (scheduler/decision_ledger.py):
    fold ``kind=decision`` candidate rows with the ``kind=piece`` outcomes
    that joined back to them into trainer-ready rows.

    Each output row is one (decision, parent) pair that actually served:
    the candidate's scoring-time feature vector (``PARENT_FEATURES``
    layout, exactly what the ``ml`` evaluator would have seen), the mean
    observed ``label_from_cost`` label over the pieces it delivered, and
    the rank the live evaluator predicted. ``records_to_arrays``-
    compatible, so a learned parent-quality model trains on the precise
    rows the offline A/B (``dfbench --pr8``) judges it against — and the
    rank column is the supervision a learning-to-rank variant needs.
    """
    decisions: dict[str, dict] = {}
    for row in rows:
        if row.get("kind") == "decision" and row.get("decision_id"):
            decisions[row["decision_id"]] = row
    stats: dict[tuple, list] = {}
    for row in rows:
        if row.get("kind") != "piece" or not row.get("decision_id"):
            continue
        if row["decision_id"] not in decisions:
            continue
        key = (row["decision_id"], row.get("parent_peer_id", ""))
        agg = stats.setdefault(key, [0, 0.0])
        agg[0] += 1
        agg[1] += float(row.get("label") or 0.0)
    out: list[dict] = []
    for (did, parent_id), (n, label_sum) in stats.items():
        decision = decisions[did]
        cand = next((c for c in decision.get("candidates") or []
                     if c.get("peer_id") == parent_id), None)
        if cand is None or len(cand.get("features") or []) != FEATURE_DIM:
            continue
        out.append({
            "decision_id": did,
            "task_id": decision.get("task_id", ""),
            "peer_id": decision.get("peer_id", ""),
            "parent_peer_id": parent_id,
            "features": [float(v) for v in cand["features"]],
            "label": label_sum / n,
            "rank": cand.get("rank"),
            "pieces": n,
            # federation metadata (v2, defaults keep v1/BENCH_pr8 rows
            # parsing): which link tier the ruling chose and which pod
            # the child sat in — a learned evaluator can condition on
            # the DCN boundary without the feature array changing shape
            "link_tier": cand.get("link_tier", ""),
            "pod": (decision.get("federation") or {}).get("pod", ""),
        })
    return out


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _node_row(host_row: dict) -> list[float]:
    return [float(host_row.get("host_type", 0.5)),
            float(host_row.get("upload_ratio", 1.0)),
            float(host_row.get("upload_load", 0.0)),
            float(host_row.get("slice_id", -1)),
            float(host_row.get("coord_x", -1)),
            float(host_row.get("coord_y", -1)),
            float(host_row.get("pod_id", -1))]


def topology_to_graph(topo_rows: list[dict],
                      host_rows: dict[str, dict] | None = None
                      ) -> dict[str, np.ndarray] | None:
    """Topology snapshot rows → padded GNN batch.

    topo_rows: ``TopologyStore.snapshot_rows()`` dicts (src, dst,
    avg_rtt_us, count). host_rows: optional per-host feature dicts keyed by
    host id. Label = observed inverse log-RTT (bandwidth proxy) — the GNN
    learns to impute it for unprobed links.
    """
    if not topo_rows:
        return None
    ids: list[str] = []
    index: dict[str, int] = {}
    for row in topo_rows:
        for hid in (row["src"], row["dst"]):
            if hid not in index:
                index[hid] = len(ids)
                ids.append(hid)
    n_pad = _bucket(len(ids), _NODE_BUCKETS)
    if len(ids) > n_pad:
        # beyond the largest bucket: keep edges whose hosts fit, drop the
        # rest loudly (no silent caps)
        kept = [r for r in topo_rows
                if index[r["src"]] < n_pad and index[r["dst"]] < n_pad]
        _log.warning("topology graph truncated: %d hosts > bucket %d; "
                     "%d/%d edges kept", len(ids), n_pad, len(kept),
                     len(topo_rows))
        topo_rows = kept
        ids = ids[:n_pad]
    e_pad = _bucket(len(topo_rows), _EDGE_BUCKETS)
    if len(topo_rows) > e_pad:
        _log.warning("topology graph truncated: %d edges > bucket %d",
                     len(topo_rows), e_pad)
    nodes = np.zeros((n_pad, len(NODE_FEATURES)), np.float32)
    for hid, i in index.items():
        if i < n_pad:
            nodes[i] = _node_row((host_rows or {}).get(hid, {}))
    edge_src = np.zeros((e_pad,), np.int32)
    edge_dst = np.zeros((e_pad,), np.int32)
    edge_feat = np.zeros((e_pad, len(EDGE_FEATURES)), np.float32)
    edge_mask = np.zeros((e_pad,), np.float32)
    y = np.zeros((e_pad,), np.float32)
    for e, row in enumerate(topo_rows[:e_pad]):
        edge_src[e] = index[row["src"]]
        edge_dst[e] = index[row["dst"]]
        log_rtt = math.log10(max(float(row["avg_rtt_us"]), 1.0))
        edge_feat[e] = (log_rtt, float(row.get("link_class", 0.0)))
        edge_mask[e] = 1.0
        # bandwidth proxy: 10us (ICI) -> ~1.0, 10ms (DCN/WAN) -> ~0.2
        y[e] = 1.0 / (1.0 + max(0.0, log_rtt - 1.0))
    return {"nodes": nodes, "edge_src": edge_src, "edge_dst": edge_dst,
            "edge_feat": edge_feat, "edge_mask": edge_mask, "y": y,
            "host_ids": np.asarray(ids)}
