"""Trainer RPC service: dataset sink + training kick + parity inference.

Counterpart of ``dragonfly2_tpu/trainer/service.py`` (reference
``trainer/service/service_v1.go:59-162``): the ``Train`` client-stream
receives gzip'd datasets keyed by (hostname, ip), lands them in
``trainer/storage``, and on stream close fits the models
(``trainer/pipeline.py`` for the MLP, ``trainer/training.py`` for the
GNN) on the service's device or mesh, in a worker thread, and publishes each
fitted model to the manager's model registry (``CreateModel``) when the
service has a manager link; the latest fit of each model also stays in
``latest``.

``ModelInfer`` serves the latest fitted MLP for parity with the
reference's Triton client surface; schedulers bind the blob and score
in-process instead (``trainer/serving.py``).
"""

from __future__ import annotations

import asyncio
import logging

from ..common.errors import Code, DFError
from ..common.metrics import REGISTRY
from ..idl.messages import (CreateModelRequest, ModelInferRequest,
                            ModelInferResponse, TrainResponse)
from ..rpc.server import ServiceDef
from . import pipeline, serving, training
from .storage import TrainerStorage

log = logging.getLogger("df.trainer.service")

TRAINER_SERVICE = "df.trainer.Trainer"

_fits_total = REGISTRY.counter(
    "df_trainer_fits_total",
    "training runs per model by outcome (fitted = a new version produced, "
    "skipped = snapshot below the usable-row floor)", ("model", "result"))
_fit_rows = REGISTRY.gauge(
    "df_trainer_fit_rows",
    "rows consumed by the most recent fit, per model", ("model",))
_fit_seconds = REGISTRY.gauge(
    "df_trainer_fit_seconds",
    "wall time of the most recent fit, per model", ("model",))


class TrainerService:
    def __init__(self, storage: TrainerStorage, *, device=None,
                 manager=None, min_rows: int = 32):
        """``device``: where fits run (default: every visible CUDA card,
        one when there is one; raises here when there is none). A fit gets
        ``device`` as given, so an unnamed card (None or ``"cuda"``) lets
        it take the mesh (``training.mesh_world``); ``self.device`` is the
        resolved first card. ``manager``: a ManagerLink fitted models are
        published through; None keeps them local. ``min_rows``: the
        download spool's floor before an MLP fit (no fit on noise)."""
        self.storage = storage
        self.min_rows = min_rows
        self.device = training.resolve_device(device)
        self._fit_device = device
        self.manager = manager
        self.latest: dict[str, tuple[bytes, dict]] = {}   # name -> (blob, metrics)
        self._infer_cache: dict[str, object] = {}         # name -> callable
        self._spool_lock = asyncio.Lock()        # guards spool append/snapshot
        self._fit_lock = asyncio.Lock()          # serializes model fitting
        self._spool_clusters: set[int] = set()   # clusters feeding the spool

    # -- Train (client-stream) -----------------------------------------

    async def train(self, request_iter, context) -> TrainResponse:
        # one gzip stream per dataset may span many chunks — buffer until
        # the stream ends, then decompress whole (a sliced gzip stream is
        # not independently decompressible)
        bufs: dict[str, bytearray] = {}
        uploader = ("", "")
        cluster_id = 0
        async for req in request_iter:
            if not req.dataset:
                raise DFError(Code.INVALID_ARGUMENT, "dataset required")
            uploader = (req.hostname, req.ip)
            cluster_id = req.cluster_id or cluster_id
            if req.chunk:
                bufs.setdefault(req.dataset, bytearray()).extend(req.chunk)
        # spool-append and the training snapshot share one lock, but the
        # fit runs outside it: other schedulers' uploads are not parked
        # behind a training run
        async with self._spool_lock:
            got: dict[str, int] = {}
            for dataset, buf in bufs.items():
                got[dataset] = await asyncio.to_thread(
                    self.storage.append_chunk, dataset, uploader[0],
                    uploader[1], bytes(buf))
            log.info("dataset upload from %s@%s (cluster %d): %s",
                     uploader[0], uploader[1], cluster_id, got or "empty")
            if cluster_id:
                self._spool_clusters.add(cluster_id)
            snap = await self._snapshot()
        version = ""
        if snap is not None:
            try:
                version = await self._fit(snap)
            except BaseException:
                # the snapshot cleared the spools; a failed fit (bad rows,
                # OOM) puts the rows back, or the dataset would be lost
                rows, topo_rows, _ = snap
                async with self._spool_lock:
                    if rows:
                        await asyncio.to_thread(
                            self.storage.requeue_rows, "download", rows)
                    if topo_rows:
                        await asyncio.to_thread(
                            self.storage.requeue_rows, "networktopology",
                            topo_rows)
                raise
        return TrainResponse(ok=True, model_version=version,
                             message=f"rows={got}")

    async def _snapshot(self):
        """Under ``_spool_lock``: decide what to fit, take the rows, and
        clear the consumed spools so concurrent uploads start a fresh
        dataset. Returns None when no floor is met."""
        rows = await asyncio.to_thread(self.storage.rows, "download")
        topo_rows = await asyncio.to_thread(self.storage.rows,
                                            "networktopology")
        # each model gates on its own dataset floor
        fit_mlp = len(rows) >= self.min_rows
        fit_gnn = len(topo_rows) >= 4
        if not fit_mlp and not fit_gnn:
            return None
        # a model fit on one cluster's rows belongs to that cluster; a
        # mixed spool gives a global model (cluster 0)
        clusters = self._spool_clusters
        cluster_id = next(iter(clusters)) if len(clusters) == 1 else 0
        if fit_mlp:
            await asyncio.to_thread(self.storage.clear, "download")
        if fit_gnn:
            await asyncio.to_thread(self.storage.clear, "networktopology")
        if fit_mlp and fit_gnn:
            self._spool_clusters = set()
        return (rows if fit_mlp else None,
                topo_rows if fit_gnn else None, cluster_id)

    async def _fit(self, snap) -> str:
        """Fit on a snapshot (serialized by ``_fit_lock``, uploads not
        blocked). Returns the MLP version (the one schedulers serve); the
        GNN's when only the GNN fit."""
        rows, topo_rows, cluster_id = snap
        async with self._fit_lock:
            # the MLP fits through the pipeline's supervision policy:
            # decision-outcome folds when the uploaded records carry
            # joined rulings, raw piece rows otherwise
            mlp = gnn = None
            if rows is not None:
                mlp = await asyncio.to_thread(
                    pipeline.train_decision_model, rows,
                    device=self._fit_device)
            if topo_rows is not None:
                gnn = await asyncio.to_thread(
                    training.train_gnn, topo_rows, device=self._fit_device)
            for name, fitted, attempted in (
                    (training.MLP_MODEL_NAME, mlp, rows is not None),
                    (training.GNN_MODEL_NAME, gnn, topo_rows is not None)):
                if fitted is None:
                    if attempted:
                        _fits_total.labels(name, "skipped").inc()
                    continue
                blob, metrics = fitted
                _fits_total.labels(name, "fitted").inc()
                _fit_rows.labels(name).set(metrics.get("rows", 0))
                _fit_seconds.labels(name).set(
                    metrics.get("train_seconds", 0.0))
                self.latest[name] = (blob, metrics)
                self._infer_cache.pop(name, None)
                await self._publish(name, blob, metrics, cluster_id)
        if mlp is not None:
            return mlp[1]["version"]
        return gnn[1]["version"] if gnn is not None else ""

    async def _publish(self, name: str, blob: bytes, metrics: dict,
                       cluster_id: int) -> None:
        if self.manager is None:
            return
        try:
            await self.manager.create_model(CreateModelRequest(
                name=name, version=metrics["version"], data=blob,
                metrics=metrics, scheduler_cluster_id=cluster_id))
        except Exception as exc:  # noqa: BLE001 - registry may be down
            log.warning("model %s@%s not registered: %s", name,
                        metrics["version"], exc)

    # -- ModelInfer (parity surface) -----------------------------------

    async def model_infer(self, req: ModelInferRequest,
                          context) -> ModelInferResponse:
        name = req.model_name or training.MLP_MODEL_NAME
        fitted = self.latest.get(name)
        if fitted is None:
            raise DFError(Code.NOT_FOUND, f"no trained model {name!r}")
        blob, metrics = fitted
        infer = self._infer_cache.get(name)
        if infer is None:
            # deserialize + hash the blob off-loop (cold cache only)
            infer = await asyncio.to_thread(serving.make_mlp_infer, blob)
            # a training round may have replaced the model while the build
            # was suspended: serve this request from the blob it read, but
            # cache only a still-current build
            if self.latest.get(name, (None,))[0] is blob:
                self._infer_cache[name] = infer
        outputs = await asyncio.to_thread(infer, req.features or [])
        return ModelInferResponse(outputs=outputs,
                                  model_version=metrics["version"])


def build_service(svc: TrainerService) -> ServiceDef:
    d = ServiceDef(TRAINER_SERVICE)
    d.stream_unary("Train", svc.train)
    d.unary_unary("ModelInfer", svc.model_infer)
    return d
