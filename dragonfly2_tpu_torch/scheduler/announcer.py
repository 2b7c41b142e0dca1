"""Scheduler announcer: ship records to the trainer, pull models back.

Counterpart of ``dragonfly2_tpu/scheduler/announcer.py`` (reference
``scheduler/announcer/announcer.go:142-235``): the interval loop that
gzips the download and networktopology datasets and streams them to the
trainer's ``Train`` RPC, and the refresh loop that pulls the latest fitted
``bandwidth_mlp`` from the manager's registry into the ``ml`` evaluator
and the ``topology_gnn`` into the topology store's imputer. A blob also
binds directly through ``bind_model``. Both keep the reference's refusal
discipline (garbage bytes, stale schema, non-finite weights: refused,
journaled, and the evaluator keeps its current model or its heuristic
floor).
"""

from __future__ import annotations

import asyncio
import gzip
import json
import logging
import socket
import time

from ..common.metrics import REGISTRY
from ..idl.messages import GetModelRequest, TrainRequest
from ..rpc.client import Channel, ServiceClient
from ..trainer.features import GNN_MODEL_NAME, MLP_MODEL_NAME
from ..trainer.params_io import version_of
from ..trainer.serving import make_gnn_impute, make_mlp_infer
from .evaluator_ml import MLEvaluator

log = logging.getLogger("df.sched.announcer")

TRAINER_SERVICE = "df.trainer.Trainer"
UPLOAD_CHUNK_BYTES = 1 << 20
MAX_REFUSALS_REMEMBERED = 8         # rollout-provenance journal bound

_rollouts_total = REGISTRY.counter(
    "df_ml_model_rollouts_total",
    "model versions successfully bound into the live serving path",
    ("model",))
_refused_total = REGISTRY.counter(
    "df_ml_model_refused_total",
    "model blobs refused wholesale at bind time (garbage bytes, stale "
    "feature schema, non-finite weights)", ("model",))


class SchedulerAnnouncer:
    """Owned by ``Scheduler``; both loops are optional and independent:
    the records upload needs a ``trainer_address`` and records, the model
    refresh the manager link."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self._tasks: list[asyncio.Task] = []
        self._trainer_channel: Channel | None = None
        self.model_version = ""        # newest MLP version seen (served OR
        self.gnn_version = ""          # refused): the if_none_match cursor
        self.model_bound_at = 0.0      # wall clock of the last MLP bind
        self.model_metrics: dict = {}  # metrics of the served MLP
        self.refused: dict[str, str] = {}   # version -> bind refusal reason
        self._last_topo_key = 0        # hash of last uploaded topo snapshot
        self.last_upload: dict = {}    # rows / bytes of the last upload

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        if self.scheduler.cfg.trainer_address and \
                self.scheduler.service.records is not None:
            self._tasks.append(loop.create_task(self._upload_loop()))
        # the refresh feeds both the ml evaluator (MLP) and the topology
        # store's imputer (GNN)
        if self.scheduler.manager is not None:
            self._tasks.append(loop.create_task(self._refresh_loop()))

    def _evaluator(self) -> MLEvaluator | None:
        ev = self.scheduler.scheduling.evaluator
        return ev if isinstance(ev, MLEvaluator) else None

    # -- records upload ------------------------------------------------

    def _trainer_client(self) -> ServiceClient:
        if self._trainer_channel is None:
            self._trainer_channel = Channel(self.scheduler.cfg.trainer_address)
        return ServiceClient(self._trainer_channel, TRAINER_SERVICE)

    async def _upload_loop(self) -> None:
        while True:
            await asyncio.sleep(self.scheduler.cfg.train_upload_interval_s)
            try:
                await self.upload_once()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - trainer may be away
                log.debug("records upload failed: %s", exc)

    async def upload_once(self) -> bool:
        """One gzip'd upload of everything buffered; False if nothing to
        send. The call returns once the trainer has fitted on it."""
        records = self.scheduler.service.records
        rows = records.drain() if records is not None else []
        topo_rows = self.scheduler.topo.snapshot_rows()
        # the topology snapshot is state, not a stream: re-sending an
        # unchanged snapshot every interval would duplicate every edge in
        # the trainer's spool and skew the GNN fit
        topo_key = hash(json.dumps(topo_rows, sort_keys=True))
        if topo_key == self._last_topo_key:
            topo_rows = []
        if not rows and not topo_rows:
            return False
        hostname = socket.gethostname()
        ip = self.scheduler.cfg.advertise_ip

        def compress(payload):
            return gzip.compress(
                "\n".join(json.dumps(r) for r in payload).encode())

        # serialize+compress off the event loop — tens of MB of JSON inline
        # would stall every scheduling RPC for the duration
        blobs = {dataset: await asyncio.to_thread(compress, payload)
                 for dataset, payload in (("download", rows),
                                          ("networktopology", topo_rows))
                 if payload}

        cluster_id = self.scheduler.cfg.cluster_id

        async def chunks():
            for dataset, blob in blobs.items():
                for off in range(0, len(blob), UPLOAD_CHUNK_BYTES):
                    yield TrainRequest(
                        hostname=hostname, ip=ip, cluster_id=cluster_id,
                        dataset=dataset,
                        chunk=blob[off:off + UPLOAD_CHUNK_BYTES])
            yield TrainRequest(hostname=hostname, ip=ip,
                               cluster_id=cluster_id, dataset="download",
                               done=True)

        try:
            resp = await self._trainer_client().stream_unary(
                "Train", chunks(), timeout=300.0)
        except Exception:
            # trainer away: put the interval's rows back so the next cycle
            # retries (at-least-once delivery: a timeout after the trainer
            # consumed the stream re-sends rows, a mild reweighting)
            if records is not None:
                records.requeue(rows)
            raise
        if topo_rows:
            self._last_topo_key = topo_key
        self.last_upload = {
            "rows": len(rows), "topology_rows": len(topo_rows),
            "compressed_bytes": {k: len(v) for k, v in blobs.items()},
            "model_version": resp.model_version}
        log.info("records uploaded: %d download + %d topology rows -> %s",
                 len(rows), len(topo_rows),
                 resp.model_version or "(no new model)")
        return True

    # -- model refresh and binding -------------------------------------

    async def _refresh_loop(self) -> None:
        while True:
            try:
                await self.refresh_model_once()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - registry may be away
                log.debug("model refresh failed: %s", exc)
            await asyncio.sleep(self.scheduler.cfg.model_refresh_interval_s)

    async def refresh_model_once(self) -> bool:
        """Pull the latest models from the manager's registry; True when a
        new MLP version now serves. The GNN rides the same refresh into
        the topology store's imputer."""
        manager = self.scheduler.manager
        if manager is None:
            return False
        try:
            # independent: a bad GNN artifact must not starve the MLP
            await self._refresh_gnn_once()
        except Exception as exc:  # noqa: BLE001
            log.warning("topology gnn refresh failed: %s", exc)
        if self._evaluator() is None:
            return False
        resp = await manager.get_model(GetModelRequest(
            name=MLP_MODEL_NAME,
            scheduler_cluster_id=self.scheduler.cfg.cluster_id,
            if_none_match=self.model_version))
        model = resp.model
        if model is None or model.version == self.model_version \
                or not model.data:
            return False
        return await self._bind(model.version, model.data,
                                dict(model.metrics or {}))

    async def bind_model(self, blob: bytes) -> bool:
        """Bind a ``bandwidth_mlp`` blob into the ml evaluator; True when
        a new version now serves. The blob is hashed off the loop, as it
        is deserialized: a bind must not stall rulings."""
        version = await asyncio.to_thread(version_of, blob)
        return await self._bind(version, blob, None)

    async def _bind(self, version: str, blob: bytes,
                    metrics: dict | None) -> bool:
        """A blob refused at bind time (garbage bytes, stale feature
        schema, non-finite weights) leaves the evaluator as it was (worst
        case on its heuristic floor); its version is remembered, so the
        registry poll skips refetching it, and the reason journaled in
        ``refused``. ``metrics``: the registry's, else the blob's meta."""
        evaluator = self._evaluator()
        if evaluator is None or version == self.model_version:
            return False
        try:
            # deserialize + probe off the loop: a bind must not stall
            # rulings
            infer = await asyncio.to_thread(make_mlp_infer, blob)
        except ValueError as exc:
            self.model_version = version
            self._remember_refusal(version, str(exc))
            _refused_total.labels(MLP_MODEL_NAME).inc()
            log.warning("bandwidth mlp %s refused: %s", version, exc)
            return False
        evaluator.infer = infer
        self.model_version = version
        self.model_bound_at = time.time()
        self.model_metrics = (metrics if metrics is not None
                              else dict(infer.meta, version=version))
        _rollouts_total.labels(MLP_MODEL_NAME).inc()
        log.info("ml evaluator now serving %s@%s (final_loss=%s)",
                 MLP_MODEL_NAME, version,
                 self.model_metrics.get("final_loss"))
        return True

    async def _refresh_gnn_once(self) -> bool:
        resp = await self.scheduler.manager.get_model(GetModelRequest(
            name=GNN_MODEL_NAME,
            scheduler_cluster_id=self.scheduler.cfg.cluster_id,
            if_none_match=self.gnn_version))
        model = resp.model
        if model is None or model.version == self.gnn_version \
                or not model.data:
            return False
        try:
            impute = await asyncio.to_thread(make_gnn_impute, model.data)
        except ValueError as exc:
            # stale NODE_FEATURES layout and the like: remembered, so the
            # poll skips refetching it until the trainer's next refit
            self.gnn_version = model.version
            self._remember_refusal(model.version, str(exc))
            _refused_total.labels(GNN_MODEL_NAME).inc()
            log.warning("topology gnn %s refused: %s", model.version, exc)
            return False
        self.scheduler.topo.bind_imputer(impute)
        self.gnn_version = model.version
        _rollouts_total.labels(GNN_MODEL_NAME).inc()
        log.info("topology store now imputing with %s@%s",
                 model.name, model.version)
        return True

    def _remember_refusal(self, version: str, reason: str) -> None:
        self.refused[version] = reason
        while len(self.refused) > MAX_REFUSALS_REMEMBERED:
            self.refused.pop(next(iter(self.refused)))

    def model_provenance(self) -> dict:
        """Which model version is ruling (from the evaluator itself, not
        the bind cursor — a refused blob advances the cursor without being
        served), when it was bound, its metrics, and every blob refused at
        bind time since startup (bounded journal)."""
        out = {
            "model": MLP_MODEL_NAME,
            "checked_version": self.model_version,
            "bound_at": self.model_bound_at,
            "metrics": {k: self.model_metrics[k]
                        for k in ("version", "rows", "final_loss",
                                  "schema_version")
                        if k in self.model_metrics},
            "refused": dict(self.refused),
            "gnn_version": self.gnn_version,
        }
        ev = self._evaluator()
        if ev is not None:
            out["evaluator"] = ev.health()
        return out

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if self._trainer_channel is not None:
            await self._trainer_channel.close()
