"""Daemon bootstrap: storage, piece manager, task manager, device sinks.

Counterpart of ``dragonfly2_tpu/daemon/daemon.py`` for a daemon with no
scheduler: every task goes back to source, as a seed peer's tasks do. The
RPC, upload and scheduler surfaces wait for later slices.
"""

from __future__ import annotations

import logging
import os
import socket

import torch

from ..common.errors import Code, DFError
from ..common.piece import INGEST_DMA_UNIT_BYTES
from ..idl.messages import DeviceSink
from ..storage.manager import StorageManager
from ..tpu import topology
from ..tpu.hbm_sink import DeviceIngest
from ..tpu.mesh import cuda_devices
from .config import DaemonConfig
from .peertask_manager import PeerTaskManager
from .piece_manager import PieceManager

log = logging.getLogger("df.core.daemon")


def _default_workdir() -> str:
    return os.environ.get("DF_WORKDIR",
                          os.path.expanduser("~/.dragonfly2-tpu-torch"))


class Daemon:
    def __init__(self, cfg: DaemonConfig):
        if cfg.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', "
                             f"got {cfg.device!r}")
        self.cfg = cfg
        self.hostname = cfg.hostname or socket.gethostname()
        self.host_ip = cfg.host_ip or "127.0.0.1"
        self.workdir = cfg.workdir or _default_workdir()
        # the bounded runtime probe at construction (the reference's
        # topology.detect() does the same): it is what lets
        # ensure_runtime_alive() admit the first device sink
        status, payload = topology.probe_cuda_devices()
        if status == "timeout":
            log.warning("CUDA runtime did not answer the probe; device sink "
                        "unavailable")
        elif status == "error":
            log.warning("CUDA runtime probe failed: %s", payload)
        self.storage_mgr = StorageManager(
            os.path.join(self.workdir, "data", "tasks"))
        self.piece_mgr = PieceManager(cfg.download)
        self.ptm: PeerTaskManager | None = None

    def devices(self) -> list[torch.device]:
        """The sink's devices: every CUDA device, or the one CPU device
        when the config names it."""
        if self.cfg.device == "cpu":
            return [torch.device("cpu")]
        return cuda_devices()

    def device_sink_builder(self, spec: DeviceSink):
        """Returns a factory(content_length[, shard_specs]) -> DeviceIngest
        honoring the request's sink spec. ``shard_specs`` (sharded tasks,
        common/sharding.py) switches the sink to manifest mode: named
        uneven shards that each become a device tensor the moment their
        bytes are covered."""
        def factory(content_length: int, shard_specs: list | None = None):
            if not topology.ensure_runtime_alive():
                # our own probe thread is parked in CUDA init, the host is
                # marked wedged, or a fresh bounded probe is still out: a
                # CUDA call here could hang the EVENT LOOP — refuse and let
                # the caller fall back to disk only
                raise DFError(
                    Code.UNAVAILABLE,
                    "accelerator runtime is not answering; device sink "
                    "unavailable")
            devices = self.devices()
            if shard_specs:
                return DeviceIngest(content_length, devices=devices,
                                    dtype=spec.dtype,
                                    shard_specs=shard_specs)
            spd = spec.pipeline_shards
            if spd <= 0:
                # auto: one shard per copy unit, at most 32 per device; the
                # overlap comes from back-source's front-to-back work queue
                # completing these units progressively
                per_dev = -(-content_length // len(devices))
                spd = max(1, min(32, per_dev // INGEST_DMA_UNIT_BYTES))
            return DeviceIngest(content_length, devices=devices,
                                dtype=spec.dtype, shards_per_device=spd)
        return factory

    async def start(self) -> None:
        self.ptm = PeerTaskManager(
            storage_mgr=self.storage_mgr, piece_mgr=self.piece_mgr,
            hostname=self.hostname, host_ip=self.host_ip,
            device_sink_builder=self.device_sink_builder,
            is_seed=self.cfg.is_seed)
        log.info("daemon up: host=%s ip=%s device=%s workdir=%s",
                 self.hostname, self.host_ip, self.cfg.device, self.workdir)

    async def stop(self) -> None:
        if self.ptm is not None:
            await self.ptm.shutdown()
