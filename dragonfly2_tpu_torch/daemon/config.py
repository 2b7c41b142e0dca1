"""Daemon configuration.

Counterpart of ``dragonfly2_tpu/daemon/config.py`` cut to the deployment
settings this slice honors (manager and scheduler addresses, the
scheduler-set refresh, ports, listeners, workdir), plus ``device``: where
the device sink lands bytes. The
reference's tuning knobs that no caller of the port sets yet are module
constants where they are used.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.unit import MiB


@dataclass
class SchedulerConfig:
    addresses: list[str] = field(default_factory=list)  # empty: back-source only
    # cadence of the manager-discovered scheduler set's refresh; 0
    # disables. A scheduler replaced, or one that registers after this
    # daemon booted, reaches the daemon without a restart.
    refresh_interval_s: float = 30.0


@dataclass
class DownloadConfig:
    back_source_parallelism: int = 4       # concurrent origin range streams
    back_source_group_min_bytes: int = 32 * MiB  # below this, one stream


@dataclass
class UploadConfig:
    port: int = 0                          # 0 = ephemeral


@dataclass
class DaemonConfig:
    workdir: str = ""
    host_ip: str = ""                      # advertised to peers; "" = detect
    listen_ip: str = "0.0.0.0"             # servers bind here
    hostname: str = ""
    is_seed: bool = False
    rpc_port: int = 0                      # peer RPC (0 = ephemeral)
    unix_sock: str = ""                    # local API socket; "" = workdir
    manager_addresses: list[str] = field(default_factory=list)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    download: DownloadConfig = field(default_factory=DownloadConfig)
    upload: UploadConfig = field(default_factory=UploadConfig)
    # "cuda": every CUDA device of the host (an error when there is none);
    # "cpu": one CPU device, only when named
    device: str = "cuda"
