"""Daemon configuration.

Counterpart of ``dragonfly2_tpu/daemon/config.py`` cut to the knobs this
slice honors, plus ``device``: where the device sink lands bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.unit import MiB


@dataclass
class DownloadConfig:
    back_source_parallelism: int = 4       # concurrent origin range streams
    back_source_group_min_bytes: int = 32 * MiB  # below this, one stream


@dataclass
class DaemonConfig:
    workdir: str = ""
    host_ip: str = ""                      # peer-id identity; "" = 127.0.0.1
    hostname: str = ""
    is_seed: bool = False
    download: DownloadConfig = field(default_factory=DownloadConfig)
    # "cuda": every CUDA device of the host (an error when there is none);
    # "cpu": one CPU device, only when named
    device: str = "cuda"
