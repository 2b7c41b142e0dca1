"""Well-known directories for a service instance.

Counterpart of ``dragonfly2_tpu/common/dfpath.py`` (reference
``pkg/dfpath``): everything rooted under one workdir, so a test points it
at a temporary directory. The default workdir is the port's own
(``~/.dragonfly2-tpu-torch``), so a port daemon and a reference daemon on
one host do not share a socket.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _default_workdir() -> str:
    return os.environ.get("DF_WORKDIR",
                          os.path.expanduser("~/.dragonfly2-tpu-torch"))


@dataclass
class DFPath:
    workdir: str = field(default_factory=_default_workdir)

    @property
    def data_dir(self) -> str:
        return os.path.join(self.workdir, "data")

    @property
    def cache_dir(self) -> str:
        return os.path.join(self.workdir, "cache")

    @property
    def log_dir(self) -> str:
        return os.path.join(self.workdir, "logs")

    @property
    def run_dir(self) -> str:
        return os.path.join(self.workdir, "run")

    @property
    def plugin_dir(self) -> str:
        return os.path.join(self.workdir, "plugins")

    def ensure(self) -> "DFPath":
        for d in (self.data_dir, self.cache_dir, self.log_dir, self.run_dir,
                  self.plugin_dir):
            os.makedirs(d, exist_ok=True)
        return self

    def daemon_sock(self) -> str:
        return os.path.join(self.run_dir, "daemon.sock")
