"""Trainer bootstrap: storage + RPC service + manager link.

Counterpart of ``dragonfly2_tpu/trainer/server.py`` (reference
``trainer/trainer.go:187`` New/Serve): the dataset storage, the ``Train``
sink, and the manager connection the fitted models are published through
(none without ``manager_addresses``: models then stay in the service).
``device`` is where fits run: every visible CUDA card by default (the
mesh when there are several; an error when there is none), ``"cpu"``
only when named. ``min_rows`` is the MLP fit's row floor. Every key of
the reference's ``TrainerConfig`` is wired (``KEY_CLASSES``); ``device``
is the port's own.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..common.config import WIRED

from ..rpc.manager_link import ManagerLink
from ..rpc.server import RPCServer
from .service import TrainerService, build_service
from .storage import TrainerStorage

log = logging.getLogger("df.trainer.server")


@dataclass
class TrainerConfig:
    listen_ip: str = "0.0.0.0"
    advertise_ip: str = "127.0.0.1"
    port: int = 0                       # 0 = ephemeral
    data_dir: str = ""                  # dataset spool; "" = ./trainer-data
    manager_addresses: list[str] = field(default_factory=list)
    min_rows: int = 32                  # don't fit on noise
    device: str = "cuda"                # where fits run


# the class of every key (common/config.py)
KEY_CLASSES: dict[str, str] = {
    "listen_ip": WIRED,
    "advertise_ip": WIRED,
    "port": WIRED,
    "data_dir": WIRED,
    "manager_addresses": WIRED,
    "min_rows": WIRED,
    "device": WIRED,
}


class Trainer:
    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        self.storage = TrainerStorage(cfg.data_dir or "./trainer-data")
        self.manager: ManagerLink | None = None
        self.service: TrainerService | None = None
        self.rpc: RPCServer | None = None
        self.port: int | None = None

    @property
    def address(self) -> str:
        return f"{self.cfg.advertise_ip}:{self.port}"

    async def start(self) -> None:
        if self.cfg.manager_addresses:
            self.manager = ManagerLink(self.cfg.manager_addresses)
        self.service = TrainerService(self.storage, device=self.cfg.device,
                                      manager=self.manager,
                                      min_rows=self.cfg.min_rows)
        self.rpc = RPCServer(f"{self.cfg.listen_ip}:{self.cfg.port}")
        self.rpc.register(build_service(self.service))
        await self.rpc.start()
        self.port = self.rpc.port
        log.info("trainer up on %s (spool=%s, device=%s)", self.address,
                 self.storage.base_dir, self.service.device)

    async def stop(self) -> None:
        if self.manager is not None:
            await self.manager.close()
        if self.rpc is not None:
            await self.rpc.stop(0.5)
