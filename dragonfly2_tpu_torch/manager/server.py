"""Manager bootstrap: store + RPC + REST + liveness sweep.

Counterpart of ``dragonfly2_tpu/manager/server.py`` (reference
``manager/manager.go:106-234`` ``New``/``Serve``) with the keepalive-TTL
sweep that marks silent instances inactive. ``ManagerConfig`` keeps the
reference's fields; the ones whose subsystems are not ported yet (REST
auth, certificate issuance, TLS on the RPC port) make ``start`` refuse
with an error that names them. ``plugin_dir`` loads the searcher plugin
at ``start``, and a broken or missing one fails the start, as in the
reference.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

from ..common.gc import GC, GCTask
from ..rpc.server import RPCServer
from .rest import RestAPI
from .service import ManagerService, build_service
from .store import Store

log = logging.getLogger("df.mgr.server")


@dataclass
class ManagerConfig:
    listen_ip: str = "0.0.0.0"
    advertise_ip: str = "127.0.0.1"
    grpc_port: int = 0
    rest_port: int = 0
    db_path: str = ""                  # "" = in-memory
    keepalive_ttl_s: float = 60.0
    sweep_interval_s: float = 15.0
    # REST auth (reference manager/middlewares): not ported
    auth_enabled: bool = False
    workdir: str = ""
    # certificate issuance for fleet mTLS and TLS on the RPC port: not
    # ported
    issue_certs: bool = False
    grpc_tls: bool = False
    # df_plugin_searcher_default.py replaces the cluster scorer
    plugin_dir: str = ""

    def unported(self) -> list[str]:
        """The set options whose subsystems this package lacks."""
        return [name for name, on in (("auth_enabled", self.auth_enabled),
                                      ("issue_certs", self.issue_certs),
                                      ("grpc_tls", self.grpc_tls))
                if on]


class Manager:
    def __init__(self, cfg: ManagerConfig):
        self.cfg = cfg
        if cfg.db_path:
            os.makedirs(os.path.dirname(os.path.abspath(cfg.db_path)),
                        exist_ok=True)
        self.store = Store(cfg.db_path or ":memory:")
        self.service = ManagerService(self.store)
        self.rest = RestAPI(self.store, host=cfg.listen_ip,
                            port=cfg.rest_port)
        self.rpc: RPCServer | None = None
        self.gc = GC()
        self.port: int | None = None

    @property
    def address(self) -> str:
        return f"{self.cfg.advertise_ip}:{self.port}"

    async def start(self) -> None:
        unported = self.cfg.unported()
        if unported:
            raise ValueError(
                f"manager options not ported yet: {', '.join(unported)} "
                f"(REST auth, certificate issuance and RPC TLS are later "
                f"slices)")
        if self.cfg.plugin_dir:
            # fail hard, as the scheduler's evaluator plugin slot does: an
            # operator who configured a plugin must not silently get the
            # built-in scorer because of a typo in the plugin file
            from .searcher import load_searcher_plugin
            load_searcher_plugin(self.cfg.plugin_dir)
            log.info("searcher plugin loaded from %s", self.cfg.plugin_dir)
        # a default cluster always exists so self-registration lands somewhere
        self.store.default_scheduler_cluster()
        self.rpc = RPCServer(f"{self.cfg.listen_ip}:{self.cfg.grpc_port}")
        self.rpc.register(build_service(self.service))
        await self.rpc.start()
        self.port = self.rpc.port
        await self.rest.start()
        self.gc.add(GCTask(
            "keepalive-sweep", self.cfg.sweep_interval_s,
            lambda: self.store.expire_stale(ttl_s=self.cfg.keepalive_ttl_s)))
        self.gc.start()
        log.info("manager up: grpc=%s rest=%d db=%s", self.address,
                 self.rest.port, self.cfg.db_path or ":memory:")

    async def stop(self) -> None:
        await self.gc.stop()
        await self.rest.stop()
        if self.rpc is not None:
            await self.rpc.stop(0.5)
        self.store.close()
