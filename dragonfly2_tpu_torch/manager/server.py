"""Manager bootstrap: store + job runner + RPC + REST + liveness sweep.

Counterpart of ``dragonfly2_tpu/manager/server.py`` (reference
``manager/manager.go:106-234`` ``New``/``Serve``) with the keepalive-TTL
sweep that marks silent instances inactive. The job runner
(``jobs.py``) takes the REST API's preheat and sync-peers jobs; once the
RPC server is up, and before the REST listener opens, it dispatches again
the jobs a previous process left ``pending`` or ``running`` in the same
database, so a job submitted at boot is not dispatched twice; ``stop``
cancels the jobs still running. ``ManagerConfig`` keeps the
reference's fields. ``issue_certs`` makes the manager a fleet certificate
issuer: a CA under ``<workdir>/manager-ca`` and an issuance token made
once and kept at ``<workdir>/issuer.token`` (mode 0600), both as the
reference's; ``grpc_tls`` serves the RPC port over TLS with a leaf from
that CA. ``auth_enabled`` turns on REST auth (``auth.py``): the
session secret kept as ``session.secret`` in the workdir and, at the
first boot, a root user whose generated password is written beside it
as ``root.password`` (both mode 0600 from creation); a Python whose
``hashlib`` lacks scrypt fails the manager's construction.
``plugin_dir`` loads the searcher plugin at ``start``, and a broken or
missing one fails the start, as in the reference.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import secrets
import tempfile
from dataclasses import dataclass

from ..common.certs import CertIssuer

from ..common.gc import GC, GCTask
from ..rpc.server import RPCServer, TLSOptions
from .auth import Authenticator, bootstrap_root
from .jobs import JobRunner
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
    # REST auth (reference manager/middlewares)
    auth_enabled: bool = False
    workdir: str = ""
    # certificate issuance for fleet mTLS (reference
    # manager/rpcserver/security_server_v1.go and pkg/issuer)
    issue_certs: bool = False
    # the manager's own RPC port over TLS, with a leaf from the manager
    # CA: needed wherever issue_certs rides an untrusted network, since
    # the issuance token travels in the request. Clients trust
    # manager-ca/proxy-ca.crt, distributed out of band.
    grpc_tls: bool = False
    # df_plugin_searcher_default.py replaces the cluster scorer
    plugin_dir: str = ""

    def unported(self) -> list[str]:
        """The set options whose subsystems this package lacks: none
        since REST auth was ported; kept for a key a later reference
        change adds."""
        return []


class Manager:
    def __init__(self, cfg: ManagerConfig):
        self.cfg = cfg
        if cfg.db_path:
            os.makedirs(os.path.dirname(os.path.abspath(cfg.db_path)),
                        exist_ok=True)
        self.store = Store(cfg.db_path or ":memory:")
        self.jobs = JobRunner(self.store)
        workdir = cfg.workdir or (
            os.path.dirname(os.path.abspath(cfg.db_path)) if cfg.db_path
            else "")
        self.issuer: CertIssuer | None = None
        self.issue_token = ""
        if cfg.issue_certs:
            self.issuer = CertIssuer(os.path.join(workdir or ".",
                                                  "manager-ca"))
            # the issuance gate: made once, kept 0600, handed to the fleet
            # out of band (an open signing oracle would make the fleet's
            # mTLS authenticate nothing)
            token_path = os.path.join(workdir or ".", "issuer.token")
            if os.path.exists(token_path):
                with open(token_path, encoding="utf-8") as f:
                    self.issue_token = f.read().strip()
            else:
                self.issue_token = secrets.token_urlsafe(24)
                fd = os.open(token_path,
                             os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    f.write(self.issue_token + "\n")
        self.service = ManagerService(self.store, issuer=self.issuer,
                                      issue_token=self.issue_token)
        self.auth: Authenticator | None = None
        if cfg.auth_enabled:
            if not hasattr(hashlib, "scrypt"):
                raise RuntimeError(
                    "auth_enabled needs hashlib.scrypt, which this Python's "
                    "OpenSSL lacks: the password hash has no other form")
            self.auth = Authenticator(
                self.store,
                secret_path=os.path.join(workdir, "session.secret")
                if workdir else "")
            bootstrap_root(self.store, password_path=os.path.join(
                workdir, "root.password") if workdir else "")
        self.rest = RestAPI(self.store, self.jobs, host=cfg.listen_ip,
                            port=cfg.rest_port, auth=self.auth)
        self.rpc: RPCServer | None = None
        self.gc = GC()
        self.port: int | None = None

    @property
    def address(self) -> str:
        return f"{self.cfg.advertise_ip}:{self.port}"

    @property
    def ca_cert_path(self) -> str:
        return self.issuer.ca_cert_path if self.issuer else ""

    def _grpc_tls(self) -> TLSOptions | None:
        """The RPC port's TLS: a leaf for ``advertise_ip`` from the
        manager CA, written to a fresh temporary directory (the key
        0600)."""
        if not self.cfg.grpc_tls:
            return None
        if self.issuer is None:
            raise ValueError("grpc_tls requires issue_certs (the manager CA "
                             "signs its own server cert)")
        cert_pem, key_pem, _ = self.issuer._mint(self.cfg.advertise_ip)
        d = tempfile.mkdtemp(prefix="df-mgr-tls-")
        cert_p, key_p = os.path.join(d, "s.crt"), os.path.join(d, "s.key")
        with open(cert_p, "wb") as f:
            f.write(cert_pem + self.issuer.ca_cert.pem)
        fd = os.open(key_p, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(key_pem)
        return TLSOptions(cert_p, key_p)

    async def start(self) -> None:
        unported = self.cfg.unported()
        if unported:
            raise ValueError(
                f"manager options not ported yet: {', '.join(unported)}")
        if self.cfg.plugin_dir:
            # fail hard, as the scheduler's evaluator plugin slot does: an
            # operator who configured a plugin must not silently get the
            # built-in scorer because of a typo in the plugin file
            from .searcher import load_searcher_plugin
            load_searcher_plugin(self.cfg.plugin_dir)
            log.info("searcher plugin loaded from %s", self.cfg.plugin_dir)
        # a default cluster always exists so self-registration lands somewhere
        self.store.default_scheduler_cluster()
        self.rpc = RPCServer(f"{self.cfg.listen_ip}:{self.cfg.grpc_port}",
                             tls=await asyncio.to_thread(self._grpc_tls))
        self.rpc.register(build_service(self.service))
        await self.rpc.start()
        self.port = self.rpc.port
        # before the REST listener: a job submitted during the boot window
        # must not be dispatched twice by the scan
        await self.jobs.resume_interrupted()
        await self.rest.start()
        self.gc.add(GCTask(
            "keepalive-sweep", self.cfg.sweep_interval_s,
            lambda: self.store.expire_stale(ttl_s=self.cfg.keepalive_ttl_s)))
        self.gc.start()
        log.info("manager up: grpc=%s rest=%d db=%s", self.address,
                 self.rest.port, self.cfg.db_path or ":memory:")

    async def stop(self) -> None:
        await self.gc.stop()
        await self.jobs.close()
        await self.rest.stop()
        if self.rpc is not None:
            await self.rpc.stop(0.5)
        self.store.close()
