"""Daemon bootstrap: storage, piece engine, servers, device sinks.

Counterpart of ``dragonfly2_tpu/daemon/daemon.py`` (reference
``client/daemon/daemon.go``): the upload server (pieces over HTTP), the
peer RPC server on TCP and the local API on a unix socket, the scheduler
connector, the P2P engine factory and the device-sink builder. With
scheduler addresses, a task registers and pulls from parents; without,
it goes back to source as a seed peer's tasks do. With manager addresses
and no static scheduler, the daemon finds its schedulers through the
manager and keeps tracking that set; a seed daemon also registers itself
as a seed peer and keeps alive. Once a scheduler is known the RTT prober
reports to it (``probe_enabled``) and the announcer heartbeats it and
replays held content when it restarts (``announcer.py``); the
connector's scheduler demotions are persisted at stop and restored at
start. The PEX gossip plane (``pex.py``, on unless ``pex.enabled`` is
false) keeps one swarm index per daemon, gossips on the upload port, and
gives the conductor the ``pex`` rung with a fresh engine per pull.
One verdict ledger (``verdicts.py``) remembers how each parent behaved:
the piece engine records every landed and failed piece in it and gates
parent admission on it, PEX filters and orders holders by it, the
upload server serves it at ``GET /debug/verdicts``, and a content-store
placement or a boot re-verify that finds bit rot in a completed task
self-quarantines the daemon (its registers and announces carry
``Host.quarantined``, its digests and re-announces advertise nothing).
Storage is reloaded at construction
(warm restart), its reloaded pieces are re-verified on the storage pool
before the servers start (a warm restart's first gossip round then runs
at once), and a ``storage`` GC task sweeps it. One flight recorder
journals every task (``GET /debug/flight`` on the upload port), and one
relay hub lets the upload server stream pieces that are still arriving
(``download.relay_enabled``). The process's health plane
(``common/health.py``: loop-lag sampler, watchdog, SLO budgets) is
acquired first at start and released last at stop, and the tracer is
configured from the ``tracing`` section. The upload server serves at
``upload.rate_limit_bps`` with ``upload.concurrent_limit`` transfers (also
announced as the host's upload slots), of which bulk-class children hold
at most ``upload.bulk_concurrent_limit``; every P2P pull runs
``download.piece_parallelism`` workers with a ``download.piece_timeout_s``
deadline per piece. The QoS plane: the traffic shaper
(``traffic_shaper.py``) splits ``download.total_rate_limit_bps`` by class
and task, and its per-task buckets pace P2P fetches and back-source
reads; the governor (``qos.py``, the ``qos`` section) admits each new
task by class, browning out and shedding bulk work, and serves ``GET
/debug/qos`` on the upload port. ``plugin_dir``'s source plugins
(``common/plugins.py``) register their schemes at start, before anything
pulls. With ``object_storage.enabled`` the object gateway
(``objectstorage.py``) is built at construction (its bucket config is
checked there) and serves from start, before the manager attach, so a
seed's registration carries its port. With ``proxy.enabled`` the HTTP(S)
proxy and registry mirror (``proxy.py``) starts after the local API, as
in the reference, and stops after the task manager's shutdown. With
``security.enabled`` (fleet mTLS) the daemon first enrolls with the
manager (``rpc/security.py``: a local key pair, its public half signed by
the manager's ``IssueCertificate``), then serves both peer planes with
the issued leaf and requires fleet client certificates on each: the RPC
port and the upload port, through the TLS/plaintext mux while
``security.tls_policy`` is not ``force``. Its peer channels, piece
downloader and PEX gossip present the leaf; a renewal task re-enrolls at
2/3 of the validity (outbound material rotates, listeners keep the leaf
they bound). As in the reference, the manager link and the scheduler
session stay plaintext. A config that sets a key whose subsystem is not
ported is refused at construction, by name.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
import tempfile
from typing import Any

import torch

from .. import source
from ..common import health, tracing
from ..common.config import refuse_unported
from ..common.dfpath import DFPath
from ..common.errors import Code, DFError
from ..common.gc import GC, GCTask
from ..common.piece import INGEST_DMA_UNIT_BYTES
from ..common.plugins import load_source_plugins
from ..idl.messages import (DeviceSink, GetSchedulersRequest, Host, HostType,
                            RegisterSeedPeerRequest)
from ..rpc.client import ChannelPool
from ..rpc.manager_link import ManagerLink
from ..rpc.security import obtain_certificate
from ..rpc.server import RPCServer, TLSOptions
from ..storage.io_executor import run_io
from ..storage.manager import StorageConfig, StorageManager
from ..tpu import topology
from ..tpu.hbm_sink import DeviceIngest
from ..tpu.mesh import cuda_devices
from .announcer import Announcer
from .config import KEY_CLASSES, DaemonConfig
from .flight_recorder import FlightRecorder
from .networktopology import NetworkTopologyProber
from .objectstorage import ObjectGateway
from .peertask_manager import PeerTaskManager
from .pex import PexGossiper
from .qos import QosGovernor
from .piece_downloader import PieceDownloader
from .piece_engine import PieceEngine
from .piece_manager import PieceManager
from .proxy import ProxyServer
from .relay import RelayHub
from .rpcserver import DaemonService, build_service
from .scheduler_session import SchedulerConnector
from .swarm_index import SwarmIndex
from .traffic_shaper import TrafficShaper
from .upload_server import UploadServer
from .verdicts import VerdictLedger

log = logging.getLogger("df.core.daemon")


def _local_ip() -> str:
    """The outbound interface's address (a UDP connect sends nothing)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


class Daemon:
    def __init__(self, cfg: DaemonConfig, *, scheduler_factory: Any = None,
                 p2p_engine_factory: Any = None):
        """``scheduler_factory(daemon)`` stands in for the scheduler
        connector and ``p2p_engine_factory()`` for the piece engine, as in
        the reference (tests script a scheduler's packets with them)."""
        if cfg.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', "
                             f"got {cfg.device!r}")
        refuse_unported(cfg, KEY_CLASSES)
        self.cfg = cfg
        self.hostname = cfg.hostname or socket.gethostname()
        self.host_ip = cfg.host_ip or _local_ip()
        self.paths = DFPath(cfg.workdir) if cfg.workdir else DFPath()
        # the bounded runtime probe at construction (inside detect(), as
        # in the reference): it is what lets ensure_runtime_alive() admit
        # the first device sink
        self.topology = topology.detect()
        st = cfg.storage
        self.storage_mgr = StorageManager(StorageConfig(
            data_dir=os.path.join(self.paths.data_dir, "tasks"),
            task_ttl_s=st.task_ttl_s,
            disk_gc_high_ratio=st.disk_gc_high_ratio,
            disk_gc_low_ratio=st.disk_gc_low_ratio,
            capacity_bytes=st.capacity_bytes,
            gc_interval_s=st.gc_interval_s,
            dedupe_enabled=st.dedupe_enabled,
            reload_verify=st.reload_verify,
            popularity_halflife_s=st.popularity_halflife_s))
        # per-parent verdict ledger: the local half of the swarm immune
        # system, consulted by the engine's parent admission, the PEX rung
        # and the self-quarantine
        self.verdicts = VerdictLedger()
        if self.storage_mgr.castore is not None:
            self.storage_mgr.castore.on_rot = lambda tid: \
                self.verdicts.self_quarantine(
                    f"cas placement re-verify failed (task {tid[:12]})")
        self.reload_stats: dict = {}
        self.gc = GC()
        self.prober: NetworkTopologyProber | None = None
        self.announcer: Announcer | None = None
        self.piece_mgr = PieceManager(cfg.download)
        self.shaper = TrafficShaper(
            total_rate_bps=cfg.download.total_rate_limit_bps,
            kind=cfg.download.traffic_shaper_kind)
        # class-aware admission with brownout and shed; the shaper rides
        # along for /debug/qos's per-class rates
        self.qos = QosGovernor(cfg.qos, shaper=self.shaper)
        self.flight_recorder = FlightRecorder(
            enabled=cfg.flight.enabled, max_tasks=cfg.flight.max_tasks,
            max_events=cfg.flight.max_events,
            max_serves=cfg.flight.max_serves)
        # cut-through relay hub: in-flight landing spans, readable by the
        # upload server's streaming path; None = store-and-forward
        self.relay = RelayHub() if cfg.download.relay_enabled else None
        # the gossip plane exists before the upload server so its routes
        # mount at start; ports and topology resolve through host_info()
        self.pex: PexGossiper | None = None
        if cfg.pex.enabled:
            px = cfg.pex
            self.pex = PexGossiper(
                storage_mgr=self.storage_mgr, host_info=self.host_info,
                index=SwarmIndex(ttl_s=px.ttl_s), interval_s=px.interval_s,
                fanout=px.fanout, max_digest_tasks=px.max_digest_tasks,
                bootstrap=px.bootstrap, relay=self.relay,
                verdicts=self.verdicts, pod_scope=px.pod_scope, pod_seed=px.pod_seed,
                federation_peers=px.federation_peers)
        self.upload_server = UploadServer(
            self.storage_mgr, port=cfg.upload.port, host=cfg.listen_ip,
            rate_limit_bps=cfg.upload.rate_limit_bps,
            concurrent_limit=cfg.upload.concurrent_limit,
            bulk_concurrent_limit=cfg.upload.bulk_concurrent_limit,
            flight_recorder=self.flight_recorder, relay=self.relay,
            relay_stall_s=cfg.download.relay_stall_s, pex=self.pex,
            debug_endpoints=cfg.upload.debug_endpoints,
            verdicts=self.verdicts, qos=self.qos)
        self.health = None
        self._prev_source_tls = None
        self._scheduler_factory = scheduler_factory
        self._p2p_engine_factory = p2p_engine_factory
        self.scheduler: Any = None
        self.manager: ManagerLink | None = None
        self._sched_refresh: asyncio.Task | None = None
        self.ptm: PeerTaskManager | None = None
        self.rpc: RPCServer | None = None
        self.local_rpc: RPCServer | None = None
        self.unix_sock = ""
        self._downloader: PieceDownloader | None = None
        self._peer_channels: ChannelPool | None = None
        self.object_gateway: ObjectGateway | None = (
            ObjectGateway(self, cfg.object_storage)
            if cfg.object_storage.enabled else None)
        self.proxy_server: ProxyServer | None = None
        # fleet mTLS: the issued material, set by _enroll_security
        self.fleet_ca = ""
        self._peer_tls_ca = ""
        self._peer_tls_cert = ""
        self._peer_tls_key = ""
        self._cert_renewal: asyncio.Task | None = None

    def host_info(self) -> Host:
        return Host(
            id=f"{self.hostname}-{self.host_ip}",
            ip=self.host_ip, hostname=self.hostname,
            port=self.rpc.port if self.rpc else 0,
            download_port=self.upload_server.port,
            type=HostType.SUPER_SEED if self.cfg.is_seed else HostType.NORMAL,
            os=os.uname().sysname.lower(), platform=os.uname().machine,
            topology=self.topology,
            concurrent_upload_limit=self.cfg.upload.concurrent_limit,
            # the self-quarantine rides every register and announce: the
            # scheduler's registry treats the flag as hard evidence
            quarantined=self.verdicts.self_quarantined)

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
                # overlap comes from the pieces completing these units
                # progressively
                per_dev = -(-content_length // len(devices))
                spd = max(1, min(32, per_dev // INGEST_DMA_UNIT_BYTES))
            return DeviceIngest(content_length, devices=devices,
                                dtype=spec.dtype, shards_per_device=spd)
        return factory

    def _engine(self) -> PieceEngine:
        dl = self.cfg.download
        return PieceEngine(
            parallelism=dl.piece_parallelism,
            piece_timeout_s=dl.piece_timeout_s,
            downloader=self._downloader, channel_pool=self._peer_channels,
            slice_name=self.topology.slice_name, relay=self.relay,
            verdicts=self.verdicts,
            peer_observer=(self.pex.observe_parent
                           if self.pex is not None else None),
            schedule_timeout_s=self.cfg.scheduler.schedule_timeout_s)

    def _issue_token(self) -> str:
        sec = self.cfg.security
        if sec.issue_token or not sec.issue_token_path:
            return sec.issue_token
        with open(sec.issue_token_path, encoding="utf-8") as f:
            return f.read().strip()

    async def _obtain_certificate(self) -> tuple[str, str, str]:
        sec = self.cfg.security
        return await obtain_certificate(
            self.cfg.manager_addresses, hosts=[self.host_ip, self.hostname],
            token=await asyncio.to_thread(self._issue_token),
            out_dir=os.path.join(self.paths.cache_dir, "tls"),
            validity_s=sec.cert_validity_s, tls_ca=sec.ca_cert)

    async def _enroll_security(self) -> TLSOptions:
        """Enroll with the manager and keep the issued material: peer
        channels verify the fleet CA and present the leaf; the RPC
        server requires client certificates, the mutual half of mTLS."""
        if not self.cfg.security.ca_cert:
            log.warning(
                "security: enrolling over a channel with NO pinned fleet "
                "CA: the issuance token travels unprotected and the CA is "
                "trust-on-first-use; set security.ca_cert (and a TLS "
                "manager port) for untrusted networks")
        cert, key, ca = await self._obtain_certificate()
        self.fleet_ca = self.cfg.security.ca_cert or ca
        self._peer_tls_ca = self.fleet_ca
        self._peer_tls_cert = cert
        self._peer_tls_key = key
        self._cert_renewal = asyncio.get_running_loop().create_task(
            self._renew_certs_loop())
        return TLSOptions(cert, key, ca_path=self.fleet_ca,
                          require_client_cert=True)

    async def _renew_certs_loop(self) -> None:
        """Re-enroll at 2/3 of the validity, at least a minute apart
        (reference: certify re-issues on demand). The files are rewritten
        in place: outbound material rotates as connections open, and
        listeners keep the leaf they bound."""
        sec = self.cfg.security
        while True:
            await asyncio.sleep(max(sec.cert_validity_s * 2 / 3, 60))
            try:
                await self._obtain_certificate()
                log.info("fleet certificate renewed")
            except Exception as exc:  # noqa: BLE001 - retry next cycle
                log.error("fleet certificate renewal failed: %s", exc)

    def _connector(self, addresses: list[str]) -> SchedulerConnector:
        sc = self.cfg.scheduler
        return SchedulerConnector(
            addresses, self.host_info(),
            register_timeout_s=sc.register_timeout_s,
            failover_n=sc.failover_n, demote_s=sc.demote_s)

    async def start(self) -> None:
        # the health plane first: the watchdog must already sweep when the
        # first download section opens (process-wide and refcounted, so
        # co-resident daemons share it)
        self.health = health.PLANE
        self.health.acquire(self.cfg.health.to_plane())
        self.health.attach_recorder(self.flight_recorder)
        if self.cfg.plugin_dir:
            # a plugin's schemes exist before the first pull
            load_source_plugins(self.cfg.plugin_dir)
        if self.storage_mgr.reloaded_tasks:
            # warm restart: re-verify the reloaded pieces on the storage
            # pool before anything serves or advertises them
            self.reload_stats = await self.storage_mgr.verify_reloaded_async()
            log.info("warm restart: %d task(s) reloaded, %d piece(s) "
                     "verified, %d dropped (%d from completed tasks)",
                     self.storage_mgr.reloaded_tasks,
                     self.reload_stats["pieces_ok"],
                     self.reload_stats["pieces_dropped"],
                     self.reload_stats["pieces_rot"])
            if self.reload_stats.get("pieces_rot", 0):
                # rot in completed tasks (pieces that once verified): the
                # disk is lying, so stop serving pod-wide until a restart
                # re-verifies clean; drops from partial tasks are torn
                # writes and heal silently
                self.verdicts.self_quarantine(
                    f"boot re-verify found {self.reload_stats['pieces_rot']} "
                    f"rotted piece(s) in completed tasks")
        dl = self.cfg.download
        if dl.source_ca or dl.source_insecure:
            # the source client is a process singleton: the prior trust is
            # restored at stop(), so co-resident daemons keep their own
            http = source.client_for("https://")
            self._prev_source_tls = (http, http._ssl)
            http.set_tls(insecure=dl.source_insecure, ca_file=dl.source_ca)
        if self.cfg.tracing.enabled:
            tr = self.cfg.tracing
            tracing.configure(
                service=f"dfdaemon/{self.hostname}",
                jsonl_path=tr.jsonl_path or os.path.join(
                    self.paths.log_dir, "traces.jsonl"),
                otlp_endpoint=tr.otlp_endpoint, sample_ratio=tr.sample_ratio)
        # fleet mTLS enrollment first: the upload server, the peer
        # channels, the downloader, PEX and the RPC server take its leaf
        rpc_tls = None
        tls_triple = None
        if self.cfg.security.enabled:
            rpc_tls = await self._enroll_security()
            tls_triple = (self._peer_tls_cert, self._peer_tls_key,
                          self._peer_tls_ca)
            # the rollout policy covers both planes, and must be set
            # before start() decides whether to front a mux
            self.upload_server.tls = tls_triple
            self.upload_server.tls_policy = self.cfg.security.tls_policy
        self.upload_server.host_id = f"{self.hostname}-{self.host_ip}"
        await self.upload_server.start()
        self._peer_channels = ChannelPool(
            tls_ca=self._peer_tls_ca, tls_cert=self._peer_tls_cert,
            tls_key=self._peer_tls_key)
        self._downloader = PieceDownloader(timeout_s=dl.piece_timeout_s,
                                           tls=tls_triple)
        self.shaper.start()
        self.ptm = PeerTaskManager(
            storage_mgr=self.storage_mgr, piece_mgr=self.piece_mgr,
            hostname=self.hostname, host_ip=self.host_ip,
            p2p_engine_factory=self._p2p_engine_factory or self._engine,
            device_sink_builder=self.device_sink_builder,
            is_seed=self.cfg.is_seed,
            flight_recorder=self.flight_recorder, relay=self.relay,
            pex=self.pex, prefetch_whole_file=dl.prefetch_whole_file,
            shaper=self.shaper, qos=self.qos)
        if self.pex is not None:
            # the pex rung builds a fresh engine per pull (the scheduler
            # path may have used the conductor's); gossip presents the
            # fleet client leaf under mTLS
            self.pex.engine_factory = self._p2p_engine_factory or self._engine
            self.pex.tls = tls_triple
        svc = DaemonService(
            self.ptm, upload_addr=f"{self.host_ip}:{self.upload_server.port}")
        # peer-facing TCP server: bind the listen address, advertise host_ip
        self.rpc = RPCServer(f"{self.cfg.listen_ip}:{self.cfg.rpc_port}",
                             tls=rpc_tls,
                             tls_policy=self.cfg.security.tls_policy)
        for sdef in build_service(svc):
            self.rpc.register(sdef)
        await self.rpc.start()
        if self.object_gateway is not None:
            # before the manager attach: a seed registers its port
            await self.object_gateway.start()
        # the connector needs the resolved rpc/upload ports for register
        if self._scheduler_factory is not None:
            self.scheduler = self._scheduler_factory(self)
        elif self.cfg.scheduler.addresses:
            self.scheduler = self._connector(self.cfg.scheduler.addresses)
        elif self.cfg.manager_addresses:
            await self._attach_manager()
        self.ptm.scheduler = self.scheduler
        await asyncio.to_thread(self._restore_scheduler_demotions)
        await self._wire_scheduler_extras()
        self.gc.add(GCTask("storage", self.cfg.storage.gc_interval_s,
                           lambda: run_io(self.storage_mgr.try_gc)))
        self.gc.start()
        # local API over a unix socket
        sock = self.cfg.unix_sock or self.paths.daemon_sock()
        if len(sock) > 100:
            # past the kernel's unix-socket path limit: a short temp path
            sock = os.path.join(tempfile.mkdtemp(prefix="df-"), "d.sock")
        # dflint: disable=DF001 — socket-dir creation during start(), nothing is served yet
        os.makedirs(os.path.dirname(sock) or ".", exist_ok=True)
        self.local_rpc = RPCServer(f"unix:{sock}")
        for sdef in build_service(svc):
            self.local_rpc.register(sdef)
        await self.local_rpc.start()
        self.unix_sock = sock
        if self.cfg.proxy.enabled:
            self.proxy_server = ProxyServer(self, self.cfg.proxy)
            await self.proxy_server.start()
        if self.pex is not None:
            # a warm-restarted daemon gossips its reloaded holdings at
            # once, not after the first jittered interval
            await self.pex.start(
                initial_round=bool(self.storage_mgr.reloaded_tasks))
        log.info("daemon up: host=%s ip=%s rpc=%s upload=%d sock=%s "
                 "seed=%s device=%s schedulers=%s workdir=%s",
                 self.hostname, self.host_ip, self.rpc.port,
                 self.upload_server.port, sock, self.cfg.is_seed,
                 self.cfg.device,
                 getattr(self.scheduler, "addresses", []),
                 self.paths.workdir)

    async def _discover_schedulers(self) -> list[str]:
        resp = await self.manager.get_schedulers(GetSchedulersRequest(
            hostname=self.hostname, ip=self.host_ip, topology=self.topology))
        return [f"{s.ip}:{s.port}" for s in (resp.schedulers or [])]

    async def _attach_manager(self) -> None:
        """Discover schedulers through the manager; a seed daemon also
        registers itself as a seed peer and keeps alive. A failed attach
        leaves the daemon back-source only until the refresh loop finds a
        scheduler, as the reference does."""
        self.manager = ManagerLink(self.cfg.manager_addresses)
        try:
            if self.cfg.is_seed:
                await self.manager.register_seed_peer(RegisterSeedPeerRequest(
                    hostname=self.hostname, ip=self.host_ip,
                    port=self.rpc.port,
                    download_port=self.upload_server.port,
                    object_storage_port=(self.object_gateway.port
                                         if self.object_gateway is not None
                                         else 0),
                    seed_peer_cluster_id=1, topology=self.topology))
                self.manager.start_keepalive(source_type="seed_peer",
                                             hostname=self.hostname,
                                             ip=self.host_ip,
                                             port=self.rpc.port)
            addrs = await self._discover_schedulers()
            if addrs:
                self.scheduler = self._connector(addrs)
            else:
                log.info("manager knows no active schedulers; back-source "
                         "only until the refresh loop finds one")
        except Exception as exc:  # noqa: BLE001 - manager optional
            log.warning("manager attach failed (%s); back-source only", exc)
        if self.cfg.scheduler.refresh_interval_s > 0:
            self._sched_refresh = asyncio.get_running_loop().create_task(
                self._scheduler_refresh_loop())

    async def _scheduler_refresh_loop(self) -> None:
        """Track the manager's scheduler set: a replaced scheduler reaches
        the ring, and a daemon that booted before any scheduler
        registered leaves back-source-only the moment one appears. An
        empty or failed fetch keeps the last known set."""
        while True:
            await asyncio.sleep(self.cfg.scheduler.refresh_interval_s)
            try:
                addrs = await self._discover_schedulers()
            except Exception as exc:  # noqa: BLE001 - manager flaky is fine
                log.debug("scheduler refresh failed: %s", exc)
                continue
            if not addrs:
                continue
            if self.scheduler is None:
                self.scheduler = self._connector(addrs)
                self.ptm.scheduler = self.scheduler
                log.info("schedulers appeared: %s", addrs)
                await asyncio.to_thread(self._restore_scheduler_demotions)
                await self._wire_scheduler_extras()
            elif set(addrs) != set(self.scheduler.addresses):
                log.info("scheduler set changed: %s -> %s",
                         self.scheduler.addresses, addrs)
                self.scheduler.update_addresses(addrs)

    async def _wire_scheduler_extras(self) -> None:
        """The announcer and the RTT prober ride the scheduler connection,
        and the PEX ticker probes its demoted members: wired at boot and
        when the refresh loop adopts a scheduler found later."""
        if self.scheduler is None:
            return
        if self.pex is not None:
            self.pex.scheduler = self.scheduler
        # a scheduler from ``scheduler_factory`` may have neither surface
        if self.announcer is None and hasattr(self.scheduler,
                                              "announce_host"):
            self.announcer = Announcer(self)
            await self.announcer.start()
        if (self.prober is None and self.cfg.probe_enabled
                and hasattr(self.scheduler, "sync_probes")):
            self.prober = NetworkTopologyProber(self)
            await self.prober.start()

    def _demotions_path(self) -> str:
        return os.path.join(self.paths.data_dir, "scheduler_demotions.json")

    def _restore_scheduler_demotions(self) -> None:
        """Re-arm the connector's demotions from the previous process, so
        a restarted daemon does not walk every known-dead scheduler
        through the register timeout again."""
        if self.scheduler is None or not hasattr(self.scheduler,
                                                 "restore_demotions"):
            return
        try:
            with open(self._demotions_path(), "rb") as f:
                state = json.loads(f.read())
        except FileNotFoundError:
            return
        except (OSError, ValueError) as exc:
            log.debug("demotion state unreadable (%s); starting clean", exc)
            return
        self.scheduler.restore_demotions(state)

    def _persist_scheduler_demotions(self) -> None:
        """Write the demotions at stop (tmp, fsync, rename). Best effort:
        shutdown must not fail on a full disk."""
        if self.scheduler is None or not hasattr(self.scheduler,
                                                 "export_demotions"):
            return
        path = self._demotions_path()
        tmp = path + ".tmp"
        try:
            payload = json.dumps(self.scheduler.export_demotions(),
                                 sort_keys=True).encode()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as exc:
            log.debug("demotion persist failed: %s", exc)

    async def stop(self) -> None:
        if self._cert_renewal is not None:
            self._cert_renewal.cancel()
            await asyncio.gather(self._cert_renewal, return_exceptions=True)
            self._cert_renewal = None
        if self.cfg.tracing.enabled:
            tracing.TRACER.flush()
        await self.shaper.stop()
        if self.prober is not None:
            await self.prober.stop()
        if self.pex is not None:
            await self.pex.stop()
        if self.announcer is not None:
            await self.announcer.stop()
        await self.gc.stop()
        if self.object_gateway is not None:
            # drains its async write-backs while the daemon still runs
            await self.object_gateway.stop()
        if self._sched_refresh is not None:
            self._sched_refresh.cancel()
            await asyncio.gather(self._sched_refresh, return_exceptions=True)
        if self.manager is not None:
            await self.manager.close()
        if self.ptm is not None:
            await self.ptm.shutdown()
        if self.proxy_server is not None:
            await self.proxy_server.stop()
        if self.local_rpc is not None:
            await self.local_rpc.stop(0.2)
        if self.rpc is not None:
            await self.rpc.stop(0.2)
        await self.upload_server.stop()
        if self._downloader is not None:
            await self._downloader.close()
        if self._peer_channels is not None:
            await self._peer_channels.close()
        # nothing lands or serves a piece any more: release the tasks'
        # cached data fds, so a removed workdir frees its disk
        self.storage_mgr.close()
        if self.scheduler is not None:
            await asyncio.to_thread(self._persist_scheduler_demotions)
            if hasattr(self.scheduler, "leave_host"):
                await self.scheduler.leave_host()
            if hasattr(self.scheduler, "close"):
                await self.scheduler.close()
        # this loop's pooled origin connections
        await source.close_clients()
        if self._prev_source_tls is not None:
            http, prev = self._prev_source_tls
            http._ssl = prev
            self._prev_source_tls = None
        if self.health is not None:
            self.health.release()
            self.health = None
