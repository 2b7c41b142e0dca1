"""Scheduler bootstrap: wire resource, scheduling, seed client, GC, RPC.

Counterpart of ``dragonfly2_tpu/scheduler/server.py`` (reference
``scheduler/scheduler.go`` ``New``/``Serve``): the decision ledger always
observes the rulings; download records are kept when ``records_dir`` or
``trainer_address`` is set, and the announcer uploads them to the
trainer. With ``manager_addresses`` the scheduler registers with the
manager, keeps alive, adopts the manager's seed peers when none are
configured, refreshes the application priority table, and the announcer
pulls fitted models from the registry. Shard affinity
(``shard_affinity_enabled``) rules sharded registers with the ledger as
its sink and forgets evicted hosts and tasks. ``tracing_jsonl`` /
``tracing_otlp`` configure the process's tracer at start. The config's
cluster id, parent and back-source limits, TTLs and GC cadence reach the
manager link, the announcer, ``Scheduling``, ``SchedulerService`` and
``Resource``. With ``fleetpulse_enabled`` (the default) the fleet pulse
(``fleetpulse.py``) ingests the announces' pulses, fires its anomaly rows
into the decision ledger and sweeps for silent daemons on the GC runner,
next to the resource GC. No quarantine, federation, state store or tenant
table: a config that sets one of their keys is refused at construction,
by name.
"""

from __future__ import annotations

import asyncio
import logging
import random
import socket

from ..common import tracing
from ..common.config import refuse_unported
from ..common.gc import GC, GCTask
from ..idl.messages import RegisterSchedulerRequest
from ..rpc.manager_link import ManagerLink
from ..rpc.server import RPCServer
from ..tpu import topology
from .announcer import SchedulerAnnouncer
from .config import KEY_CLASSES, SchedulerConfig, SeedPeerAddr
from .decision_ledger import DecisionLedger
from .evaluator import make_evaluator
from .fleetpulse import FleetPulse
from .records import DownloadRecords
from .resource import Resource
from .scheduling import Scheduling
from .seed_client import SeedPeerClient
from .service import SchedulerService, build_service
from .shard_affinity import ShardAffinity
from .topology_store import TopologyStore

log = logging.getLogger("df.sched.server")


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, *,
                 rng: random.Random | None = None, records=None):
        refuse_unported(cfg, KEY_CLASSES)
        self.cfg = cfg
        self.resource = Resource(peer_upload_limit=cfg.peer_upload_limit,
                                 seed_upload_limit=cfg.seed_upload_limit,
                                 peer_ttl_s=cfg.peer_ttl_s,
                                 task_ttl_s=cfg.task_ttl_s,
                                 host_ttl_s=cfg.host_ttl_s)
        self.topo = TopologyStore()
        self.scheduling = Scheduling(
            make_evaluator(cfg.algorithm, topo_store=self.topo), rng=rng,
            relay_fanout=cfg.relay_fanout,
            candidate_parent_limit=cfg.candidate_parent_limit,
            filter_parent_limit=cfg.filter_parent_limit)
        self.seed_client = SeedPeerClient(self.resource, cfg.seed_peers)
        if records is None and (cfg.records_dir or cfg.trainer_address):
            records = DownloadRecords(cfg.records_dir)
        # decision ledger: every find/refresh ruling explained, with
        # kind=decision rows into records (when kept) for the outcome join
        self.ledger = DecisionLedger(records=records)
        self.scheduling.decision_sink = self.ledger.on_decision
        # sharded-checkpoint shard affinity: disjoint tree-fetch subsets
        # ruled at register for requests carrying UrlMeta.shards
        self.sharded = None
        if cfg.shard_affinity_enabled:
            self.sharded = ShardAffinity(sink=self.ledger.on_decision)
            self.scheduling.sharded = self.sharded
            self.resource.on_host_evict = self.sharded.forget_host
            self.resource.on_task_evict = self.sharded.drop_task
        # fleet pulse: announce-borne telemetry rings, the EWMA anomaly
        # detector and incident capture; firings ride the decision ledger
        # (decision_kind=anomaly). The quarantine, federation and state
        # store it can report on are not ported yet (items 5a, 5c)
        self.fleetpulse = None
        if cfg.fleetpulse_enabled:
            self.fleetpulse = FleetPulse(sink=self.ledger.on_decision)
        self.service = SchedulerService(self.resource, self.scheduling,
                                        self.seed_client, self.topo,
                                        records=records, ledger=self.ledger,
                                        cfg=cfg, fleetpulse=self.fleetpulse)
        self.announcer = SchedulerAnnouncer(self)
        self.manager: ManagerLink | None = None
        self.rpc: RPCServer | None = None
        self.port: int | None = None
        self.gc = GC()
        self.gc.add(GCTask("resource", cfg.gc_interval_s, self.resource.gc))
        if self.fleetpulse is not None:
            # silent-daemon detection and series aging: a daemon that
            # stops announcing cannot push its own absence
            self.gc.add(GCTask("fleetpulse", cfg.gc_interval_s,
                               self.fleetpulse.tick))
        self._app_refresh: asyncio.Task | None = None

    @property
    def address(self) -> str:
        return f"{self.cfg.advertise_ip}:{self.port}"

    async def start(self) -> None:
        if self.cfg.tracing_jsonl or self.cfg.tracing_otlp:
            tracing.configure(service="dfscheduler",
                              jsonl_path=self.cfg.tracing_jsonl,
                              otlp_endpoint=self.cfg.tracing_otlp)
        self.rpc = RPCServer(f"{self.cfg.listen_ip}:{self.cfg.port}")
        self.rpc.register(build_service(self.service))
        await self.rpc.start()
        self.port = self.rpc.port
        if self.cfg.manager_addresses:
            await self._attach_manager()
        self.gc.start()
        self.announcer.start()
        log.info("scheduler up on %s (cluster=%d, algorithm=%s, seeds=%d)",
                 self.address, self.cfg.cluster_id, self.cfg.algorithm,
                 len(self.seed_client.seed_peers))

    async def _attach_manager(self) -> None:
        """Register with the manager, keep alive, and adopt its seed-peer
        set when none is configured statically. A failed attach leaves
        the scheduler running standalone, as the reference does."""
        hostname = socket.gethostname()
        self.manager = ManagerLink(
            self.cfg.manager_addresses,
            keepalive_interval_s=self.cfg.keepalive_interval_s)
        try:
            # the device probe can take seconds on a cold runtime: off-loop
            topo = await asyncio.to_thread(topology.detect)
            await self.manager.register_scheduler(RegisterSchedulerRequest(
                hostname=hostname, ip=self.cfg.advertise_ip, port=self.port,
                scheduler_cluster_id=self.cfg.cluster_id,
                topology=topo))
            self.manager.start_keepalive(source_type="scheduler",
                                         hostname=hostname,
                                         ip=self.cfg.advertise_ip,
                                         cluster_id=self.cfg.cluster_id,
                                         port=self.port)
            if not self.cfg.seed_peers:
                resp = await self.manager.get_seed_peers()
                seeds = [SeedPeerAddr(host_id=f"{e.hostname}-{e.ip}",
                                      ip=e.ip, rpc_port=e.port,
                                      download_port=e.download_port)
                         for e in (resp.seed_peers or [])]
                if seeds:
                    await self.seed_client.close()
                    self.seed_client = SeedPeerClient(self.resource, seeds)
                    self.service.seed_client = self.seed_client
        except Exception as exc:  # noqa: BLE001 - manager optional at boot
            log.warning("manager attach failed (%s); running standalone", exc)
            return
        # a failed first fetch of the optional applications table must
        # neither mark the attach failed nor stop the refresh
        self._app_refresh = asyncio.get_running_loop().create_task(
            self._app_refresh_loop())

    async def _refresh_applications(self) -> None:
        """Pull the application priority table into the service (reference
        dynconfig.GetApplications feeding ``Peer.CalculatePriority``)."""
        resp = await self.manager.list_applications()
        self.service.applications = {
            e.name: int(e.priority) for e in (resp.applications or [])}

    async def _app_refresh_loop(self) -> None:
        while True:
            try:
                await self._refresh_applications()
            except Exception as exc:  # noqa: BLE001 - manager flaky is fine
                log.debug("application refresh failed: %s", exc)
            await asyncio.sleep(self.cfg.keepalive_interval_s * 6)

    async def stop(self) -> None:
        if self._app_refresh is not None:
            self._app_refresh.cancel()
            await asyncio.gather(self._app_refresh, return_exceptions=True)
        await self.announcer.stop()
        if self.manager is not None:
            await self.manager.close()
        await self.gc.stop()
        for t in list(self.service._seed_tasks):
            t.cancel()
        await asyncio.gather(*self.service._seed_tasks,
                             return_exceptions=True)
        await self.seed_client.close()
        if self.rpc is not None:
            await self.rpc.stop(0.5)
        if self.service.records is not None:
            await self.service.records.aclose()
