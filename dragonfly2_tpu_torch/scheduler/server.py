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
``tracing_otlp`` configure the process's tracer at start. The manager's tenant table
(``ListTenants``) is refreshed on the applications' cadence and enforced
at register (``SchedulerService.tenants``). The config's
cluster id, parent and back-source limits, TTLs and GC cadence reach the
manager link, the announcer, ``Scheduling``, ``SchedulerService`` and
``Resource``. With ``fleetpulse_enabled`` (the default) the fleet pulse
(``fleetpulse.py``) ingests the announces' pulses, fires its anomaly rows
into the decision ledger and sweeps for silent daemons on the GC runner,
next to the resource GC. The quarantine registry
(``quarantine_enabled``, the default) feeds the scheduling filter and
the seed election; the federation view (``federation_enabled``) feeds
the filter, and its eviction hooks chain with shard affinity's. With
``statestore_dir`` the state store (``statestore.py``) journals the
quarantine ladder, the federation's elections, shard affinity's memos,
the fleet pulse's rings, the application table and the boot epoch:
restored before the RPC server starts (a ``recovery`` decision row when
it recovered), persisted on the GC runner when dirty or every
``statestore_interval_s`` and at stop, where with ``statestore_handoff``
and a manager the quarantine/affinity summary is parked with the
manager for a successor to import at its attach (unsigned: the issuance
token is fleet TLS's, item 6); the state store's ``tenants`` component
carries the tenant and application tables. No fleet TLS: a config that
sets one of its keys is refused at construction, by name.
"""

from __future__ import annotations

import asyncio
import logging
import random
import socket

from ..common import tracing
from ..common.config import refuse_unported
from ..common.gc import GC, GCTask
from ..idl.messages import (GetSchedulerStateRequest,
                            RegisterSchedulerRequest,
                            SetSchedulerStateRequest)
from ..rpc.manager_link import ManagerLink
from ..rpc.server import RPCServer
from ..tpu import topology
from .announcer import SchedulerAnnouncer
from .config import KEY_CLASSES, SchedulerConfig, SeedPeerAddr
from .decision_ledger import DecisionLedger
from .evaluator import make_evaluator
from .federation import PodFederation
from .fleetpulse import FleetPulse
from .quarantine import QuarantineRegistry
from .records import DownloadRecords
from .resource import Resource
from .scheduling import Scheduling
from .seed_client import SeedPeerClient
from .service import SchedulerService, build_service
from .shard_affinity import ShardAffinity
from .statestore import SchedulerStateStore
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
            class_fanout_caps=cfg.class_fanout_caps,
            qos_preemption=cfg.qos_preemption,
            candidate_parent_limit=cfg.candidate_parent_limit,
            filter_parent_limit=cfg.filter_parent_limit)
        if records is None and (cfg.records_dir or cfg.trainer_address):
            records = DownloadRecords(cfg.records_dir)
        # decision ledger: every find/refresh ruling explained, with
        # kind=decision rows into records (when kept) for the outcome join
        self.ledger = DecisionLedger(records=records)
        self.scheduling.decision_sink = self.ledger.on_decision
        # pod-wide quarantine registry: corrupt verdicts and self-flags
        # in, offer/relay/seed exclusion out, every transition a row
        self.quarantine = None
        if cfg.quarantine_enabled:
            self.quarantine = QuarantineRegistry(
                corrupt_threshold=cfg.quarantine_corrupt_threshold,
                halflife_s=cfg.quarantine_halflife_s,
                probation_delay_s=cfg.quarantine_probation_delay_s,
                probe_successes=cfg.quarantine_probe_successes,
                probe_children=cfg.quarantine_probe_children,
                min_reporters=cfg.quarantine_min_reporters,
                sink=self.ledger.on_decision)
            self.scheduling.quarantine = self.quarantine
        self.seed_client = SeedPeerClient(self.resource, cfg.seed_peers,
                                          quarantine=self.quarantine)
        # cross-pod federation view: fed from register/announce, consulted
        # by the filter; evicted hosts and tasks leave the electorate
        self.federation = None
        if cfg.federation_enabled:
            self.federation = PodFederation(
                seeds_per_pod=cfg.federation_seeds_per_pod,
                quarantine=self.quarantine,
                sink=self.ledger.on_decision)
            self.scheduling.federation = self.federation
            self.resource.on_host_evict = self.federation.forget_host
            self.resource.on_task_evict = self.federation.drop_task
        # sharded-checkpoint shard affinity: disjoint tree-fetch subsets
        # ruled at register for requests carrying UrlMeta.shards; its
        # eviction hooks chain with the federation's
        self.sharded = None
        if cfg.shard_affinity_enabled:
            self.sharded = ShardAffinity(sink=self.ledger.on_decision)
            self.scheduling.sharded = self.sharded
            prev_host, prev_task = (self.resource.on_host_evict,
                                    self.resource.on_task_evict)

            def _evict_host(hid, _prev=prev_host, _sh=self.sharded):
                _sh.forget_host(hid)
                if _prev is not None:
                    _prev(hid)

            def _evict_task(tid, _prev=prev_task, _sh=self.sharded):
                _sh.drop_task(tid)
                if _prev is not None:
                    _prev(tid)

            self.resource.on_host_evict = _evict_host
            self.resource.on_task_evict = _evict_task
        # crash-survivable control plane: the slow-moving ruling state
        # journals to one snapshot; the dirty mark rides the components'
        # decision sinks
        self.statestore = None
        if cfg.statestore_dir:
            self.statestore = SchedulerStateStore(
                cfg.statestore_dir, interval_s=cfg.statestore_interval_s)
            for name, comp in (("quarantine", self.quarantine),
                               ("federation", self.federation),
                               ("shard_affinity", self.sharded)):
                if comp is not None:
                    self.statestore.register(name, comp.export_state,
                                             comp.restore)
                    comp.sink = self.statestore.wrap_sink(comp.sink)
        # fleet pulse: announce-borne telemetry rings, the EWMA anomaly
        # detector and incident capture (with the quarantine standing and
        # pod); firings ride the decision ledger (decision_kind=anomaly)
        # and the rings survive a restart through the state store
        self.fleetpulse = None
        if cfg.fleetpulse_enabled:
            self.fleetpulse = FleetPulse(sink=self.ledger.on_decision,
                                         quarantine=self.quarantine,
                                         federation=self.federation,
                                         statestore=self.statestore)
            if self.statestore is not None:
                self.statestore.register("fleetpulse",
                                         self.fleetpulse.export_state,
                                         self.fleetpulse.restore)
        self.service = SchedulerService(self.resource, self.scheduling,
                                        self.seed_client, self.topo,
                                        records=records, ledger=self.ledger,
                                        cfg=cfg, fleetpulse=self.fleetpulse,
                                        quarantine=self.quarantine,
                                        federation=self.federation)
        if self.statestore is not None:
            self._register_service_state()
        self.announcer = SchedulerAnnouncer(self)
        self.manager: ManagerLink | None = None
        self.rpc: RPCServer | None = None
        self.port: int | None = None
        self.gc = GC()
        self.gc.add(GCTask("resource", cfg.gc_interval_s, self.resource.gc))
        if self.statestore is not None:
            # the snapshot ticker: maybe_save never raises, so a sick disk
            # shows as an error-result counter, not a dead sweeper
            store = self.statestore
            self.gc.add(GCTask("statestore",
                               min(cfg.statestore_interval_s, 5.0),
                               lambda: int(store.maybe_save())))
        if self.fleetpulse is not None:
            # silent-daemon detection and series aging: a daemon that
            # stops announcing cannot push its own absence
            self.gc.add(GCTask("fleetpulse", cfg.gc_interval_s,
                               self.fleetpulse.tick))
        self._app_refresh: asyncio.Task | None = None

    def _register_service_state(self) -> None:
        """The service's durable slices: the tenant quota and application
        priority tables, and the boot epoch, strictly increasing across
        durable restarts."""
        svc = self.service

        def _export_tenants() -> dict:
            return {"tenants": svc.tenants,
                    "applications": svc.applications}

        def _restore_tenants(sub: dict) -> int:
            # restored quotas hold until the first manager refresh
            # overwrites them: a recovered brain enforces tenant limits
            # from its first ruling
            svc.tenants = dict(sub.get("tenants") or {})
            svc.applications = {k: int(v) for k, v in
                                (sub.get("applications") or {}).items()}
            return len(svc.tenants)

        def _export_meta() -> dict:
            return {"epoch": svc.epoch}

        def _restore_meta(sub: dict) -> int:
            # the daemons' change detection must never see a restart land
            # on the same epoch
            svc.epoch = max(svc.epoch, int(sub.get("epoch", 0)) + 1)
            return 1

        self.statestore.register("tenants", _export_tenants,
                                 _restore_tenants)
        self.statestore.register("meta", _export_meta, _restore_meta)

    @property
    def address(self) -> str:
        return f"{self.cfg.advertise_ip}:{self.port}"

    async def _restore_state(self) -> None:
        """Restore before the first RPC can land: a ruling made on an
        amnesiac view and then corrected by a late restore would be the
        half-applied state the store exists to prevent. A refused or
        missing snapshot is a cold boot."""
        prov = await asyncio.to_thread(self.statestore.restore)
        if not prov.get("recovered"):
            return
        self.service._recovery_seq += 1
        self.ledger.on_decision({
            "kind": "decision",
            "decision_kind": "recovery",
            "decision_id": f"r{self.service._recovery_seq:08d}.snapshot",
            "host_id": "",
            "source": "snapshot",
            "gap_s": prov.get("gap_s", 0.0),
            "components": {
                k: v.get("restored", 0)
                for k, v in (prov.get("components") or {}).items()},
            "scheduler_epoch": self.service.epoch,
            "task_id": "",
            "peer_id": "",
            "candidates": [],
            "excluded": [],
            "chosen": [],
        })

    async def start(self) -> None:
        if self.cfg.tracing_jsonl or self.cfg.tracing_otlp:
            tracing.configure(service="dfscheduler",
                              jsonl_path=self.cfg.tracing_jsonl,
                              otlp_endpoint=self.cfg.tracing_otlp)
        if self.statestore is not None:
            await self._restore_state()
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
                    self.seed_client = SeedPeerClient(
                        self.resource, seeds, quarantine=self.quarantine)
                    self.service.seed_client = self.seed_client
        except Exception as exc:  # noqa: BLE001 - manager optional at boot
            log.warning("manager attach failed (%s); running standalone", exc)
            return
        if self.cfg.statestore_handoff:
            await self._import_handoff()
        # a failed first fetch of the optional applications table must
        # neither mark the attach failed nor stop the refresh
        self._app_refresh = asyncio.get_running_loop().create_task(
            self._app_refresh_loop())

    async def _export_handoff(self) -> None:
        """Graceful stop: park the quarantine/affinity summary with the
        manager, sealed with the PEX envelope codec, so the ring
        successor can warm itself. Unsigned: the signature is an HMAC
        with the fleet's issuance token (item 6), and the manager accepts
        "" as unsigned."""
        if (self.manager is None or self.statestore is None
                or not self.cfg.statestore_handoff):
            return
        from ..daemon.pex import DIGEST_VERSION, seal
        body: dict = {"v": DIGEST_VERSION}
        if self.quarantine is not None:
            body["quarantine"] = self.quarantine.export_state()
        if self.sharded is not None:
            body["shard_affinity"] = self.sharded.export_state()
        if len(body) == 1:
            return
        try:
            await self.manager.set_scheduler_state(SetSchedulerStateRequest(
                scheduler_id=self.address, cluster_id=self.cfg.cluster_id,
                blob=seal(body), signature=""))
        except Exception as exc:  # noqa: BLE001 - handoff is best-effort
            log.debug("handoff export failed: %s", exc)

    async def _import_handoff(self) -> None:
        """Ring-failover successor: import the stopped member's parked
        summary. Imported verdicts land as circumstantial mass through
        ``QuarantineRegistry.import_summary``, which tops out at
        ``suspect``: only first-hand corrupt reports arriving here can
        quarantine. Affinity memos import whole. Without an issuance
        token (item 6) no signature is checked, as in the reference's
        scheduler that holds none."""
        from ..daemon.pex import unseal
        try:
            resp = await self.manager.get_scheduler_state(
                GetSchedulerStateRequest(cluster_id=self.cfg.cluster_id,
                                         exclude=self.address))
        except Exception as exc:  # noqa: BLE001 - older manager: no verb
            log.debug("handoff import unavailable: %s", exc)
            return
        if resp is None or not resp.blob or resp.scheduler_id == self.address:
            return
        body = unseal(resp.blob)
        if body is None:
            log.warning("handoff blob from %s refused: torn/version-skewed",
                        resp.scheduler_id)
            return
        imported = 0
        if self.quarantine is not None \
                and isinstance(body.get("quarantine"), dict):
            imported += self.quarantine.import_summary(
                body["quarantine"], source=resp.scheduler_id)
        if self.sharded is not None \
                and isinstance(body.get("shard_affinity"), dict):
            imported += self.sharded.restore(body["shard_affinity"])
        log.info("handoff import from %s: %d entries warmed",
                 resp.scheduler_id, imported)
        if imported:
            self.service._recovery_seq += 1
            self.ledger.on_decision({
                "kind": "decision",
                "decision_kind": "recovery",
                "decision_id": f"r{self.service._recovery_seq:08d}.handoff",
                "host_id": "",
                "source": "handoff",
                "from_scheduler": resp.scheduler_id,
                "entries_imported": imported,
                "scheduler_epoch": self.service.epoch,
                "task_id": "",
                "peer_id": "",
                "candidates": [],
                "excluded": [],
                "chosen": [],
            })

    async def _refresh_applications(self) -> None:
        """Pull the application priority table into the service (reference
        dynconfig.GetApplications feeding ``Peer.CalculatePriority``), and
        the tenant quota table on the same cadence; each fails on its
        own, so a manager without ``ListTenants`` still feeds
        applications."""
        resp = await self.manager.list_applications()
        self.service.applications = {
            e.name: int(e.priority) for e in (resp.applications or [])}
        try:
            tresp = await self.manager.list_tenants()
        except Exception as exc:  # noqa: BLE001 - older manager: no verb
            log.debug("tenant refresh failed: %s", exc)
            return
        self.service.tenants = {
            t.name: {"qos_class": t.qos_class,
                     "max_running": int(t.max_running),
                     "shed_retry_after_ms": int(t.shed_retry_after_ms)}
            for t in (tresp.tenants or [])}

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
        if self.statestore is not None:
            # final snapshot and the manager handoff before the link
            # closes; both swallow failures
            await asyncio.to_thread(self.statestore.save,
                                    reason="shutdown")
            await self._export_handoff()
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
