"""Scheduler RPC service: register / report / announce / leave / stat.

Counterpart of ``dragonfly2_tpu/scheduler/service.py`` (reference
``scheduler/service/service_v1.go``): RegisterPeerTask with size-scope
dispatch (:1005-1110), the ReportPieceResult bidi stream driving
reschedules (:187), piece success/failure handling (:1159, :1210),
ReportPeerResult, AnnounceHost (:478), StatTask, LeaveHost, LeavePeer,
the probers' SyncProbes stream (the RTTs the ``nt`` evaluator reads) and
AnnounceContent, the recovery re-announce: a daemon that saw the boot
epoch change replays what it holds, sealed as a PEX digest; a torn or
unsealed digest is refused whole, and an adopted one creates a
``<host>-recov-<task>`` holder peer per task and a ``recovery`` row in
the decision ledger. Both announces hand their pulse to the fleet pulse
(``fleetpulse.py``), as the reference's do. The quarantine registry
(``quarantine``) hears each register's and announce's self-quarantine
flag (``record_self``), clean pieces off a parent (``record_ok``) and
``corrupt`` piece verdicts (``record_corrupt``); the federation view
(``federation``) learns each host's pod on register and on both
announces (``observe_host``) and forgets a host whose report stream died
mid-task (``forget_host``).

Back-source arbitration: a child with no viable parents is not sent to
origin at once. While a seed trigger is in flight, or peers hold content
whose upload slots are full, the scheduler retries on a short interval and
rules NeedBackSource only when patience runs out or nothing can feed the
child (``_schedule_with_patience``).

A register that names shards (``UrlMeta.shards``) gets its disjoint
tree-fetch subset (``RegisterResult.assigned_shards``) from the shard
affinity arm, ruled as it arrives, as the reference rules it. Unlike the
reference, which leaves an earlier replica with the ruling of its own
register (the first of a group is ruled solo and tree-fetches
everything), the port then rules the group's earlier members again and
pushes each changed ruling on the member's report stream
(``PeerPacket.assigned_shards``).

Download records (``records``: piece, failed-piece and peer rows, the
trainer's dataset) are written where the reference writes them, and so
are the cluster view's (``cluster_view.py``, ``GET /debug/cluster``). A
register and a stream's first offer are spans of the caller's trace
(``sched.register``, ``sched.offer``), and an armed ruling profiler
notes each first offer's queue wait.

QoS: a register's class is its request's, else its tenant's default
(``tenants``, the manager's table), else ``standard``; a tenant at its
``max_running`` is refused before the peer exists (RESOURCE_EXHAUSTED
with the row's retry-after, ``df_qos_quota_shed_total``). A ``critical``
child that finds no content holder (an empty or holderless offer in the
patience loop, a refresh, a reschedule) may preempt one bulk edge
(``Scheduling.preempt_for``); the victim is pushed its shrunk offer.

The manager's jobs reach the scheduler through two verbs. ``Preheat``
warms a URL into the seed layer under the task id a register of the same
URL and ``UrlMeta`` computes, so a later pull joins the preheated task;
a preheat of a task whose seed job still runs joins that job (``wait``
awaits it shielded, so a caller that goes away leaves it running), and
one whose seed failed re-triggers it. ``SyncPeers`` lists the live hosts.

A report stream that ends with the daemon's half-close is not marked
``stream_gone``: the daemon half-closes only on its way to the terminal
PeerResult, and a replica that finished its subset keeps serving its
partner in that gap (the reference excludes the peer until the result
lands).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import AsyncIterator

from ..common import ids, phasetimer, tracing
from ..common.errors import Code, DFError
from ..common.metrics import REGISTRY
from ..common.sharding import parse_shard_names
from ..idl.messages import (CLASS_DEFAULT_PRIORITY, PRIORITY_CLASSES,
                            AnnounceContentRequest, AnnounceContentResponse,
                            AnnounceHostRequest, AnnounceHostResponse,
                            Empty, HostType, LeaveHostRequest,
                            LeavePeerRequest,
                            PeerPacket, PeerResult, PieceResult,
                            PreheatRequest, PreheatResponse, Priority,
                            ProbeTarget, RegisterPeerTaskRequest,
                            RegisterResult, SinglePiece, SizeScope,
                            StatTaskRequest, SyncPeersRequest,
                            SyncPeersResponse, SyncProbesResponse, TaskStat,
                            UrlMeta, resolve_class)
from ..rpc.server import ServiceDef, span_parent
from .cluster_view import ClusterView
from .config import SchedulerConfig
from .resource import Peer, PeerState, Resource, TaskState
from .scheduling import Scheduling
from .seed_client import SeedPeerClient
from .topology_store import TopologyStore

log = logging.getLogger("df.sched.service")

SCHEDULER_SERVICE = "df.scheduler.Scheduler"

_registers = REGISTRY.counter("df_sched_register_total",
                              "peer task registrations", ("scope",))
_schedules = REGISTRY.counter("df_sched_schedule_total",
                              "scheduling decisions", ("kind",))
_piece_reports = REGISTRY.counter("df_sched_piece_report_total",
                                  "piece results received", ("result",))
_quota_sheds = REGISTRY.counter(
    "df_qos_quota_shed_total",
    "registers rejected by a tenant's max_running quota "
    "(RESOURCE_EXHAUSTED + retry-after; HTTP surfaces answer 429)",
    ("tenant",))
_recovery_announces = REGISTRY.counter(
    "df_sched_recovery_announces_total",
    "daemon content re-announces after a scheduler epoch change, by "
    "outcome (adopted = holdings merged into the resource view, "
    "rejected = torn/unsealed digest refused wholesale)", ("result",))

SCHEDULE_RETRY_INTERVAL_S = 0.25
SCHEDULE_PATIENCE_S = 10.0
# re-fires of a broken seed trigger per task, with exponential backoff
SEED_RETRIGGER_LIMIT = 6
SEED_RETRIGGER_BACKOFF_CAP_S = 30.0


class SchedulerService:
    REFRESH_INTERVAL_S = 0.5

    def __init__(self, cfg: SchedulerConfig, resource: Resource,
                 scheduling: Scheduling, seed_client: SeedPeerClient,
                 topo: TopologyStore, *, records=None, ledger=None,
                 quarantine=None, federation=None, fleetpulse=None):
        # the back-source and parent limits (the rest of the config is
        # the server's business)
        self.cfg = cfg
        self.resource = resource
        self.scheduling = scheduling
        self.seed_client = seed_client
        self.topo = topo
        # scheduler/records.DownloadRecords, or None (no dataset kept)
        self.records = records
        self.ledger = ledger            # decision ledger (recovery rows)
        # scheduler/fleetpulse.FleetPulse: ingests the announces' pulses
        self.fleetpulse = fleetpulse
        # scheduler/quarantine.QuarantineRegistry: fed corrupt verdicts
        # and self-flags here; None = no immune system
        self.quarantine = quarantine
        # scheduler/federation.PodFederation: fed host pods from register
        # and announce, forgets on a dead stream; None = one flat pod
        self.federation = federation
        # per-host download view of piece reports and flight summaries
        # (GET /debug/cluster)
        self.cluster = ClusterView(ledger=ledger, quarantine=quarantine)
        self._recovery_seq = 0
        self._seed_tasks: set[asyncio.Task] = set()
        # boot epoch, echoed on register/announce so daemons can tell a
        # restarted scheduler
        self.epoch = int(time.time())
        # rulings made: offers, refreshes and back-source verdicts
        self.rulings = 0
        # application -> priority (the manager's table, refreshed by the
        # server); consulted when a register carries no explicit priority
        self.applications: dict[str, int] = {}
        # tenant -> quota row ({"qos_class", "max_running",
        # "shed_retry_after_ms"}), the manager's tenants table on the same
        # cadence; enforced at register
        self.tenants: dict[str, dict] = {}

    # ------------------------------------------------------------------
    # RegisterPeerTask
    # ------------------------------------------------------------------

    async def register_peer_task(self, req: RegisterPeerTaskRequest,
                                 context) -> RegisterResult:
        # the daemon's traceparent rides the call metadata: the ruling
        # joins the task's trace, which also covers the piece fetches and
        # the device landing
        with tracing.span("sched.register", parent=span_parent(context),
                          task_id=req.task_id[:16],
                          peer_id=req.peer_id[-16:]):
            return await self._register_peer_task(req, context)

    async def _register_peer_task(self, req: RegisterPeerTaskRequest,
                                  context) -> RegisterResult:
        if not req.task_id or not req.peer_id or req.peer_host is None:
            raise DFError(Code.INVALID_ARGUMENT,
                          "task_id, peer_id, peer_host required")
        task = self.resource.get_or_create_task(req.task_id, req.url)
        if task.state != TaskState.RUNNING:
            task.transit(TaskState.RUNNING)
        qos_class, tenant = self._resolve_class(req.url_meta)
        resolved_priority = self._resolve_priority(req.url_meta,
                                                   qos_class=qos_class)
        if resolved_priority == int(Priority.LEVEL1):
            # reference service_v2.go: LEVEL1 = download forbidden, checked
            # before the peer exists so a retrying client grows nothing
            raise DFError(Code.SCHED_FORBIDDEN,
                          "download forbidden by priority (LEVEL1)")
        # the tenant's quota, checked before the peer exists for the same
        # reason. Seed hosts are exempt: a seed's register replays the
        # client's UrlMeta, and billing it to the tenant would shed the
        # very pull that lets the admitted download finish P2P
        if req.peer_host.type == HostType.NORMAL:
            self._enforce_tenant_quota(tenant)
        if self.quarantine is not None:
            # the self-quarantine flag rides every register: a daemon that
            # found its own bit rot is excluded from its first contact
            self.quarantine.record_self(
                req.peer_host.id, req.peer_host.quarantined,
                reason="self-quarantine flag on register")
        if self.federation is not None:
            # per-pod seed elections need the membership before the first
            # cross-pod ruling, not an announce later
            self.federation.observe_host(req.peer_host.id,
                                         req.peer_host.topology)
        host = self.resource.store_host(req.peer_host)
        peer = self.resource.get_or_create_peer(req.peer_id, task, host)
        peer.priority = resolved_priority
        peer.qos_class = qos_class
        peer.tenant = tenant
        if peer.state == PeerState.PENDING:
            peer.transit(PeerState.RUNNING)

        # first peer of an unseeded task fires the seed trigger; LEVEL2
        # peers go straight to origin, so seeding too would pull twice
        if task.url_meta is None:
            task.url_meta = req.url_meta
        if (not task.seed_triggered and self.seed_client.available()
                and resolved_priority != int(Priority.LEVEL2)
                and not task.has_available_peer()):
            self._fire_seed_trigger(task, req.url_meta)

        assigned = None
        if req.url_meta is not None and req.url_meta.shards:
            # sharded task: this peer's disjoint tree-fetch subset of its
            # requested shards; the rest arrive by swap from co-located
            # replicas. None (arm disabled) leaves the field off the wire
            names = parse_shard_names(req.url_meta.shards)
            assigned = self.scheduling.shard_assignment(peer, names)
            if assigned is not None:
                peer.shard_request, peer.assigned_shards = names, assigned
                self._rerule_partners(peer)
        scope = task.size_scope()
        result = RegisterResult(task_id=task.id, size_scope=SizeScope.NORMAL,
                                content_length=task.content_length,
                                piece_size=task.piece_size,
                                resolved_priority=Priority(resolved_priority),
                                scheduler_epoch=self.epoch,
                                assigned_shards=assigned)
        if scope == SizeScope.EMPTY:
            result.size_scope = SizeScope.EMPTY
        elif scope == SizeScope.SMALL:
            single = self._single_piece_parent(peer)
            if single is not None:
                result.size_scope = SizeScope.SMALL
                result.single_piece = single
        _registers.labels(result.size_scope.name).inc()
        return result

    def _rerule_partners(self, peer: Peer) -> None:
        """``peer``'s register grew its group: rule each earlier sharded
        member of the task in that group again, and push a ruling that
        changed. A member whose report stream is not open yet gets it as
        the stream's first packet."""
        group = self.scheduling.sharded.group_of
        mine = group(peer.host.msg.topology)
        for other in list(peer.task.peers.values()):
            if (other is peer or other.shard_request is None
                    or other.is_done() or other.stream_gone
                    or group(other.host.msg.topology) != mine):
                continue
            assigned = self.scheduling.shard_assignment(other,
                                                        other.shard_request)
            if assigned == other.assigned_shards:
                continue
            other.assigned_shards = assigned
            if other.packet_sink is not None:
                other.packet_sink.put_nowait(self._ruling_packet(other))
            else:
                other.shard_push_pending = True

    @staticmethod
    def _ruling_packet(peer: Peer) -> PeerPacket:
        return PeerPacket(task_id=peer.task.id, src_peer_id=peer.id,
                          advisory=True,
                          assigned_shards=list(peer.assigned_shards))

    def _single_piece_parent(self, child: Peer) -> SinglePiece | None:
        info = child.task.pieces.get(0)
        if info is None:
            return None
        parents = self.scheduling.find_parents(child)
        if not parents:
            return None
        p = parents[0]
        return SinglePiece(
            dst_peer_id=p.id,
            dst_addr=f"{p.host.msg.ip}:{p.host.msg.download_port}",
            piece_info=info)

    def _resolve_priority(self, url_meta, *,
                          qos_class: str = "standard") -> int:
        """Reference ``Peer.CalculatePriority``: an explicit request value
        wins; LEVEL0 (unset) falls through to the manager's application
        table, then to the QoS class's default."""
        if url_meta is not None \
                and int(url_meta.priority) != int(Priority.LEVEL0):
            return int(url_meta.priority)
        if url_meta is not None and url_meta.application:
            prio = self.applications.get(url_meta.application)
            if prio is not None:
                return int(prio)
        return CLASS_DEFAULT_PRIORITY.get(qos_class, int(Priority.LEVEL0))

    def _resolve_class(self, url_meta) -> tuple[str, str]:
        """(qos_class, tenant) for a register: the request's class wins; a
        classless request of a known tenant takes the tenant's default
        class; everything else is ``standard``."""
        tenant = url_meta.tenant if url_meta is not None else ""
        raw = url_meta.qos_class if url_meta is not None else ""
        if raw in PRIORITY_CLASSES:
            return raw, tenant
        row = self.tenants.get(tenant) if tenant else None
        if row and row.get("qos_class") in PRIORITY_CLASSES:
            return row["qos_class"], tenant
        return resolve_class(raw), tenant

    TENANT_SHED_RETRY_MS = 2000

    def _enforce_tenant_quota(self, tenant: str) -> None:
        """``max_running``: the tenant's live peers (not terminal, not
        stale, not on a seed host) across every task, counted on demand:
        a register is not the hot path, and a counter kept across GC and
        stream deaths would drift when it matters."""
        row = self.tenants.get(tenant) if tenant else None
        if not row:
            return
        limit = int(row.get("max_running") or 0)
        if limit <= 0:
            return
        stale_after = time.time() - 300.0
        running = 0
        for task in self.resource.tasks.values():
            for p in task.peers.values():
                if (p.tenant != tenant or p.is_done()
                        or p.host.msg.type != HostType.NORMAL):
                    continue
                # a crashed peer's stream is gone and its clock stops: it
                # must not hold quota until its TTL
                if p.stream_gone or p.updated_at < stale_after:
                    continue
                running += 1
                if running >= limit:
                    _quota_sheds.labels(tenant).inc()
                    exc = DFError(
                        Code.RESOURCE_EXHAUSTED,
                        f"tenant {tenant!r} at max_running={limit}; "
                        f"retry later")
                    exc.retry_after_ms = int(
                        row.get("shed_retry_after_ms") or 0) \
                        or self.TENANT_SHED_RETRY_MS
                    raise exc

    # ------------------------------------------------------------------
    # ReportPieceResult (bidi stream)
    # ------------------------------------------------------------------

    async def report_piece_result(self, request_iter,
                                  context) -> AsyncIterator[PeerPacket]:
        first: PieceResult | None = None
        async for msg in request_iter:
            first = msg
            break
        if first is None:
            return
        peer = self.resource.find_peer(first.task_id, first.src_peer_id)
        if peer is None:
            raise DFError(Code.SCHED_REREGISTER,
                          f"unknown peer {first.src_peer_id[-12:]}")
        sink: asyncio.Queue[PeerPacket | None] = asyncio.Queue()
        peer.packet_sink = sink
        peer.stream_gone = False      # live again: a fresh report stream
        if peer.shard_push_pending:
            peer.shard_push_pending = False
            sink.put_nowait(self._ruling_packet(peer))

        async def consume() -> None:
            try:
                async for result in request_iter:
                    await self._handle_piece_result(peer, result)
            except Exception as exc:  # noqa: BLE001 - client went away
                log.debug("report stream from %s ended: %s",
                          peer.id[-12:], exc)
            finally:
                sink.put_nowait(None)

        loop = asyncio.get_running_loop()
        consumer = loop.create_task(consume())
        scheduler_task = loop.create_task(
            self._schedule_with_patience(peer, sink))
        refresher = loop.create_task(self._refresh_loop(peer))
        # the daemon opened this stream inside its peertask span: mark the
        # first offer (parents or a back-source verdict) in that trace
        offer_parent = span_parent(context) if context is not None else None
        first_offer = True
        try:
            while True:
                packet = await sink.get()
                if packet is None:
                    break
                if first_offer:
                    first_offer = False
                    with tracing.span("sched.offer", parent=offer_parent,
                                      task_id=peer.task.id[:16],
                                      code=packet.code):
                        pass
                yield packet
        finally:
            # mark before the first await: a caller that goes away ends
            # this loop and then cancels the handler, which would cut the
            # gather below short
            if peer.packet_sink is sink:
                peer.packet_sink = None
                if not peer.is_done() and not (context is not None
                                               and context.half_closed):
                    # the stream died with the peer mid-download: stop
                    # offering it as a parent now (a late unary report or
                    # a fresh stream clears the mark)
                    peer.stream_gone = True
                    log.info("peer %s report stream gone mid-task",
                             peer.id[-12:])
                    if self.federation is not None:
                        # a likely-dead host stops winning pod-seed
                        # elections now; its next announce re-admits it
                        self.federation.forget_host(peer.host.id)
            scheduler_task.cancel()
            consumer.cancel()
            refresher.cancel()
            await asyncio.gather(consumer, scheduler_task, refresher,
                                 return_exceptions=True)

    async def _refresh_loop(self, peer: Peer) -> None:
        """Periodic sticky re-offer while the report stream is open; no
        push when the best sticky set is unchanged."""
        while True:
            await asyncio.sleep(self.REFRESH_INTERVAL_S)
            if peer.is_done() or peer.state == PeerState.BACK_SOURCE:
                return
            self._maybe_retrigger_seed(peer.task)
            await self._refresh_parents(peer)
            if (peer.qos_class == "critical" and peer.last_offer_ids
                    and not any(
                        p is not None and p.has_content()
                        for p in (peer.task.peers.get(pid)
                                  for pid in peer.last_offer_ids))):
                # starving mid-download: every offered parent is a
                # pieceless sibling while holders sit slot-full behind
                # bulk edges. The patience loop's preemption rule, on the
                # refresh cadence
                victim = self.scheduling.preempt_for(peer)
                if victim is not None:
                    await self._push_victim_packet(victim)
                    await self._refresh_parents(peer)

    async def _schedule_with_patience(self, peer: Peer,
                                      sink: asyncio.Queue) -> None:
        """Initial scheduling loop: try now, retry while content is coming,
        rule back-source when patience ends. LEVEL2 peers go straight to
        origin (reference: 'Peer is first to download back-to-source')."""
        if peer.priority == int(Priority.LEVEL2):
            packet = self._rule_back_source(peer)
            if packet is not None:
                sink.put_nowait(packet)
            return
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        deadline = t0 + SCHEDULE_PATIENCE_S
        while True:
            if peer.is_done() or peer.state == PeerState.BACK_SOURCE:
                return
            if peer.schedule_count == 0 and not peer.has_content():
                # a refresh may have offered this peer, registered but not
                # yet ruled and holding nothing, to another as a parent
                # (as the reference's does): that edge makes every peer
                # above it its descendant, and this ruling would find them
                # all cycle-blocked, until they finish while upload slots
                # are scarce. It has nothing to give yet: drop the edges
                peer.task.detach_children(peer.id)
            parents = self.scheduling.find_parents(peer)
            if parents and not any(p.has_content() for p in parents):
                # a holderless offer (pieceless siblings only): a critical
                # child starving because every holder is slot-full may
                # evict one bulk edge and be ruled again now
                victim = self.scheduling.preempt_for(peer)
                if victim is not None:
                    await self._push_victim_packet(victim)
                    continue
            if parents:
                if phasetimer.ARMED:
                    # queue wait: the stream's arrival -> this offer (the
                    # ruling's own compute is microseconds against the
                    # retry ticks that dominate a queued child)
                    phasetimer.note_queue_wait(loop.time() - t0)
                self._offer(peer, parents, "parents")
                sink.put_nowait(self.scheduling.build_packet(peer, parents))
                return
            # QoS preemption, empty-offer form: no legal parent at all
            victim = self.scheduling.preempt_for(peer)
            if victim is not None:
                await self._push_victim_packet(victim)
                continue
            self._maybe_retrigger_seed(peer.task)
            seed_pending = (peer.task.seed_job is not None
                            and not peer.task.seed_job.done())
            # feeders: content is coming even though no parent is legal
            # right now (seed still pulling, or holders' slots are full)
            feeders = seed_pending or peer.task.has_available_peer()
            if loop.time() >= deadline or not feeders:
                packet = self._rule_back_source(peer)
                if packet is not None:
                    sink.put_nowait(packet)
                return
            await asyncio.sleep(SCHEDULE_RETRY_INTERVAL_S)

    def _offer(self, peer: Peer, parents: list[Peer], kind: str) -> None:
        peer.schedule_count += 1
        peer.last_offer_ids = {p.id for p in parents}
        peer.task.set_parents(peer.id, [p.id for p in parents])
        _schedules.labels(kind).inc()
        self.rulings += 1
        log.debug("%s %s -> parents %s", kind, peer.id[-12:],
                  [p.id[-12:] for p in parents])

    def _fire_seed_trigger(self, task, url_meta) -> None:
        """Start (or restart) the seed ObtainSeeds job for a task."""
        task.seed_triggered = True
        t = asyncio.get_running_loop().create_task(
            self.seed_client.trigger(task, url_meta))
        task.seed_job = t
        self._seed_tasks.add(t)
        t.add_done_callback(self._seed_tasks.discard)

    def _maybe_retrigger_seed(self, task) -> None:
        """The seed can die mid-injection: the pieces it never announced
        exist nowhere. When the swarm provably cannot complete and no
        trigger is in flight, re-fire it (bounded, with backoff)."""
        seed_pending = task.seed_job is not None and not task.seed_job.done()
        now = asyncio.get_running_loop().time()
        if (seed_pending or not task.seed_triggered
                or not self.seed_client.available()
                or task.seed_retries >= SEED_RETRIGGER_LIMIT
                or now < task.seed_next_retry_at):
            return
        suspect = any(p.stream_gone or p.state in (PeerState.FAILED,
                                                   PeerState.LEAVING)
                      for p in task.peers.values())
        if not suspect and task.has_live_available_peer():
            return
        if task.total_piece_count > 0:
            gap = not task.swarm_can_complete()
        else:
            gap = not task.has_live_available_peer()
        if not gap:
            return
        task.seed_retries += 1
        task.seed_next_retry_at = now + min(2.0 ** task.seed_retries,
                                            SEED_RETRIGGER_BACKOFF_CAP_S)
        log.warning("task %s has an uncoverable piece gap and no live seed "
                    "job; re-trigger %d/%d", task.id[:12], task.seed_retries,
                    SEED_RETRIGGER_LIMIT)
        self._fire_seed_trigger(task, task.url_meta)

    def _back_source_class_load(self, priority: int) -> int:
        """Active back-source peers that count against a requester of this
        priority: equal-or-higher-priority holders only."""
        n = 0
        stale_after = time.time() - 300.0
        for task in self.resource.tasks.values():
            for pid in task.back_source_peers:
                p = task.peers.get(pid)
                if p is None or p.state != PeerState.BACK_SOURCE \
                        or p.priority > priority:
                    continue
                if p.stream_gone or p.updated_at < stale_after:
                    continue
                n += 1
        return n

    def _rule_back_source(self, peer: Peer) -> PeerPacket | None:
        task = peer.task
        self.rulings += 1
        if len(task.back_source_peers) >= self.cfg.back_source_concurrent:
            _schedules.labels("busy").inc()
            return PeerPacket(task_id=task.id, src_peer_id=peer.id,
                              code=int(Code.SCHED_TASK_STATUS_ERROR))
        if (self._back_source_class_load(peer.priority)
                >= self.cfg.back_source_total):
            _schedules.labels("busy_global").inc()
            return PeerPacket(task_id=task.id, src_peer_id=peer.id,
                              code=int(Code.SCHED_TASK_STATUS_ERROR))
        try:
            peer.transit(PeerState.BACK_SOURCE)
        except DFError:
            return None
        # slot held while the peer back-sources; released on its terminal
        # result or departure
        task.back_source_peers.add(peer.id)
        task.set_parents(peer.id, [])
        peer.last_offer_ids = set()
        _schedules.labels("back_source").inc()
        return PeerPacket(task_id=task.id, src_peer_id=peer.id,
                          code=int(Code.SCHED_NEED_BACK_SOURCE))

    async def _handle_piece_result(self, peer: Peer,
                                   result: PieceResult) -> None:
        peer.touch()
        task = peer.task
        # endgame duplicate racers both report the same piece; the cluster
        # view counts delivered bytes once
        duplicate = (result.success and result.piece_info is not None
                     and result.piece_info.piece_num in peer.finished_pieces)
        if not duplicate:
            self.cluster.on_piece(peer, result)
        if result.success:
            _piece_reports.labels("ok").inc()
            if result.piece_info is not None:
                task.record_piece(result.piece_info)
                peer.finished_pieces.add(result.piece_info.piece_num)
                peer.observe_piece_cost(result.piece_info.download_cost_ms)
            if result.dst_peer_id:
                parent = task.peers.get(result.dst_peer_id)
                if parent is not None:
                    parent.host.observe_upload(True)
                    if self.quarantine is not None:
                        # probation reprieve: a clean piece off this host
                        # counts toward its climb back to healthy
                        self.quarantine.record_ok(parent.host.id)
            if self.records is not None and result.piece_info is not None:
                self.records.on_piece(peer, result)
            if len(peer.finished_pieces) == 1:
                # this peer just became a usable parent: top up every child
                # still short on parents now
                for sibling in list(peer.task.peers.values()):
                    if (sibling.id != peer.id and not sibling.is_done()
                            and len(sibling.last_offer_ids)
                            < self.cfg.candidate_parent_limit):
                        await self._refresh_parents(sibling)
            return
        _piece_reports.labels("fail").inc()
        peer.report_fail_count += 1
        if result.dst_peer_id:
            parent = task.peers.get(result.dst_peer_id)
            if parent is not None:
                parent.host.observe_upload(False)
                if (self.quarantine is not None
                        and result.fail_code == "corrupt"):
                    # hard evidence, promoted cross-task into the pod-wide
                    # ladder (stall/timeout/refused stay congestion-shaped)
                    self.quarantine.record_corrupt(
                        parent.host.id, task_id=task.id,
                        reporter=peer.host.id,
                        relayed=result.relayed)
            peer.block_parent(result.dst_peer_id)
        if self.records is not None:
            # failed pieces get rows too (success=False, typed fail_code)
            self.records.on_piece_fail(peer, result)
        # losing a parent: offer a fresh assignment (or the origin)
        await self._reschedule(peer)

    async def _refresh_parents(self, peer: Peer) -> None:
        if (peer.packet_sink is None or peer.is_done()
                or peer.state == PeerState.BACK_SOURCE):
            return
        # sticky top-up: keep every still-legal parent, fill free slots
        parents = self.scheduling.refresh_parents(peer)
        if not parents:
            return
        # compare against what was last offered, not the DAG (set_parents
        # may have skipped a cycle-forming edge, which would re-push
        # forever)
        if {p.id for p in parents} == peer.last_offer_ids:
            return
        self._offer(peer, parents, "refresh")
        peer.packet_sink.put_nowait(self.scheduling.build_packet(peer,
                                                                 parents))

    async def _push_victim_packet(self, victim: Peer) -> None:
        """Send a preempted bulk child its shrunk parent set, so its
        engine drops the evicted edge and requeues the pieces in flight
        on it against the parents it keeps."""
        if victim.packet_sink is None:
            return
        parents = [victim.task.peers[pid]
                   for pid in victim.last_offer_ids
                   if pid in victim.task.peers]
        victim.packet_sink.put_nowait(
            self.scheduling.build_packet(victim, parents))

    async def _reschedule(self, peer: Peer) -> None:
        if (peer.packet_sink is None or peer.is_done()
                or peer.state == PeerState.BACK_SOURCE):
            return
        parents = self.scheduling.find_parents(peer)
        if not parents:
            victim = self.scheduling.preempt_for(peer)
            if victim is not None:
                await self._push_victim_packet(victim)
                parents = self.scheduling.find_parents(peer)
        if parents:
            self._offer(peer, parents, "parents")
            peer.packet_sink.put_nowait(
                self.scheduling.build_packet(peer, parents))
            return
        if peer.report_fail_count >= self.cfg.retry_back_source_limit:
            packet = self._rule_back_source(peer)
            if packet is not None:
                peer.packet_sink.put_nowait(packet)

    # ------------------------------------------------------------------
    # ReportPeerResult — final verdict for one peer's run
    # ------------------------------------------------------------------

    async def report_peer_result(self, result: PeerResult, context) -> Empty:
        peer = self.resource.find_peer(result.task_id, result.peer_id)
        if peer is None:
            return Empty()
        task = peer.task
        task.back_source_peers.discard(peer.id)
        if result.success:
            task.set_content_info(result.content_length, 0,
                                  result.total_piece_count)
            if not peer.is_done():
                peer.transit(PeerState.SUCCEEDED)
            if task.state == TaskState.RUNNING:
                task.transit(TaskState.SUCCEEDED)
        elif not peer.is_done():
            peer.transit(PeerState.FAILED)
        # download over: drop the child's in-edges so its parents' upload
        # slots free up (the peer stays a piece-holder vertex)
        task.set_parents(peer.id, [])
        peer.last_offer_ids = set()
        if result.flight_summary:
            self.cluster.on_flight(peer, result.flight_summary)
        if self.records is not None:
            self.records.on_peer(peer, result)
            if result.flight_summary:
                self.records.on_flight(peer, result.flight_summary)
        return Empty()

    # ------------------------------------------------------------------
    # host lifecycle + stat
    # ------------------------------------------------------------------

    async def announce_host(self, req: AnnounceHostRequest,
                            context) -> AnnounceHostResponse:
        if req.host is not None:
            self.resource.store_host(req.host)
            if self.quarantine is not None:
                # flag set -> quarantined; cleared (a restart re-verified
                # clean) -> probation
                self.quarantine.record_self(
                    req.host.id, req.host.quarantined,
                    reason="self-quarantine flag on announce")
            if self.federation is not None:
                # re-announcing the same coordinates is a no-op, so
                # elections stay sticky
                self.federation.observe_host(req.host.id,
                                             req.host.topology)
            if self.fleetpulse is not None and req.pulse is not None:
                # piggybacked telemetry: ingest is total (never raises)
                # and strictly observational: no ruling path reads it
                self.fleetpulse.ingest(
                    req.host.id, req.pulse,
                    interval_s=float(req.interval_s or 0.0) or 30.0)
        return AnnounceHostResponse(scheduler_epoch=self.epoch)

    async def announce_content(self, req: AnnounceContentRequest,
                               context) -> AnnounceContentResponse:
        """Recovery re-announce: rebuild this host's holdings in the
        resource view from its sealed digest, so a restarted scheduler
        offers the swarm instead of ruling the herd back to origin."""
        from ..daemon.pex import unseal
        body = unseal(req.digest) if req.digest else None
        if req.host is None or body is None:
            _recovery_announces.labels("rejected").inc()
            return AnnounceContentResponse(scheduler_epoch=self.epoch)
        if self.quarantine is not None:
            self.quarantine.record_self(
                req.host.id, req.host.quarantined,
                reason="self-quarantine flag on content re-announce")
        if self.federation is not None:
            self.federation.observe_host(req.host.id, req.host.topology)
        if self.fleetpulse is not None and req.pulse is not None:
            self.fleetpulse.ingest(req.host.id, req.pulse)
        host = self.resource.store_host(req.host)
        adopted = 0
        pieces_learned = 0
        for e in body.get("tasks") or ():
            task_id = e.get("task_id") or ""
            if not task_id:
                continue
            task = self.resource.get_or_create_task(task_id,
                                                    e.get("url") or "")
            task.set_content_info(int(e.get("content_length", -1)),
                                  int(e.get("piece_size", 0)),
                                  int(e.get("total", -1)))
            if task.state == TaskState.PENDING:
                task.transit(TaskState.RUNNING)
            # a synthetic holder peer per (host, task): offerable as a
            # parent at once; the piece metadata itself travels over the
            # piece-sync streams, as for any live parent
            peer_id = f"{host.id}-recov-{task_id[:16]}"
            peer = self.resource.get_or_create_peer(peer_id, task, host)
            if peer.state == PeerState.PENDING:
                peer.transit(PeerState.RUNNING)
            if e.get("done"):
                if peer.state == PeerState.RUNNING:
                    peer.transit(PeerState.SUCCEEDED)
                if task.state == TaskState.RUNNING:
                    task.transit(TaskState.SUCCEEDED)
            else:
                fresh = set(int(p) for p in (e.get("pieces") or ()))
                pieces_learned += len(fresh - peer.finished_pieces)
                peer.finished_pieces |= fresh
            adopted += 1
        _recovery_announces.labels("adopted").inc()
        if self.ledger is not None and adopted:
            # provenance: this part of the view was rebuilt from the
            # swarm, and the row makes that replayable
            self._recovery_seq += 1
            self.ledger.on_decision({
                "kind": "decision",
                "decision_kind": "recovery",
                "decision_id": f"r{self._recovery_seq:08d}."
                               f"{host.id[-12:]}",
                "host_id": host.id,
                "source": "reannounce",
                "tasks_adopted": adopted,
                "pieces_learned": pieces_learned,
                "scheduler_epoch": self.epoch,
                "task_id": "",
                "peer_id": "",
                "candidates": [],
                "excluded": [],
                "chosen": [],
            })
        return AnnounceContentResponse(scheduler_epoch=self.epoch,
                                       tasks_adopted=adopted)

    async def leave_host(self, req: LeaveHostRequest, context) -> Empty:
        for child in self.resource.leave_host(req.host_id):
            await self._reschedule(child)
        return Empty()

    async def leave_peer(self, req: LeavePeerRequest, context) -> Empty:
        self.resource.leave_peer(req.task_id, req.peer_id)
        return Empty()

    async def stat_task(self, req: StatTaskRequest, context) -> TaskStat:
        task = self.resource.tasks.get(req.task_id)
        if task is None:
            raise DFError(Code.NOT_FOUND, f"task {req.task_id[:12]} unknown")
        return TaskStat(id=task.id, type=task.task_type,
                        content_length=task.content_length,
                        total_piece_count=task.total_piece_count,
                        state=task.state.value, peer_count=len(task.peers),
                        has_available_peer=task.has_available_peer())

    # ------------------------------------------------------------------
    # Preheat / SyncPeers (the manager's jobs)
    # ------------------------------------------------------------------

    async def preheat(self, req: PreheatRequest,
                      context) -> PreheatResponse:
        """Warm a URL into the seed layer (reference ``scheduler/job/
        job.go:152`` consumes the same verb from the manager's queue)."""
        meta = req.url_meta or UrlMeta()
        task_id = ids.task_id(
            req.url, tag=meta.tag, application=meta.application,
            digest=meta.digest, piece_range=meta.range,
            filtered_query_params=list(meta.filtered_query_params or []))
        if not self.seed_client.available():
            raise DFError(Code.SCHED_FORBIDDEN,
                          "no seed peers to preheat into")
        task = self.resource.get_or_create_task(task_id, req.url)
        if task.url_meta is None:
            task.url_meta = meta      # a seed re-trigger replays these
        if task.state == TaskState.PENDING:
            task.transit(TaskState.RUNNING)
        seed_done = task.seed_job is not None and task.seed_job.done()
        # a failed seed is re-triggered on retry: a transient origin outage
        # must not poison the task until GC
        if not task.seed_triggered or (seed_done
                                       and not task.has_available_peer()):
            self._fire_seed_trigger(task, meta)
        if req.wait and task.seed_job is not None:
            await asyncio.shield(task.seed_job)
        if task.has_available_peer():
            state = "succeeded"
        elif task.seed_job is not None and not task.seed_job.done():
            state = "running"
        else:
            state = "failed"
        return PreheatResponse(task_id=task_id, state=state,
                               content_length=task.content_length,
                               total_piece_count=task.total_piece_count)

    async def sync_peers(self, req: SyncPeersRequest,
                         context) -> SyncPeersResponse:
        """The live hosts, for the manager's sync_peers job (reference
        ``scheduler/job/job.go:224``)."""
        return SyncPeersResponse(hosts=[h.msg
                                        for h in self.resource.hosts.values()])

    # ------------------------------------------------------------------
    # SyncProbes
    # ------------------------------------------------------------------

    async def sync_probes(self, request_iter,
                          context) -> AsyncIterator[SyncProbesResponse]:
        async for req in request_iter:
            src = req.host.id if req.host is not None else ""
            for probe in req.probes or []:
                self.topo.record(src, probe.target_host_id, probe.rtt_us)
            for failed in req.failed_host_ids or []:
                self.topo.fail(src, failed)
            targets = []
            for hid in self.topo.pick_targets(
                    src, list(self.resource.hosts)):
                host = self.resource.hosts.get(hid)
                if host is not None:
                    targets.append(ProbeTarget(host_id=hid, ip=host.msg.ip,
                                               port=host.msg.port))
            yield SyncProbesResponse(targets=targets)


def build_service(svc: SchedulerService) -> ServiceDef:
    d = ServiceDef(SCHEDULER_SERVICE)
    d.unary_unary("RegisterPeerTask", svc.register_peer_task)
    d.stream_stream("ReportPieceResult", svc.report_piece_result)
    d.unary_unary("ReportPeerResult", svc.report_peer_result)
    d.unary_unary("AnnounceHost", svc.announce_host)
    d.unary_unary("AnnounceContent", svc.announce_content)
    d.unary_unary("LeaveHost", svc.leave_host)
    d.unary_unary("LeavePeer", svc.leave_peer)
    d.unary_unary("StatTask", svc.stat_task)
    d.unary_unary("Preheat", svc.preheat)
    d.unary_unary("SyncPeers", svc.sync_peers)
    d.stream_stream("SyncProbes", svc.sync_probes)
    return d
