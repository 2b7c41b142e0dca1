"""PeerTaskConductor: the per-(task, peer) download state machine.

Counterpart of ``dragonfly2_tpu/daemon/conductor.py`` (reference
``client/daemon/peer/peertask_conductor.go``): register with the
scheduler, pull the pieces from parent peers (``piece_engine``) or, when
P2P has nothing for the task, back to source (``piece_manager``); land and
verify each piece in storage, stage it into the device sink (built on a
thread, since pinning its staging buffer takes seconds), track
manifest shards as they complete, broadcast progress to subscribers,
finalize with the digest checks, and only then close the scheduler
session with the task's ``PeerResult``.

A requested shard subset (``requested_shards``) narrows the download to
the pieces covering those shards (``needed_pieces``). The scheduler's
shard-affinity ruling (``RegisterResult.assigned_shards``) splits them
into tree-class pieces this peer fetches and swap-class pieces its
co-located replicas supply (``set_affinity``). A finished subset stays a
warm partial in storage, never marked done; a joiner that needs more
widens the live download (``widen_to_whole_file``) until the download
commits to finishing (``_finishing``). Shard readiness is journaled on
the task's flight (``shard_ready``, ``shard_fallback``) as well as counted
in the ``df_shard_*`` metrics and published as ``shard`` events.

The task's flight (``flight_recorder.TaskFlight``, None while the recorder
is off) journals the ladder (``registered``, the rungs), each origin
piece's ``wire_done``, each placement, each piece staged into the device
sink (``hbm_done``), the sink's transfer spans and the terminal state.
Once the geometry is known the task is tracked by the relay hub
(``relay.RelayHub``): every in-flight span is published as a ``relay``
event for the piece-sync streams' announce-ahead, every landing pulses
the hub's waiters, and the task is untracked when it ends.

When every scheduler is unreachable (a transport failure, never a
verdict), the ladder tries the ``pex`` rung (``pex.PexGossiper.try_pull``:
holders the gossip plane knows) before back-source; while a scheduler
session is live, ``pex.prime`` adds those holders as advisory parents.
QoS: the task's service class and tenant (``qos_class``, ``tenant``,
from ``UrlMeta``; unknown classes clamp to ``standard``) ride the whole
download, on every rung: the shaper's registration (``attach_shaper``:
``rate_limiter`` is the task's bucket, each landed piece is ``record``-ed
and the task unregisters when it ends), each piece GET's ``?cls=``, the
storage metadata (class-weighted eviction) and the flight summary. The
governor's admission is released exactly once when the run ends
(``qos_release``).

An origin that reports no length streams to its end
(``piece_manager``); the total is learned at the end
(``on_source_complete``), and such a task gets no device sink, as in the
reference: the sink needs the length up front.

An ``ordered`` conductor (a stream consumer's, ``read_ordered``) has its
P2P pieces dispatched lowest-numbered first instead of rarest-first.

Bytes already on disk are not transferred again: a request naming a
content digest the content store holds complete is adopted whole
(``_try_adopt_content``), and an announced piece held under this task (a
warm partial, reloaded at a restart) or under any task with the same
piece digest is placed from disk (``place_from_store``,
``traffic_placed``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, AsyncIterator

from ..common import digest as digestlib
from ..common import health, tracing
from ..common.errors import Code, DFError
from ..common.metrics import REGISTRY
from ..common.piece import Range, compute_piece_size, piece_count
from ..idl.messages import (PieceInfo, PieceResult, TaskType, UrlMeta,
                            resolve_class)
from ..storage.io_executor import run_io
from ..storage.manager import StorageManager
from ..storage.metadata import TaskMetadata
from ..storage.store import TaskStorage
from . import flight_recorder as fr

log = logging.getLogger("df.core.conductor")

# sharded-task delivery (common/sharding.py): per-shard readiness and
# tree-vs-swap byte attribution
_shard_ready = REGISTRY.counter(
    "df_shard_ready_total", "manifest shards whose bytes all verified, "
    "by supply path (tree = this host's assigned fetch subset, swap = "
    "co-located replicas over P2P)", ("src",))
_shard_ready_s = REGISTRY.histogram(
    "df_shard_ready_seconds", "time from task start to each shard "
    "becoming ready",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
             120.0, 300.0))
_shard_fallbacks = REGISTRY.counter(
    "df_shard_fallback_total", "swap-class pieces re-pulled from the "
    "tree after the bounded swap hold expired (the swap partner died "
    "or stalled)")
_shard_bytes = REGISTRY.counter(
    "df_shard_bytes_total", "bytes landed into manifest shards, by the "
    "piece's supply class", ("src",))


class PeerTaskConductor:
    # terminal states
    PENDING, RUNNING, SUCCESS, FAILED = "pending", "running", "success", "failed"

    def __init__(self, *, task_id: str, peer_id: str, url: str,
                 url_meta: UrlMeta | None, storage_mgr: StorageManager,
                 piece_mgr: Any, scheduler: Any = None,
                 content_range: Range | None = None,
                 disable_back_source: bool = False,
                 task_type: TaskType = TaskType.STANDARD,
                 device_sink_factory: Any = None,
                 shard_manifest: Any = None,
                 requested_shards: list[str] | None = None,
                 flight: Any = None, relay: Any = None, pex: Any = None,
                 ordered: bool = False):
        self.task_id = task_id
        self.peer_id = peer_id
        self.url = url
        self.url_meta = url_meta or UrlMeta()
        # the scheduler may refine this at register (application table)
        self.resolved_priority = int(self.url_meta.priority)
        # the QoS class lives on the conductor, not on a session, so it
        # rides every rung (back-source and the scheduler-less pex rung)
        self.qos_class = resolve_class(self.url_meta.qos_class)
        self.tenant = self.url_meta.tenant
        self.storage_mgr = storage_mgr
        self.piece_mgr = piece_mgr
        self.scheduler = scheduler
        self.content_range = content_range
        self.disable_back_source = disable_back_source
        self.task_type = task_type
        self.device_sink_factory = device_sink_factory
        self.ordered = ordered       # stream consumers want low pieces first
        self.flight = flight         # TaskFlight journal (None = disabled)
        self.relay = relay           # RelayHub (None = cut-through off)
        self.pex = pex               # PexGossiper (None = plane disabled)
        self._relay_tracked = False
        # sharded-task delivery (common/sharding.py): the manifest's shard
        # table, the subset this host needs, and — once piece geometry is
        # known (_init_shards) — the tracker that turns verified piece
        # landings into shard readiness. Ranged requests keep the
        # whole-file path: a manifest's offsets are content-absolute and
        # a sub-range task's are range-relative.
        shards = getattr(shard_manifest, "shards", shard_manifest)
        self.shard_manifest = (list(shards) if shards
                               and content_range is None
                               and not self.url_meta.range else None)
        self.requested_shards = (list(requested_shards)
                                 if requested_shards else None)
        self.shard_tracker: Any = None
        # piece numbers this download needs (None = all): the requested
        # subset's coverage — the dispatcher, the back-source holes and
        # the finish check all read this
        self.needed_pieces: set[int] | None = None
        # scheduler shard affinity: the requested shards this peer fetches
        # from the tree; pieces of every OTHER requested shard are
        # swap-class, held off the seed for the swap hold so co-located
        # replicas supply them (piece_dispatcher.SWAP_HOLD_S)
        self.affinity_shards: list[str] | None = None
        self.swap_piece_nums: set[int] = set()
        self._swap_shard_names: set[str] = set()
        self.fallback_pieces: set[int] = set()   # swap pieces the tree served
        # completion commit point: set SYNCHRONOUSLY with the final
        # needed-coverage check (engine loop, back-source loop, finalize).
        # A widen that loses this race is refused, so a finishing subset
        # can never be widened into "incomplete"
        self._finishing = False
        # register failed at the transport (every ring member
        # unreachable), not by verdict: only then may the pex rung stand
        # in for the missing control plane
        self._sched_unreachable = False

        self.state = self.PENDING
        self.fail_code = Code.OK
        self.fail_message = ""
        self.content_length = -1
        self.piece_size = 0
        self.total_pieces = -1
        self.completed_length = 0
        self.traffic_p2p = 0          # bytes from peers
        self.traffic_source = 0       # bytes from origin
        self.traffic_placed = 0       # bytes placed from disk, not moved
        self._adopted = False         # whole task materialized by digest
        self.pieces_by_parent: dict[str, int] = {}   # P2P pieces per parent
        self.start_ms = int(time.time() * 1000)

        self.storage: TaskStorage | None = None
        self.device_ingest: Any = None
        self._sink_build: asyncio.Task | None = None
        self._staged: set[int] = set()        # pieces written to the sink
        self.ready: set[int] = set()          # piece numbers landed
        self._landing: set[int] = set()       # pieces mid-write (dedup race)
        self.done_event = asyncio.Event()
        # set once storage exists (geometry known) or the task ended: a
        # sibling's piece sync waits on it instead of answering NOT_FOUND
        self.storage_ready = asyncio.Event()
        self._piece_cond = asyncio.Condition()
        self._subscribers: list[asyncio.Queue] = []
        self._run_task: asyncio.Task | None = None
        self._p2p_engine: Any = None
        self._session: Any = None      # scheduler PeerSession once registered
        # the governor's release hook (PeerTaskManager), fired once when
        # the run ends: an unreleased admission wedges the bulk gate
        self.qos_release: Any = None
        self.shaper: Any = None
        self.rate_limiter: Any = None  # this task's bucket from the shaper
        self.log = logging.LoggerAdapter(
            log, {"task": task_id[:12], "peer": peer_id[-12:]})

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._run_task is None:
            self.state = self.RUNNING
            self._run_task = asyncio.get_running_loop().create_task(self._run())

    def set_p2p_engine(self, engine: Any) -> None:
        self._p2p_engine = engine

    def attach_shaper(self, shaper: Any) -> None:
        self.shaper = shaper
        self.rate_limiter = shaper.register(
            self.task_id, qos_class=self.qos_class, tenant=self.tenant)

    async def _run(self) -> None:
        # the task's trace: its register, offers, piece fetches, the
        # parents' serves and the device landing are spans under this one
        with tracing.span("peertask", task_id=self.task_id[:16],
                          peer_id=self.peer_id[-16:], url=self.url):
            await self._run_traced()

    async def _run_traced(self) -> None:
        """The ladder (reference ``conductor.py:203-272``): register; pull
        P2P when the scheduler answered; the pex rung when no scheduler
        could be reached; back to source when P2P could not finish and
        back-source is allowed; finalize; then close the session, so the
        PeerResult carries the real outcome."""
        try:
            used_p2p = False
            if await self._try_adopt_content():
                # the whole task is on disk under another task id: no
                # scheduler, no parents, no origin
                await self._finish_success()
                return
            if self.scheduler is not None:
                self._session = await self._register()
                if self.flight is not None and self._session is not None:
                    self.flight.event(fr.REGISTERED)
                if self._session is not None:
                    assigned = self._session.result.assigned_shards
                    if assigned is not None:
                        self.set_affinity(list(assigned))
                if self._session is not None and self._p2p_engine is not None:
                    if self.flight is not None:
                        self.flight.rung(fr.RUNG_P2P)
                    if self.pex is not None:
                        # swarm-known holders ride an advisory packet, so a
                        # hot task has parents before the scheduler's land
                        self.pex.prime(self, self._session)
                    used_p2p = await self._p2p_engine.pull(self,
                                                           self._session)
            if (not used_p2p and self.pex is not None
                    and (self.scheduler is None or self._sched_unreachable)):
                # the pex rung: no scheduler could be reached (or none is
                # configured) but gossip knows holders. A verdict
                # (NeedBackSource) is respected: this rung replaces only an
                # absent control plane
                used_p2p = await self.pex.try_pull(self)
            if not used_p2p:
                if self.disable_back_source:
                    raise DFError(Code.CLIENT_BACK_SOURCE_ERROR,
                                  "no P2P path and back-source disabled")
                if self.flight is not None:
                    self.flight.rung(fr.RUNG_BACK_SOURCE)
                self.log.info("back-source: %s", self.url)
                await self.piece_mgr.download_source(self)
            await self._finish_success()
        except asyncio.CancelledError:
            await self._finish_fail(Code.CLIENT_CONTEXT_CANCELED, "canceled")
        except DFError as exc:
            await self._finish_fail(exc.code, exc.message)
        except Exception as exc:  # noqa: BLE001
            self.log.exception("task failed")
            await self._finish_fail(Code.UNKNOWN, str(exc))
        finally:
            if self._session is not None:
                await self._session.close(success=self.state == self.SUCCESS)
            if self.shaper is not None:
                self.shaper.unregister(self.task_id)
            if self.qos_release is not None:
                release, self.qos_release = self.qos_release, None
                release()
            if self._relay_tracked:
                # wakes any streaming serve parked on this task's progress,
                # so it winds down now instead of riding out its deadline
                self._relay_tracked = False
                self.relay.untrack(self.task_id)

    async def _register(self):
        """Register with the scheduler; None means "go to origin" (the
        reference's fallback ladder: register failed or NeedBackSource)."""
        try:
            return await self.scheduler.register(self)
        except DFError as exc:
            if exc.code in (Code.UNAVAILABLE, Code.DEADLINE_EXCEEDED):
                # transport exhaustion, not a verdict: the pex rung may
                # still find mesh parents before origin
                self._sched_unreachable = True
                self.log.info("register unreachable: %s", exc.message)
                return None
            if exc.code == Code.SCHED_NEED_BACK_SOURCE:
                self.log.info("register says back-source: %s", exc.message)
                return None
            raise
        except Exception as exc:  # noqa: BLE001 - scheduler unreachable
            self._sched_unreachable = True
            self.log.warning("scheduler unreachable (%s); no P2P", exc)
            return None

    def _ingest_to_device(self, num: int, offset: int, data) -> None:
        """Stage one piece into the device sink; a failure disables the
        sink for the rest of the task (best-effort contract: the download
        still finishes to disk). The one copy of the write-or-disable
        sequence: origin and peer landings both stage through here."""
        if self.device_ingest is None:
            return
        try:
            self.device_ingest.write(offset, data)
            self._staged.add(num)
            if self.flight is not None:
                self.flight.event(fr.HBM_DONE, num, nbytes=len(data))
        except Exception:
            self.log.exception("device ingest write failed; disabling sink")
            self.device_ingest.close()
            self.device_ingest = None

    # ------------------------------------------------------------------
    # sharded delivery (common/sharding.py)
    # ------------------------------------------------------------------

    def _init_shards(self) -> None:
        """Build the shard tracker once piece geometry is known. A
        malformed manifest demotes the task to the whole-file path (the
        download still completes; nothing becomes a named tensor)."""
        if (self.shard_manifest is None or self.shard_tracker is not None
                or self.piece_size <= 0):
            return
        from ..common import sharding
        try:
            sharding.validate_manifest(self.shard_manifest,
                                       self.content_length)
            tracker = sharding.ShardTracker(self.shard_manifest,
                                            self.requested_shards)
        except ValueError:
            self.log.exception("bad shard manifest; whole-file fallback")
            self.shard_manifest = None
            self.requested_shards = None
            return
        self.shard_tracker = tracker
        if self.flight is not None:
            self.flight.shards_total = tracker.total
        if self.requested_shards is not None and self.total_pieces >= 0:
            self.needed_pieces = tracker.needed_pieces(self.piece_size,
                                                       self.total_pieces)
        self._classify_affinity()
        self.log.info("sharded task: %d/%d shards requested (%s pieces "
                      "needed, %d swap-class)", tracker.total,
                      len(self.shard_manifest),
                      "all" if self.needed_pieces is None
                      else len(self.needed_pieces),
                      len(self.swap_piece_nums))

    def set_affinity(self, names: list[str]) -> None:
        """Scheduler shard-affinity ruling: these requested shards are
        THIS peer's to fetch from the tree; the rest arrive by swap."""
        self.affinity_shards = names
        self._classify_affinity()

    def _classify_affinity(self) -> None:
        tracker = self.shard_tracker
        if tracker is None or self.affinity_shards is None \
                or self.piece_size <= 0:
            return
        from ..common.sharding import pieces_for_shards
        mine = set(self.affinity_shards)
        self._swap_shard_names = {s.name for s in tracker.shards
                                  if s.name not in mine}
        swap = pieces_for_shards(
            [s for s in tracker.shards if s.name in self._swap_shard_names],
            self.piece_size, self.total_pieces)
        tree = pieces_for_shards(
            [s for s in tracker.shards if s.name in mine],
            self.piece_size, self.total_pieces)
        # a boundary piece shared by a tree shard and a swap shard is
        # tree-class: this host must fetch it anyway, and holding it back
        # would stall the tree shard behind the swap window
        self.swap_piece_nums = swap - tree

    def pieces_remaining(self) -> int:
        """Pieces still to land before this download is DONE — the
        requested subset's count for sharded tasks, total otherwise
        (-1 = unknown geometry)."""
        if self.total_pieces < 0:
            return -1
        if self.needed_pieces is not None:
            return len(self.needed_pieces - self.ready)
        return self.total_pieces - len(self.ready)

    def needed_piece_nums(self, total: int) -> list[int]:
        """Sorted piece numbers this task needs out of ``total`` — the
        back-source hole universe (piece_manager.download_source)."""
        if self.needed_pieces is not None:
            return sorted(n for n in self.needed_pieces if n < total)
        return list(range(total))

    def _note_shard_progress(self, num: int, offset: int, size: int,
                             replay: bool = False) -> None:
        """One verified piece landed: advance shard coverage and publish
        any shard it completed. ``replay`` (the widen path re-feeding
        landed pieces into a fresh tracker) skips the byte counter: those
        bytes were counted, with their true class, when they landed."""
        tracker = self.shard_tracker
        if tracker is None:
            return
        if not replay:
            # only the bytes INSIDE tracked shards count: manifest gaps
            # and the non-shard halves of boundary pieces must not
            # inflate the tree/swap split
            in_shards = tracker.shard_bytes_in(offset, offset + size)
            if in_shards:
                swap = num in self.swap_piece_nums
                _shard_bytes.labels("swap" if swap else "tree").inc(
                    in_shards)
        t = time.time() * 1000 - self.start_ms
        for name in tracker.on_span(offset, offset + size, t):
            shard = tracker.shard_for(name)
            cls = (fr.SHARD_SRC_SWAP if name in self._swap_shard_names
                   else fr.SHARD_SRC_TREE)
            src = fr.SHARD_SRC_NAMES[cls]
            _shard_ready.labels(src).inc()
            _shard_ready_s.observe(max(t, 0.0) / 1000.0)
            if self.flight is not None:
                self.flight.event(fr.SHARD_READY, cls, name,
                                  shard.range_size)
            self._publish({"type": "shard", "name": name, "src": src,
                           "bytes": shard.range_size,
                           "ready": len(tracker.ready),
                           "total": tracker.total})

    def note_shard_fallback(self, num: int, parent_id: str) -> None:
        """A swap-class piece is being served by the TREE after its swap
        hold expired (engine hook): counted once per piece."""
        if num in self.fallback_pieces:
            return
        self.fallback_pieces.add(num)
        _shard_fallbacks.inc()
        if self.flight is not None:
            self.flight.event(fr.SHARD_FALLBACK, num, parent_id)
        self.log.info("swap piece %d falls back to the tree (%s)", num,
                      parent_id[-12:])

    def widen_to_whole_file(self) -> bool:
        """A joiner needs shards (or the whole file) outside this subset
        download: widen to the full piece set mid-flight. Landed coverage
        is replayed into a full-manifest tracker, so nothing re-fetches.
        Returns False once this download has COMMITTED to finishing
        (``_finishing``): the caller then starts a fresh conductor over
        the same task storage, which adopts the landed pieces and fetches
        only the gap. Runs on the event loop, so the refusal check and the
        mutation are atomic with respect to the commit points."""
        if self.requested_shards is None:
            return True
        if self._finishing or self.done_event.is_set():
            return False
        self.log.info("sharded task widened to the whole file by a joiner")
        self.requested_shards = None
        self.needed_pieces = None
        self.swap_piece_nums = set()
        self._swap_shard_names = set()
        if (self.shard_tracker is not None and self.piece_size > 0
                and self.shard_manifest):
            from ..common.sharding import ShardTracker
            fresh = ShardTracker(self.shard_manifest)
            fresh.ready.update(self.shard_tracker.ready)
            self.shard_tracker = fresh
            if self.flight is not None:
                self.flight.shards_total = fresh.total
            if self.storage is not None:
                for num in sorted(self.ready):
                    meta = self.storage.md.pieces.get(num)
                    if meta is not None:
                        self._note_shard_progress(num, meta.start,
                                                  meta.size, replay=True)
        if self._p2p_engine is not None:
            self._p2p_engine.apply_shard_state(self)
        return True

    def _device_shard_specs(self) -> list[tuple] | None:
        """The device sink's specs: the requested shards only (the whole
        manifest when none were requested)."""
        tracker = self.shard_tracker
        if tracker is None:
            return None
        return [(s.name, s.range_start, s.range_size, s.dtype,
                 list(s.shape) if s.shape else None)
                for s in tracker.shards]

    def _make_device_ingest(self, content_length: int):
        specs = self._device_shard_specs()
        if specs:
            return self.device_sink_factory(content_length,
                                            shard_specs=specs)
        return self.device_sink_factory(content_length)

    # ------------------------------------------------------------------
    # content metadata + piece arrival (called by the piece manager)
    # ------------------------------------------------------------------

    def set_content_info(self, content_length: int,
                         piece_size: int = 0) -> int:
        """Fix piece geometry; register storage + device sink. Returns the
        piece size. ``content_length`` is the EFFECTIVE length this task
        stores (the sub-range length for ranged tasks — piece offsets are
        range-relative); ``piece_size`` is a parent's, when the geometry
        comes from the swarm; -1 = unknown until the origin's stream ends
        (``on_source_complete``). Safe to call more than once."""
        if self.piece_size:
            return self.piece_size
        self.content_length = content_length
        self.piece_size = piece_size or compute_piece_size(
            max(content_length, 0))
        if content_length >= 0:
            self.total_pieces = piece_count(content_length, self.piece_size)
        md = TaskMetadata(
            task_id=self.task_id, task_type=self.task_type, url=self.url,
            tag=self.url_meta.tag, application=self.url_meta.application,
            content_length=content_length,
            total_piece_count=self.total_pieces,
            piece_size=self.piece_size, digest=self.url_meta.digest,
            priority=self.resolved_priority,
            qos_class=self.qos_class)
        self.storage = self.storage_mgr.register_task(md)
        self.storage_ready.set()
        self._init_shards()
        if self.relay is not None and not self._relay_tracked:
            # cut-through: from here until the task ends, the upload
            # server may serve its bytes up to the landing watermark
            self._relay_tracked = True
            self.relay.track(self.task_id, total_pieces=self.total_pieces,
                             on_open=self._on_relay_span)
        if (self.device_sink_factory is not None and content_length > 0
                and self._sink_build is None):
            # pinning the staging buffer takes about a second per 4 GiB,
            # which would stall every task on this event loop: the sink is
            # built on a thread, and pieces landed meanwhile are staged
            # from storage once it is up
            self._sink_build = asyncio.get_running_loop().create_task(
                self._build_device_ingest(content_length))
        return self.piece_size

    def _on_relay_span(self, span) -> None:
        """A new in-flight span opened for this task: publish its piece
        numbers so the piece-sync streams announce them ahead (a child may
        begin pulling them now, served to the landing watermark)."""
        self._publish({"type": "relay",
                       "nums": [p.piece_num for p in span.pieces]})

    def _pulse_relay(self) -> None:
        """Landed bytes are disk-covered now: move relay readers along."""
        if self._relay_tracked:
            self.relay.pulse(self.task_id)

    async def _build_device_ingest(self, content_length: int) -> None:
        try:
            ingest = await asyncio.to_thread(self._make_device_ingest,
                                             content_length)
        except Exception:  # device sink is best-effort
            self.log.exception("device sink init failed; continuing to disk")
            return
        if self.state == self.FAILED:     # failed while it was built
            ingest.close()
            return
        self.device_ingest = ingest
        await self._stage_backlog()

    async def _stage_backlog(self) -> None:
        """Stage, from storage, the landed pieces the sink has not seen:
        those that landed while it was being built, and those adopted from
        storage."""
        for num in sorted(self.ready - self._staged):
            meta = self.storage.md.pieces.get(num)
            if meta is None:
                continue
            data = await run_io(self.storage.read_piece, num)
            if self.device_ingest is None:
                return
            if num not in self._staged:
                self._ingest_to_device(num, meta.start, data)

    async def _try_adopt_content(self) -> bool:
        """Whole-task dedupe: when the request names a content digest the
        store holds complete, this task becomes a hardlink of that copy
        with its piece table (zero transfers). The device sink is fed from
        disk at finalize (``_stage_backlog``). False = no hit."""
        castore = self.storage_mgr.castore
        if (not self.url_meta.digest or self.content_range is not None
                # a ranged request's content_range resolves only later,
                # against the origin: adopting on it would land the whole
                # file under the ranged task id
                or self.url_meta.range or castore is None):
            return False
        md = TaskMetadata(
            task_id=self.task_id, task_type=self.task_type, url=self.url,
            tag=self.url_meta.tag, application=self.url_meta.application,
            digest=self.url_meta.digest, priority=self.resolved_priority,
            qos_class=self.qos_class)
        ts = await run_io(self.storage_mgr.adopt_content, md)
        if ts is None or not (ts.md.done and ts.md.success):
            return False
        self._adopted = True
        self.storage = ts
        self.content_length = ts.md.content_length
        self.piece_size = ts.md.piece_size
        self.total_pieces = ts.md.total_piece_count
        self.storage_ready.set()
        self._init_shards()
        castore.note_hit("content", ts.md.content_length)
        if self.device_sink_factory is not None and self.content_length > 0:
            self._sink_build = asyncio.get_running_loop().create_task(
                self._build_device_ingest(self.content_length))
        for num in sorted(ts.md.pieces):
            p = ts.md.pieces[num]
            async with self._piece_cond:
                self.ready.add(num)
                self.completed_length += p.size
                self._piece_cond.notify_all()
            self.traffic_placed += p.size
            if self.flight is not None:
                self.flight.event(fr.PLACED, num, "cas", p.size)
            self._note_shard_progress(num, p.start, p.size)
            self._publish({"type": "piece", "num": num, "size": p.size,
                           "completed": self.completed_length,
                           "total": self.content_length})
        self.log.info("content dedupe: task adopted from the store "
                      "(%d pieces, %d bytes, zero transferred)",
                      len(ts.md.pieces), self.completed_length)
        return True

    async def place_from_store(self, infos: list[PieceInfo]) -> set[int]:
        """Land any of ``infos`` whose bytes are already on disk without
        touching the wire: pieces THIS task's storage holds (a finished
        subset's warm partial, a reloaded one, an earlier attempt's)
        verified when they landed or at the restart's re-verify, and
        pieces another task holds under the same digest, copied and
        re-verified by the content store. The device sink takes them from
        storage (``_stage_backlog``). Returns the piece numbers landed, so
        the engine never dispatches a pull for them."""
        if self.storage is None:
            return set()
        castore = self.storage_mgr.castore
        placed: set[int] = set()
        reports: list[PieceResult] = []
        for info in infos:
            num = info.piece_num
            if num in self.ready or num in self._landing:
                continue
            meta = self.storage.md.pieces.get(num)
            if meta is None and (castore is None or not info.digest
                                 or castore.find_piece(
                                     info.digest, info.range_size,
                                     exclude_task=self.task_id) is None):
                continue
            if meta is None:
                self._landing.add(num)
                try:
                    landed = await run_io(
                        castore.place_piece, self.storage, num,
                        info.range_start, info.range_size, info.digest)
                finally:
                    self._landing.discard(num)
                meta = self.storage.md.pieces.get(num) if landed else None
                if meta is None:
                    continue
            elif castore is not None:
                castore.note_hit("task", meta.size)
            async with self._piece_cond:
                if num in self.ready or num in self._landing:
                    continue
                self.ready.add(num)
                self.completed_length += meta.size
                self._piece_cond.notify_all()
            self.traffic_placed += meta.size
            placed.add(num)
            if self.flight is not None:
                self.flight.event(fr.PLACED, num, "cas", meta.size)
            self._note_shard_progress(num, meta.start, meta.size)
            self._pulse_relay()
            self._publish({"type": "piece", "num": num, "size": meta.size,
                           "completed": self.completed_length,
                           "total": self.content_length})
            if self._session is not None:
                # announce the placement so the scheduler counts this
                # daemon a holder, as a back-source landing does (dst "")
                now = int(time.time() * 1000)
                reports.append(PieceResult(
                    task_id=self.task_id, src_peer_id=self.peer_id,
                    dst_peer_id="", success=True,
                    piece_info=PieceInfo(piece_num=num,
                                         range_start=meta.start,
                                         range_size=meta.size,
                                         digest=meta.digest),
                    begin_ms=now, end_ms=now,
                    finished_count=len(self.ready)))
        if reports:
            # concurrently: a warm partial adopts hundreds of pieces, and
            # one sequential round trip each would stall the gap fetch
            await asyncio.gather(*(self._session.report_piece(r)
                                   for r in reports))
        return placed

    async def _land_piece(self, num: int, offset: int, data: bytes,
                          cost_ms: int, source: str,
                          piece_digest: str = "",
                          pre_verified: bool = False) -> bool:
        """Land, verify and stage one piece from ``source`` (a parent's
        peer id, or "" for the origin). True when this call landed it; a
        duplicate changes nothing and returns False."""
        if self.storage is None:
            raise DFError(Code.CLIENT_STORAGE_ERROR, "piece before content info")
        if num in self.ready or num in self._landing:
            # _landing claims the piece BEFORE the await below, so two
            # near-simultaneous landings of one piece cannot both count
            return False
        # taken before landing (wire_done precedes the hbm_done below),
        # journaled only once the piece landed; a piece that skipped the
        # dispatcher's stages back-dates its start by the duration
        t_wire = self.flight.now_ms() if self.flight is not None else 0.0
        self._landing.add(num)
        try:
            # hashing + write take ms at 16 MiB: the dedicated storage
            # executor runs them, never the event loop
            await run_io(self.storage.write_piece, num, offset, data,
                         piece_digest, cost_ms=cost_ms, source=source,
                         pre_verified=pre_verified)
        finally:
            self._landing.discard(num)
        if num in self.ready:     # lost a race decided elsewhere
            return False
        if self.flight is not None:
            self.flight.event(fr.WIRE_DONE, num, source or fr.ORIGIN,
                              len(data), dur_ms=cost_ms, t_ms=t_wire)
        # write() is a memcpy + enqueue; the copy runs on the sink's own
        # thread and is never awaited here
        self._ingest_to_device(num, offset, data)
        if self.shaper is not None:
            self.shaper.record(self.task_id, len(data))
        async with self._piece_cond:
            self.ready.add(num)
            self.completed_length += len(data)
            self._piece_cond.notify_all()
        self._note_shard_progress(num, offset, len(data))
        self._pulse_relay()
        self._publish({"type": "piece", "num": num, "size": len(data),
                       "completed": self.completed_length,
                       "total": self.content_length})
        return True

    async def on_piece_from_source(self, num: int, offset: int, data: bytes,
                                   cost_ms: int) -> None:
        """Land, verify and stage one origin piece. A duplicate changes
        nothing."""
        if not await self._land_piece(num, offset, data, cost_ms, source=""):
            return
        self.traffic_source += len(data)
        if self._session is not None:
            # a back-source peer announces its pieces so the scheduler can
            # make it a parent
            now = int(time.time() * 1000)
            await self._session.report_piece(PieceResult(
                task_id=self.task_id, src_peer_id=self.peer_id,
                dst_peer_id="", success=True,
                piece_info=PieceInfo(piece_num=num, range_start=offset,
                                     range_size=len(data),
                                     download_cost_ms=cost_ms),
                begin_ms=now - cost_ms, end_ms=now,
                finished_count=len(self.ready)))

    async def on_span_from_peer(self, parent_id: str,
                                pieces: list[PieceInfo], data,
                                cost_ms_per_piece: int,
                                ) -> tuple[list[int], list[int], list[int]]:
        """Land a contiguous downloaded span in one storage pass (digest
        verification fused with the write) and one condition round.

        ``pieces`` are contiguous ascending; ``data`` holds their bytes
        from ``pieces[0].range_start``. Returns ``(placed, corrupt,
        raced)`` piece-number lists. ``raced`` pieces are claimed by an
        in-flight endgame duplicate whose outcome is unknown: the caller
        reports them neither done nor corrupt (the racer's report settles
        them). Pieces that already landed appear in none of the lists.
        The caller may recycle ``data`` as soon as this returns: the
        storage write and the device sink's staging copy are done.
        """
        if self.storage is None:
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          "span before content info")
        base = pieces[0].range_start
        raced = [p.piece_num for p in pieces if p.piece_num in self._landing]
        claim = [p for p in pieces
                 if p.piece_num not in self.ready
                 and p.piece_num not in self._landing]
        if not claim:
            return [], [], raced
        for p in claim:             # claimed before the await below
            self._landing.add(p.piece_num)
        try:
            spec = [(p.piece_num, p.range_start, p.range_size, p.digest)
                    for p in claim]
            metas, corrupt, _ = await run_io(
                self.storage.write_span, spec, data, base=base,
                cost_ms=cost_ms_per_piece, source=parent_id)
        finally:
            for p in claim:
                self._landing.discard(p.piece_num)
        by_num = {p.piece_num: p for p in claim}
        landed = {m.num for m in metas}
        # claimed pieces neither landed nor corrupt were ALREADY on disk,
        # recorded by an earlier conductor over this same task storage:
        # verified when they first landed, so they count as placed here
        # (left out, the peer would report them done meshside while this
        # conductor never reached its needed set)
        on_disk = sorted(n for n in by_num
                         if n not in landed and n not in corrupt
                         and n not in self.ready)
        placed = [m.num for m in metas if m.num not in self.ready] + on_disk
        if self.device_ingest is not None:
            # an on-disk piece's copy in this span was never digest-checked:
            # the sink takes the verified bytes from storage at finish
            view = memoryview(data)
            try:
                for n in placed:
                    if n in on_disk:
                        continue
                    p = by_num[n]
                    lo = p.range_start - base
                    self._ingest_to_device(n, p.range_start,
                                           view[lo:lo + p.range_size])
            finally:
                view.release()
        events = []
        counted = []
        async with self._piece_cond:
            for n in placed:
                if n in self.ready:
                    # an endgame duplicate landed it during the awaits
                    # above; the winner already counted it
                    continue
                counted.append(n)
                self.pieces_by_parent[parent_id] = \
                    self.pieces_by_parent.get(parent_id, 0) + 1
                size = by_num[n].range_size
                self.ready.add(n)
                self.completed_length += size
                self.traffic_p2p += size
                if self.shaper is not None:
                    self.shaper.record(self.task_id, size)
                events.append({"type": "piece", "num": n, "size": size,
                               "completed": self.completed_length,
                               "total": self.content_length})
            self._piece_cond.notify_all()
        for n in counted:
            p = by_num[n]
            self._note_shard_progress(n, p.range_start, p.range_size)
        self._pulse_relay()
        for ev in events:
            self._publish(ev)
        return counted, corrupt, raced

    def on_source_complete(self, total: int) -> None:
        """An origin of unknown length ended after ``total`` bytes: the
        geometry is what landed."""
        if self.content_length < 0:
            self.content_length = total
            self.total_pieces = len(self.ready)
            if self.storage is not None:
                self.storage.md.content_length = total
                self.storage.md.total_piece_count = self.total_pieces

    # ------------------------------------------------------------------
    # finalize
    # ------------------------------------------------------------------

    async def _verify_digest(self) -> None:
        if not self.url_meta.digest or self.storage is None:
            return
        if self._adopted:
            # the canonical copy verified this digest when it completed,
            # and adoption hardlinks that same inode
            return
        if self.content_range is not None:
            # the digest describes the whole file; a sub-range can't check it
            return
        algo, want = digestlib.parse(self.url_meta.digest)
        # default executor ON PURPOSE (not run_io): a full-content hash of
        # many GB must not park piece landings on the storage pool
        got = await asyncio.to_thread(self.storage.content_hash, algo,
                                      self.content_length)
        if got != want:
            raise DFError(Code.CLIENT_DIGEST_MISMATCH,
                          f"content digest mismatch: {algo}:{got[:12]}..")

    async def _verify_shard_digests(self) -> None:
        """Optional whole-shard digests (ShardInfo.digest) checked at
        finalize over the landed bytes."""
        tracker = self.shard_tracker
        if tracker is None or self.storage is None:
            return
        to_check = [s for s in tracker.shards
                    if s.digest and s.name in tracker.ready]
        if not to_check:
            return
        path = self.storage.data_path()

        def compute() -> list[str]:
            bad: list[str] = []
            with open(path, "rb") as f:
                for s in to_check:
                    algo, want = digestlib.parse(s.digest)
                    hasher = digestlib.Hasher(algo)
                    f.seek(s.range_start)
                    remaining = s.range_size
                    while remaining > 0:
                        b = f.read(min(4 << 20, remaining))
                        if not b:
                            break
                        remaining -= len(b)
                        hasher.update(b)
                    if remaining or hasher.hexdigest() != want:
                        bad.append(s.name)
            return bad

        bad = await asyncio.to_thread(compute)
        if bad:
            raise DFError(Code.CLIENT_DIGEST_MISMATCH,
                          f"shard digest mismatch: {bad}")

    async def _finish_success(self) -> None:
        # a requested subset finishes when ITS pieces are all in; the
        # task's storage then stays a warm PARTIAL (never marked done):
        # peers see exactly the pieces it holds, a later request for other
        # shards adopts them (place_from_store), and the completed-task
        # reuse path can never serve the partial file as whole content
        self._finishing = True      # widen refused from here on
        subset_done = (self.needed_pieces is not None
                       and self.total_pieces >= 0
                       and len(self.ready) < self.total_pieces
                       and not (self.needed_pieces - self.ready))
        if (self.total_pieces >= 0 and len(self.ready) < self.total_pieces
                and not subset_done):
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          f"incomplete: {len(self.ready)}/{self.total_pieces} pieces")
        await self._verify_shard_digests()
        if subset_done:
            if self.storage is not None:
                await run_io(self.storage.persist)
        else:
            await self._verify_digest()
            if self.storage is not None:
                await run_io(self.storage.mark_done, success=True,
                             content_length=self.content_length,
                             total_piece_count=self.total_pieces)
        if self._sink_build is not None:
            await self._sink_build
        if self.device_ingest is not None:
            await self._stage_backlog()
        if self.device_ingest is not None:
            try:
                self.device_ingest.flush()   # enqueue-only, non-blocking
            except Exception:
                self.log.exception("device sink flush failed")
                self.device_ingest.close()
                self.device_ingest = None
        if self.device_ingest is not None:
            # inside the peertask span: the device landing joins the task's
            # trace (ruling -> piece fetch -> device memory)
            spans = list(self.device_ingest.transfer_spans)
            with tracing.span("hbm.ingest", task_id=self.task_id[:16]) as hsp:
                hsp.set(transfers=len(spans),
                        done_fraction=self.device_ingest.done_fraction(),
                        dma_ms=round(sum(b - a for a, b in spans) * 1e3, 3))
            if self.flight is not None:
                self.flight.hbm_spans(spans)
        self.state = self.SUCCESS
        if self.flight is not None:
            self.flight.finish(self.SUCCESS)
            # this task's stage-budget breaches, counted once into
            # df_slo_breach_total (summaries only carry the annotation)
            health.PLANE.slo.observe_summary(self.flight.summarize())
        self._publish({"type": "done", "success": True,
                       "completed": self.completed_length,
                       "total": self.content_length})
        self.done_event.set()
        async with self._piece_cond:
            self._piece_cond.notify_all()
        self.log.info("task success: %d bytes, %d pieces (p2p=%d src=%d) "
                      "placed=%d", self.completed_length, len(self.ready),
                      self.traffic_p2p, self.traffic_source,
                      self.traffic_placed)

    async def _finish_fail(self, code: Code, message: str) -> None:
        if self.state in (self.SUCCESS, self.FAILED):
            return
        self.state = self.FAILED
        self.fail_code = code
        self.fail_message = message
        if self.flight is not None:
            # ladder exhausted: the fail rung puts the verdict in the
            # journal, not only in the PeerResult code
            self.flight.rung(fr.RUNG_FAIL)
            self.flight.finish(self.FAILED)
            health.PLANE.slo.observe_summary(self.flight.summarize())
        if self.device_ingest is not None:
            self.device_ingest.close()
            self.device_ingest = None
        if self.storage is not None:
            try:
                await run_io(self.storage.mark_done, success=False)
            except Exception:  # noqa: BLE001
                pass
        self._publish({"type": "done", "success": False, "code": int(code),
                       "message": message})
        self.done_event.set()
        self.storage_ready.set()
        async with self._piece_cond:
            # an ordered reader parked on a piece that will never land
            self._piece_cond.notify_all()
        self.log.warning("task failed: %s %s", code.name, message)

    async def wait_done(self, timeout: float | None = None) -> bool:
        if timeout:
            try:
                await asyncio.wait_for(self.done_event.wait(), timeout)
            except asyncio.TimeoutError:
                return False
        else:
            await self.done_event.wait()
        return self.state == self.SUCCESS

    def cancel(self) -> None:
        if self._run_task is not None:
            self._run_task.cancel()

    # ------------------------------------------------------------------
    # progress fan-out
    # ------------------------------------------------------------------

    def subscribe(self) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._subscribers.append(q)
        if self.done_event.is_set():
            q.put_nowait({"type": "done", "success": self.state == self.SUCCESS,
                          "code": int(self.fail_code),
                          "completed": self.completed_length,
                          "total": self.content_length,
                          "message": self.fail_message})
        return q

    def unsubscribe(self, q: asyncio.Queue) -> None:
        try:
            self._subscribers.remove(q)
        except ValueError:
            pass

    def _publish(self, event: dict) -> None:
        for q in list(self._subscribers):
            q.put_nowait(event)

    # ------------------------------------------------------------------
    # ordered byte stream (stream tasks, the object gateway)
    # ------------------------------------------------------------------

    async def read_ordered(self) -> AsyncIterator[bytes]:
        """Yield the content's bytes in order, each piece as soon as it
        and every piece before it have landed; raises the task's error if
        it fails first."""
        num = 0
        while True:
            async with self._piece_cond:
                while (num not in self.ready
                       and not self.done_event.is_set()):
                    await self._piece_cond.wait()
            if num in self.ready:
                assert self.storage is not None
                data = await run_io(self.storage.read_piece, num)
                yield data
                num += 1
                if self.total_pieces >= 0 and num >= self.total_pieces:
                    return
                continue
            # done without the piece: the task ended
            if self.state == self.FAILED:
                raise DFError(self.fail_code or Code.UNKNOWN,
                              self.fail_message or "task failed")
            return
