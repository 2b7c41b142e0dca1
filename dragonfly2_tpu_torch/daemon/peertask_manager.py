"""PeerTaskManager: one conductor per task, the file-task façade, and the
reuse fast path.

Counterpart of ``dragonfly2_tpu/daemon/peertask_manager.py`` cut to the
file task: each conductor gets the daemon's scheduler connector, a fresh
P2P engine, a flight from the daemon's recorder and the daemon's relay
hub, so it registers, pulls from parents, and goes back to source only
when P2P cannot finish.

QoS: a new task is admitted by the daemon's governor (``qos``,
``daemon/qos.py``) before its conductor exists, outside the manager's
lock, so a bulk request riding the brownout queue never holds the lock a
critical request needs; a shed raises RESOURCE_EXHAUSTED with
``retry_after_ms``. The admission is released when the run ends
(``conductor.qos_release``), the ruling is a ``qos`` event on the task's
flight, and the conductor registers with the traffic shaper
(``shaper``).

A request that names shards (``UrlMeta.shards``) runs a requested-subset
download. The shard names stay out of the task id, so every host pulling
any subset of one file joins one swarm. A joiner whose needs the live
subset download does not cover widens it to the whole file; when that
download has already committed to finishing, a fresh conductor over the
same task storage adopts the landed pieces and fetches only the gap.

The reuse fast path answers from disk with ``peer_id="reused"``: a
completed task, or a ranged request (``UrlMeta.range``) whose finished
whole-file parent covers the range, which is copied out of the parent's
file. With ``prefetch_whole_file`` a ranged request whose parent is not
finished also starts the whole file in the background, so later ranges
are local reads.

The object gateway's two paths: ``stream_task`` gives a task's bytes in
order as they land (a completed task replays from disk; a running file
task joined by a stream switches to in-order fetching), and
``import_file`` makes a local file a completed task under a URL's task
id, as a back-source pull would store it.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import replace
from typing import Any, AsyncIterator

from ..common import ids
from ..common.errors import Code, DFError
from . import flight_recorder as fr
from ..common.piece import Range, parse_http_range
from ..common.sharding import parse_shard_names
from ..idl.messages import (DownloadRequest, DownloadResponse, TaskStat,
                            TaskType, UrlMeta, resolve_class)
from ..storage.manager import StorageManager
from .conductor import PeerTaskConductor
from .piece_manager import PieceManager

log = logging.getLogger("df.core.peertask")


class PeerTaskManager:
    def __init__(self, *, storage_mgr: StorageManager, piece_mgr: PieceManager,
                 hostname: str, host_ip: str, scheduler: Any = None,
                 p2p_engine_factory: Any = None,
                 device_sink_builder: Any = None, is_seed: bool = False,
                 flight_recorder: Any = None, relay: Any = None,
                 pex: Any = None, prefetch_whole_file: bool = False,
                 shaper: Any = None, qos: Any = None):
        self.storage_mgr = storage_mgr
        self.piece_mgr = piece_mgr
        self.hostname = hostname
        self.host_ip = host_ip
        self.scheduler = scheduler
        self.p2p_engine_factory = p2p_engine_factory
        self.device_sink_builder = device_sink_builder
        self.is_seed = is_seed
        self.flight_recorder = flight_recorder
        self.relay = relay            # RelayHub (None = cut-through off)
        self.pex = pex                # PexGossiper (None = plane disabled)
        self.prefetch_whole_file = prefetch_whole_file
        self.shaper = shaper          # TrafficShaper (None = unshaped)
        self.qos = qos                # QosGovernor (None = admission off)
        self._conductors: dict[str, PeerTaskConductor] = {}
        self._prefetching: set[str] = set()
        # strong refs: the loop holds tasks weakly, and a collected
        # prefetch would leave its id in _prefetching for good
        self._prefetch_tasks: set[asyncio.Task] = set()
        self._lock = asyncio.Lock()

    def _task_id(self, url: str, meta: UrlMeta) -> str:
        return ids.task_id(
            url, tag=meta.tag, application=meta.application, digest=meta.digest,
            piece_range=meta.range,
            filtered_query_params=list(meta.filtered_query_params or []))

    async def get_or_create_conductor(
            self, url: str, meta: UrlMeta, *,
            task_type: TaskType = TaskType.STANDARD,
            disable_back_source: bool = False,
            device_sink_factory: Any = None,
            shard_manifest: Any = None,
            register: bool = True,
            ordered: bool = False) -> PeerTaskConductor:
        """Join the live conductor for this task, or start one.
        ``register=False`` starts it without the scheduler: a seed's
        ``ObtainSeeds`` download is the scheduler's own trigger, and
        registering it too would let the scheduler offer the seed its
        own waiting leecher as a parent (each then waits on the other).
        ``ordered``: a stream consumer reads it from piece 0 up, so its
        pieces are fetched in order (a running task joined this way
        switches)."""
        task_id = self._task_id(url, meta)
        requested_shards = None
        if meta.shards:
            requested_shards = parse_shard_names(meta.shards) or None
        async with self._lock:
            conductor = self._join_existing(task_id, requested_shards,
                                            ordered)
            if conductor is not None:
                return conductor
        # admission outside the lock, so a queued bulk request never holds
        # the lock a critical one needs; may raise RESOURCE_EXHAUSTED
        qos = None
        if self.qos is not None:
            qos = await self.qos.admit(resolve_class(meta.qos_class),
                                       meta.tenant)
        async with self._lock:
            conductor = self._join_existing(task_id, requested_shards,
                                            ordered)
            if conductor is not None:
                if qos is not None:
                    # lost the creation race while queued: the winner's
                    # admission is the accounted one
                    self.qos.release(qos[0])
                return conductor
            return self._start_conductor(
                task_id, url, meta, task_type=task_type,
                disable_back_source=disable_back_source,
                device_sink_factory=device_sink_factory,
                shard_manifest=shard_manifest,
                requested_shards=requested_shards, register=register,
                qos=qos, ordered=ordered)

    def _start_conductor(self, task_id: str, url: str, meta: UrlMeta, *,
                         task_type: TaskType, disable_back_source: bool,
                         device_sink_factory: Any, shard_manifest: Any,
                         requested_shards: list[str] | None, register: bool,
                         qos: tuple[str, str] | None = None,
                         ordered: bool = False) -> PeerTaskConductor:
        """Build and start a task's conductor (called under the manager
        lock). ``qos``: the governor's (class, ruling) for this task."""
        peer_id = ids.peer_id(self.hostname, self.host_ip,
                              seed=self.is_seed)
        flight = (self.flight_recorder.begin(
            task_id, peer_id, url=url,
            # clamped to a known class ("" stays classless): it becomes a
            # metric label, and a raw wire string would be unbounded
            qos_class=(resolve_class(meta.qos_class)
                       if meta.qos_class else ""),
            tenant=meta.tenant)
            if self.flight_recorder is not None else None)
        conductor = PeerTaskConductor(
            task_id=task_id, peer_id=peer_id,
            url=url, url_meta=meta, storage_mgr=self.storage_mgr,
            piece_mgr=self.piece_mgr,
            scheduler=self.scheduler if register else None,
            disable_back_source=disable_back_source, task_type=task_type,
            device_sink_factory=device_sink_factory,
            shard_manifest=shard_manifest,
            requested_shards=requested_shards,
            flight=flight, relay=self.relay, pex=self.pex, ordered=ordered)
        if qos is not None:
            qos_cls, ruling = qos
            conductor.qos_release = lambda c=qos_cls: self.qos.release(c)
            if flight is not None:
                # the admission ruling: a bulk task that rode the
                # brownout queue carries it in its journal
                flight.event(fr.QOS, parent=("brownout" if ruling == "queued"
                                             else self.qos.state))
        if self.p2p_engine_factory is not None:
            conductor.set_p2p_engine(self.p2p_engine_factory())
        if self.shaper is not None:
            conductor.attach_shaper(self.shaper)
        self._conductors[task_id] = conductor
        conductor.start()
        return conductor

    def _join_existing(self, task_id: str,
                       requested_shards: list[str] | None,
                       ordered: bool = False,
                       ) -> PeerTaskConductor | None:
        """The live conductor this request may share (called under the
        manager lock), or None to start a fresh one."""
        conductor = self._conductors.get(task_id)
        if conductor is None or conductor.state == PeerTaskConductor.FAILED:
            return None
        if ordered and not conductor.ordered:
            # a stream consumer joined a running file task: switch to
            # in-order fetching so read_ordered() does not stall behind
            # rarest-first pieces
            conductor.ordered = True
            engine = conductor._p2p_engine
            if engine is not None:
                engine.dispatcher.ordered = True
        if self._subset_gap(conductor, requested_shards):
            # the joiner needs shards (or the whole file) the live subset
            # download would never fetch: widen it so its done_event
            # covers both. A finished (or finishing: widen refuses)
            # subset download can't grow: a fresh conductor over the same
            # task storage adopts its pieces and fetches only the gap.
            if (conductor.done_event.is_set()
                    or not conductor.widen_to_whole_file()):
                return None
        return conductor

    @staticmethod
    def _subset_gap(conductor: PeerTaskConductor,
                    requested_shards: list[str] | None) -> bool:
        """True when ``conductor`` is a requested-subset download that
        does NOT cover this request's needs (other shards, or the whole
        file)."""
        if conductor.requested_shards is None:
            return False
        if requested_shards is None:
            return True
        return bool(set(requested_shards)
                    - set(conductor.requested_shards))

    def conductor(self, task_id: str) -> PeerTaskConductor | None:
        return self._conductors.get(task_id)

    def _start_prefetch(self, url: str, meta: UrlMeta) -> None:
        """Start the whole-file download behind a ranged request, in the
        background (best effort)."""
        whole = replace(meta, range="")
        task_id = self._task_id(url, whole)
        if (task_id in self._prefetching
                or self.storage_mgr.find_completed_task(task_id) is not None):
            return
        self._prefetching.add(task_id)

        async def run() -> None:
            try:
                conductor = await self.get_or_create_conductor(url, whole)
                await conductor.wait_done()
            except Exception:  # noqa: BLE001 - prefetch is best effort
                log.exception("whole-file prefetch of %s failed", url)
            finally:
                self._prefetching.discard(task_id)

        t = asyncio.get_running_loop().create_task(run())
        self._prefetch_tasks.add(t)
        t.add_done_callback(self._prefetch_tasks.discard)

    async def start_file_task(
            self, req: DownloadRequest) -> AsyncIterator[DownloadResponse]:
        """Download ``req.url``; yields progress frames and a final
        ``done`` frame, and raises the task's DFError on failure."""
        meta = req.url_meta or UrlMeta()
        task_id = self._task_id(req.url, meta)

        # reuse fast path: the completed task, or a whole-file parent
        # covering a ranged request, is already on disk
        reuse = self.storage_mgr.find_completed_task(task_id)
        rng: Range | None = None
        if meta.range and reuse is None:
            parent_id = ids.parent_task_id(
                req.url, tag=meta.tag, application=meta.application,
                digest=meta.digest,
                filtered_query_params=list(meta.filtered_query_params or []))
            parent = self.storage_mgr.get(parent_id)
            parent_done = (parent is not None and parent.md.done
                           and parent.md.content_length >= 0)
            if self.prefetch_whole_file and not parent_done:
                # warm the whole file so later ranges are local reads
                self._start_prefetch(req.url, meta)
            if parent_done:
                try:
                    rng = parse_http_range(meta.range,
                                           parent.md.content_length)
                except ValueError as exc:
                    raise DFError(Code.INVALID_ARGUMENT, str(exc)) from None
                reuse = self.storage_mgr.find_partial_completed_task(
                    parent_id, rng.start, rng.length)
                if reuse is None:
                    rng = None
        if reuse is not None:
            if req.output:
                await asyncio.to_thread(
                    reuse.store_to, req.output,
                    **({"range_start": rng.start, "range_length": rng.length}
                       if rng else {}))
            length = rng.length if rng else reuse.md.content_length
            yield DownloadResponse(task_id=task_id, peer_id="reused",
                                   completed_length=length,
                                   content_length=length, done=True,
                                   output=req.output)
            return

        device_factory = None
        if req.device_sink is not None and req.device_sink.enabled \
                and self.device_sink_builder is not None:
            device_factory = self.device_sink_builder(req.device_sink)

        conductor = await self.get_or_create_conductor(
            req.url, meta, task_type=req.task_type,
            disable_back_source=req.disable_back_source,
            device_sink_factory=device_factory,
            shard_manifest=req.shard_manifest)
        q = conductor.subscribe()
        try:
            while True:
                timeout = req.timeout_s if req.timeout_s > 0 else None
                try:
                    event = await asyncio.wait_for(q.get(), timeout)
                except asyncio.TimeoutError:
                    raise DFError(Code.DEADLINE_EXCEEDED,
                                  f"download timed out after {req.timeout_s}s") from None
                if event["type"] == "piece":
                    yield DownloadResponse(
                        task_id=conductor.task_id, peer_id=conductor.peer_id,
                        completed_length=event["completed"],
                        content_length=event["total"])
                elif event["type"] == "shard":
                    # one progress frame per shard whose bytes all verified
                    yield DownloadResponse(
                        task_id=conductor.task_id, peer_id=conductor.peer_id,
                        completed_length=conductor.completed_length,
                        content_length=conductor.content_length,
                        shard=event["name"], shard_src=event["src"],
                        shards_ready=event["ready"],
                        shards_total=event["total"])
                elif event["type"] == "done":
                    if not event.get("success"):
                        raise DFError(Code(event.get("code") or Code.UNKNOWN),
                                      event.get("message", "download failed"))
                    if req.output:
                        await asyncio.to_thread(conductor.storage.store_to,
                                                req.output)
                    yield DownloadResponse(
                        task_id=conductor.task_id, peer_id=conductor.peer_id,
                        completed_length=conductor.completed_length,
                        content_length=conductor.content_length,
                        done=True, output=req.output)
                    return
        finally:
            conductor.unsubscribe(q)

    async def stream_task(self, url: str, meta: UrlMeta | None = None,
                          ) -> tuple[str, AsyncIterator[bytes]]:
        """The task's bytes in order, as they land (the object gateway's
        GET): a completed task replays from disk, else the live conductor
        is joined, or one started, with in-order fetching."""
        meta = meta or UrlMeta()
        task_id = self._task_id(url, meta)
        reuse = self.storage_mgr.find_completed_task(task_id)
        if reuse is not None:
            async def replay() -> AsyncIterator[bytes]:
                for p in reuse.piece_infos():
                    yield await asyncio.to_thread(reuse.read_piece, p.num)
            return task_id, replay()
        conductor = await self.get_or_create_conductor(url, meta,
                                                       ordered=True)
        return task_id, conductor.read_ordered()

    async def stat_task(self, task_id: str) -> TaskStat:
        ts = self.storage_mgr.get(task_id)
        if ts is None:
            conductor = self._conductors.get(task_id)
            if conductor is None:
                raise DFError(Code.NOT_FOUND, f"task {task_id[:12]} not found")
            return TaskStat(id=task_id, state=conductor.state,
                            content_length=conductor.content_length,
                            total_piece_count=conductor.total_pieces)
        md = ts.md
        return TaskStat(id=task_id, type=md.task_type,
                        content_length=md.content_length,
                        total_piece_count=md.total_piece_count,
                        state="success" if md.success else
                              ("done" if md.done else "running"),
                        has_available_peer=md.done and md.success)

    async def import_file(self, path: str, url: str,
                          meta: UrlMeta | None = None,
                          task_type: TaskType = TaskType.PERSISTENT) -> str:
        """Make a local file a completed task under ``url``'s task id
        (the gateway's PUT): its pieces are cut, digested and stored as a
        back-source pull would store them. No scheduler is told; a seed
        serves the task when the scheduler triggers it. A task already
        complete is left as it is."""
        meta = meta or UrlMeta()
        task_id = self._task_id(url, meta)
        if self.storage_mgr.find_completed_task(task_id) is not None:
            return task_id
        conductor = PeerTaskConductor(
            task_id=task_id,
            peer_id=ids.peer_id(self.hostname, self.host_ip,
                                seed=self.is_seed),
            url=url, url_meta=meta, storage_mgr=self.storage_mgr,
            piece_mgr=self.piece_mgr, scheduler=None, task_type=task_type)
        self._conductors[task_id] = conductor

        async def run_import() -> None:
            try:
                await self.piece_mgr.import_file(conductor, path)
                await conductor._finish_success()
            except DFError as exc:
                await conductor._finish_fail(exc.code, exc.message)
            except Exception as exc:  # noqa: BLE001
                await conductor._finish_fail(Code.UNKNOWN, str(exc))

        # held, and awaited to its end: the loop holds tasks weakly
        import_task = asyncio.get_running_loop().create_task(run_import())
        try:
            await import_task
        except BaseException:
            import_task.cancel()
            await asyncio.gather(import_task, return_exceptions=True)
            raise
        if conductor.state != PeerTaskConductor.SUCCESS:
            raise DFError(conductor.fail_code, conductor.fail_message)
        return task_id

    async def delete_task(self, task_id: str) -> bool:
        conductor = self._conductors.pop(task_id, None)
        if conductor is not None and not conductor.done_event.is_set():
            conductor.cancel()
        return self.storage_mgr.delete_task(task_id)

    async def shutdown(self) -> None:
        for conductor in list(self._conductors.values()):
            if not conductor.done_event.is_set():
                conductor.cancel()
