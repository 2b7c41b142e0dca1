"""PeerTaskConductor: the per-(task, peer) download state machine.

Counterpart of ``dragonfly2_tpu/daemon/conductor.py`` (reference
``client/daemon/peer/peertask_conductor.go``): register with the
scheduler, pull the pieces from parent peers (``piece_engine``) or, when
P2P has nothing for the task, back to source (``piece_manager``); land and
verify each piece in storage, stage it into the device sink, track
manifest shards as they complete, broadcast progress to subscribers,
finalize with the digest checks, and only then close the scheduler
session with the task's ``PeerResult``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from ..common import digest as digestlib
from ..common.errors import Code, DFError
from ..common.piece import Range, compute_piece_size, piece_count
from ..idl.messages import PieceInfo, PieceResult, TaskType, UrlMeta
from ..storage.io_executor import run_io
from ..storage.manager import StorageManager
from ..storage.metadata import TaskMetadata
from ..storage.store import TaskStorage

log = logging.getLogger("df.core.conductor")


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
                 shard_manifest: Any = None):
        self.task_id = task_id
        self.peer_id = peer_id
        self.url = url
        self.url_meta = url_meta or UrlMeta()
        # the scheduler may refine this at register (application table)
        self.resolved_priority = int(self.url_meta.priority)
        self.storage_mgr = storage_mgr
        self.piece_mgr = piece_mgr
        self.scheduler = scheduler
        self.content_range = content_range
        self.disable_back_source = disable_back_source
        self.task_type = task_type
        self.device_sink_factory = device_sink_factory
        # sharded-task delivery (common/sharding.py): the manifest's shard
        # table and — once piece geometry is known (_init_shards) — the
        # tracker that turns verified piece landings into shard readiness.
        # Ranged requests keep the whole-file path: a manifest's offsets
        # are content-absolute and a sub-range task's are range-relative.
        shards = getattr(shard_manifest, "shards", shard_manifest)
        self.shard_manifest = (list(shards) if shards
                               and content_range is None
                               and not self.url_meta.range else None)
        self.shard_tracker: Any = None

        self.state = self.PENDING
        self.fail_code = Code.OK
        self.fail_message = ""
        self.content_length = -1
        self.piece_size = 0
        self.total_pieces = -1
        self.completed_length = 0
        self.traffic_p2p = 0          # bytes from peers
        self.traffic_source = 0       # bytes from origin
        self.pieces_by_parent: dict[str, int] = {}   # P2P pieces per parent
        self.start_ms = int(time.time() * 1000)

        self.storage: TaskStorage | None = None
        self.device_ingest: Any = None
        self.ready: set[int] = set()          # piece numbers landed
        self._landing: set[int] = set()       # pieces mid-write (dedup race)
        self.done_event = asyncio.Event()
        self._piece_cond = asyncio.Condition()
        self._subscribers: list[asyncio.Queue] = []
        self._run_task: asyncio.Task | None = None
        self._p2p_engine: Any = None
        self._session: Any = None      # scheduler PeerSession once registered
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

    async def _run(self) -> None:
        """The ladder (reference ``conductor.py:203-272``): register; pull
        P2P when the scheduler answered; back to source when P2P could not
        finish and back-source is allowed; finalize; then close the
        session, so the PeerResult carries the real outcome."""
        try:
            used_p2p = False
            if self.scheduler is not None:
                self._session = await self._register()
                if self._session is not None and self._p2p_engine is not None:
                    used_p2p = await self._p2p_engine.pull(self,
                                                           self._session)
            if not used_p2p:
                if self.disable_back_source:
                    raise DFError(Code.CLIENT_BACK_SOURCE_ERROR,
                                  "no P2P path and back-source disabled")
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

    async def _register(self):
        """Register with the scheduler; None means "go to origin" (the
        reference's fallback ladder: register failed or NeedBackSource)."""
        try:
            return await self.scheduler.register(self)
        except DFError as exc:
            if exc.code in (Code.UNAVAILABLE, Code.DEADLINE_EXCEEDED,
                            Code.SCHED_NEED_BACK_SOURCE):
                self.log.info("register: %s; no P2P", exc.message)
                return None
            raise
        except Exception as exc:  # noqa: BLE001 - scheduler unreachable
            self.log.warning("scheduler unreachable (%s); no P2P", exc)
            return None

    def _ingest_to_device(self, offset: int, data) -> None:
        """Stage one piece into the device sink; a failure disables the
        sink for the rest of the task (best-effort contract: the download
        still finishes to disk). The one copy of the write-or-disable
        sequence: origin and peer landings both stage through here."""
        if self.device_ingest is None:
            return
        try:
            self.device_ingest.write(offset, data)
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
        except ValueError:
            self.log.exception("bad shard manifest; whole-file fallback")
            self.shard_manifest = None
            return
        self.shard_tracker = sharding.ShardTracker(self.shard_manifest)
        self.log.info("sharded task: %d shards", self.shard_tracker.total)

    def _note_shard_progress(self, offset: int, size: int) -> None:
        """One verified piece landed: publish any shard it completed."""
        tracker = self.shard_tracker
        if tracker is None:
            return
        t = time.time() * 1000 - self.start_ms
        for name in tracker.on_span(offset, offset + size, t):
            self._publish({"type": "shard", "name": name, "src": "tree",
                           "bytes": tracker.shard_for(name).range_size,
                           "ready": len(tracker.ready),
                           "total": tracker.total})

    def _device_shard_specs(self) -> list[tuple] | None:
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
        comes from the swarm. Safe to call more than once."""
        if self.piece_size:
            return self.piece_size
        self.content_length = content_length
        self.piece_size = piece_size or compute_piece_size(content_length)
        self.total_pieces = piece_count(content_length, self.piece_size)
        md = TaskMetadata(
            task_id=self.task_id, task_type=self.task_type, url=self.url,
            tag=self.url_meta.tag, application=self.url_meta.application,
            content_length=content_length,
            total_piece_count=self.total_pieces,
            piece_size=self.piece_size, digest=self.url_meta.digest,
            priority=self.resolved_priority,
            qos_class=self.url_meta.qos_class)
        self.storage = self.storage_mgr.register_task(md)
        self._init_shards()
        if (self.device_sink_factory is not None and content_length > 0
                and self.device_ingest is None):
            try:
                self.device_ingest = self._make_device_ingest(content_length)
            except Exception:  # device sink is best-effort
                self.log.exception("device sink init failed; continuing to disk")
        return self.piece_size

    async def on_piece_from_source(self, num: int, offset: int, data: bytes,
                                   cost_ms: int) -> None:
        """Land, verify and stage one piece. A duplicate changes nothing."""
        if self.storage is None:
            raise DFError(Code.CLIENT_STORAGE_ERROR, "piece before content info")
        if num in self.ready or num in self._landing:
            # _landing claims the piece BEFORE the await below, so two
            # near-simultaneous landings of one piece cannot both count
            return
        self._landing.add(num)
        try:
            # hashing + write take ms at 16 MiB: the dedicated storage
            # executor runs them, never the event loop
            await run_io(self.storage.write_piece, num, offset, data,
                         cost_ms=cost_ms)
        finally:
            self._landing.discard(num)
        if num in self.ready:     # lost a race decided elsewhere
            return
        # write() is a memcpy + enqueue; the copy runs on the sink's own
        # thread and is never awaited here
        self._ingest_to_device(offset, data)
        async with self._piece_cond:
            self.ready.add(num)
            self.completed_length += len(data)
            self.traffic_source += len(data)
            self._piece_cond.notify_all()
        self._note_shard_progress(offset, len(data))
        self._publish({"type": "piece", "num": num, "size": len(data),
                       "completed": self.completed_length,
                       "total": self.content_length})
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

    def pieces_remaining(self) -> int:
        """Pieces still to land (-1 = unknown geometry)."""
        if self.total_pieces < 0:
            return -1
        return self.total_pieces - len(self.ready)

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
            metas, corrupt = await run_io(
                self.storage.write_span, spec, data, base=base,
                cost_ms=cost_ms_per_piece, source=parent_id)
        finally:
            for p in claim:
                self._landing.discard(p.piece_num)
        by_num = {p.piece_num: p for p in claim}
        placed = [m.num for m in metas if m.num not in self.ready]
        if self.device_ingest is not None:
            view = memoryview(data)
            try:
                for n in placed:
                    p = by_num[n]
                    lo = p.range_start - base
                    self._ingest_to_device(p.range_start,
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
                events.append({"type": "piece", "num": n, "size": size,
                               "completed": self.completed_length,
                               "total": self.content_length})
            self._piece_cond.notify_all()
        for n in counted:
            p = by_num[n]
            self._note_shard_progress(p.range_start, p.range_size)
        for ev in events:
            self._publish(ev)
        return counted, corrupt, raced

    # ------------------------------------------------------------------
    # finalize
    # ------------------------------------------------------------------

    async def _verify_digest(self) -> None:
        if not self.url_meta.digest or self.storage is None:
            return
        if self.content_range is not None:
            # the digest describes the whole file; a sub-range can't check it
            return
        algo, want = digestlib.parse(self.url_meta.digest)
        path = self.storage.data_path()
        length = self.content_length

        def compute() -> str:
            def chunks():
                with open(path, "rb") as f:
                    remaining = length
                    while remaining > 0:
                        b = f.read(min(4 << 20, remaining))
                        if not b:
                            return
                        remaining -= len(b)
                        yield b
            return digestlib.hash_stream(algo, chunks())

        # default executor ON PURPOSE (not run_io): a full-content hash of
        # many GB must not park piece landings on the storage pool
        got = await asyncio.to_thread(compute)
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
        if self.total_pieces >= 0 and len(self.ready) < self.total_pieces:
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          f"incomplete: {len(self.ready)}/{self.total_pieces} pieces")
        await self._verify_shard_digests()
        await self._verify_digest()
        if self.storage is not None:
            await run_io(self.storage.mark_done, success=True,
                         content_length=self.content_length,
                         total_piece_count=self.total_pieces)
        if self.device_ingest is not None:
            try:
                self.device_ingest.flush()   # enqueue-only, non-blocking
            except Exception:
                self.log.exception("device sink flush failed")
                self.device_ingest.close()
                self.device_ingest = None
        self.state = self.SUCCESS
        self._publish({"type": "done", "success": True,
                       "completed": self.completed_length,
                       "total": self.content_length})
        self.done_event.set()
        async with self._piece_cond:
            self._piece_cond.notify_all()
        self.log.info("task success: %d bytes, %d pieces (p2p=%d src=%d)",
                      self.completed_length, len(self.ready),
                      self.traffic_p2p, self.traffic_source)

    async def _finish_fail(self, code: Code, message: str) -> None:
        if self.state in (self.SUCCESS, self.FAILED):
            return
        self.state = self.FAILED
        self.fail_code = code
        self.fail_message = message
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
