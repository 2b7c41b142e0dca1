"""PeerTaskConductor: the per-(task, peer) download state machine.

Counterpart of ``dragonfly2_tpu/daemon/conductor.py`` cut to the
back-source rung: pull the task from its origin (``piece_manager``), land
and verify each piece in storage, stage it into the device sink, track
manifest shards as they complete, broadcast progress to subscribers, and
finalize with the digest checks.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from ..common import digest as digestlib
from ..common.errors import Code, DFError
from ..common.piece import Range, compute_piece_size, piece_count
from ..idl.messages import TaskType, UrlMeta
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
                 piece_mgr: Any, content_range: Range | None = None,
                 disable_back_source: bool = False,
                 task_type: TaskType = TaskType.STANDARD,
                 device_sink_factory: Any = None,
                 shard_manifest: Any = None):
        self.task_id = task_id
        self.peer_id = peer_id
        self.url = url
        self.url_meta = url_meta or UrlMeta()
        self.storage_mgr = storage_mgr
        self.piece_mgr = piece_mgr
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
        self.start_ms = int(time.time() * 1000)

        self.storage: TaskStorage | None = None
        self.device_ingest: Any = None
        self.ready: set[int] = set()          # piece numbers landed
        self._landing: set[int] = set()       # pieces mid-write (dedup race)
        self.done_event = asyncio.Event()
        self._subscribers: list[asyncio.Queue] = []
        self._run_task: asyncio.Task | None = None
        self.log = logging.LoggerAdapter(
            log, {"task": task_id[:12], "peer": peer_id[-12:]})

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._run_task is None:
            self.state = self.RUNNING
            self._run_task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        try:
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

    def _ingest_to_device(self, offset: int, data) -> None:
        """Stage one piece into the device sink; a failure disables the
        sink for the rest of the task (best-effort contract: the download
        still finishes to disk)."""
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

    def set_content_info(self, content_length: int) -> int:
        """Fix piece geometry; register storage + device sink. Returns the
        piece size. ``content_length`` is the EFFECTIVE length this task
        stores (the sub-range length for ranged tasks — piece offsets are
        range-relative). Safe to call more than once with identical values."""
        if self.piece_size:
            return self.piece_size
        self.content_length = content_length
        self.piece_size = compute_piece_size(content_length)
        self.total_pieces = piece_count(content_length, self.piece_size)
        md = TaskMetadata(
            task_id=self.task_id, task_type=self.task_type, url=self.url,
            tag=self.url_meta.tag, application=self.url_meta.application,
            content_length=content_length,
            total_piece_count=self.total_pieces,
            piece_size=self.piece_size, digest=self.url_meta.digest,
            priority=int(self.url_meta.priority),
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
        self.ready.add(num)
        self.completed_length += len(data)
        self._note_shard_progress(offset, len(data))
        self._publish({"type": "piece", "num": num, "size": len(data),
                       "completed": self.completed_length,
                       "total": self.content_length})

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
        self.log.info("task success: %d bytes, %d pieces",
                      self.completed_length, len(self.ready))

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
