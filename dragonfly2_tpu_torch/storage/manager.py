"""StorageManager: the daemon's registry of task storages, with warm
restart, content-addressed dedupe and disk GC.

Counterpart of ``dragonfly2_tpu/storage/manager.py`` (reference
``client/daemon/storage/storage_manager.go``: ``RegisterTask``,
``ReloadPersistentTask``, ``TryGC``), extended as the reference extends
it:

* every task shares one daemon-wide ``CAStore``, so pieces land indexed
  by digest and identical completed content coalesces onto one inode;
* **warm restart**: ``reload()`` re-indexes every task whose metadata
  loads, completed ones and partials whose pieces all carry digests;
  ``verify_reloaded_async()`` re-hashes those pieces on the storage pool
  before anything serves them, and drops only what fails;
* **GC**: a TTL sweep, then capacity eviction ordered by download
  priority, the content store's decayed serve popularity and recency,
  acting on physical (inode-deduped) bytes. Persistent tasks are spared.

Task directories are ``<data_dir>/<task_id[:3]>/<task_id>``, the
reference's layout, so either package reloads the other's. A ranged
sub-task (``register_subtask``) is a view over its parent's data file,
kept in memory only: a reload finds the parent alone, and the GC drops a
sub-task whose parent is gone or whose access time is past the TTL, after
the TTL sweep and before the capacity eviction, as the reference does.
A ranged request served from a finished parent
(``find_partial_completed_task``) reads the parent itself.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass

from ..common import digest as digestlib
from ..common.errors import Code, DFError
from ..common.metrics import REGISTRY
from ..idl.messages import TaskType
from .castore import CAStore
from .io_executor import run_io
from .metadata import METADATA_FILE, TaskMetadata
from .store import SubTaskStorage, TaskStorage

log = logging.getLogger("df.storage.manager")

# QoS class multipliers on serve popularity at capacity eviction: the
# same observed serve rate scores 4x higher for critical content and 4x
# lower for bulk ("" = unweighted). Priority stays the primary key.
CLASS_EVICT_WEIGHTS = {"critical": 4.0, "standard": 1.0, "bulk": 0.25}

_logical_gauge = REGISTRY.gauge(
    "df_storage_logical_bytes",
    "bytes the store's tasks occupy before digest-sharing (sum of "
    "per-task content)")
_physical_gauge = REGISTRY.gauge(
    "df_storage_physical_bytes",
    "bytes the store's tasks actually occupy on disk (hardlink-shared "
    "inodes counted once)")
_reload_pieces = REGISTRY.counter(
    "df_store_reload_pieces_total",
    "pieces re-indexed from disk at boot, by re-verification outcome",
    ("result",))


@dataclass
class StorageConfig:
    data_dir: str = ""
    task_ttl_s: float = 6 * 3600.0
    # GC starts above the high watermark and stops below the low one
    disk_gc_high_ratio: float = 0.90
    disk_gc_low_ratio: float = 0.80
    capacity_bytes: int = 0          # 0: the filesystem's capacity
    gc_interval_s: float = 60.0
    # content-addressed dedupe: cross-task piece placement and
    # completed-content hardlink coalescing
    dedupe_enabled: bool = True
    # crc-verify reloaded pieces before trusting them
    reload_verify: bool = True
    # serve-popularity decay half-life feeding the GC's eviction order
    popularity_halflife_s: float = 600.0

    def validate(self) -> None:
        if not (0 < self.disk_gc_low_ratio <= self.disk_gc_high_ratio <= 1):
            raise ValueError("bad GC watermarks")


def _verify_stats() -> dict:
    return {"tasks": 0, "pieces_ok": 0, "pieces_dropped": 0,
            "tasks_dropped": 0, "pieces_rot": 0}


class StorageManager:
    def __init__(self, cfg: StorageConfig):
        cfg.validate()
        self.cfg = cfg
        os.makedirs(cfg.data_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._tasks: dict[str, TaskStorage] = {}
        self._subtasks: dict[str, SubTaskStorage] = {}
        self.castore = CAStore(
            resolve=self._tasks.get,
            popularity_halflife_s=cfg.popularity_halflife_s) \
            if cfg.dedupe_enabled else None
        self.reloaded_tasks = 0       # tasks re-indexed by the last reload
        self.last_gc_stats: dict = {}
        self.reload()

    # -- registration --------------------------------------------------

    def _task_dir(self, task_id: str) -> str:
        return os.path.join(self.cfg.data_dir, task_id[:3], task_id)

    def register_task(self, md: TaskMetadata) -> TaskStorage:
        with self._lock:
            ts = self._tasks.get(md.task_id)
            if ts is None:
                ts = TaskStorage(self._task_dir(md.task_id), md,
                                 castore=self.castore)
                self._tasks[md.task_id] = ts
            return ts

    def register_subtask(self, md: TaskMetadata) -> SubTaskStorage:
        """A ranged sub-task sharing its parent's data file; an unknown
        parent is created empty, so the range lands at its final
        offset."""
        if not md.parent_task_id:
            raise DFError(Code.INVALID_ARGUMENT, "subtask needs parent_task_id")
        with self._lock:
            st = self._subtasks.get(md.task_id)
            if st is not None:
                return st
            parent = self._tasks.get(md.parent_task_id)
        if parent is None:
            parent = self.register_task(TaskMetadata(
                task_id=md.parent_task_id, url=md.url, tag=md.tag))
        st = SubTaskStorage(parent, md)
        with self._lock:
            self._subtasks[md.task_id] = st
        return st

    def get(self, task_id: str) -> TaskStorage | SubTaskStorage | None:
        with self._lock:
            return self._tasks.get(task_id) or self._subtasks.get(task_id)

    def find_completed_task(self, task_id: str) -> TaskStorage | None:
        with self._lock:
            ts = self._tasks.get(task_id)
        if ts is not None and ts.md.done and ts.md.success:
            ts.md.access_time = time.time()
            return ts
        return None

    def find_partial_completed_task(self, parent_task_id: str, start: int,
                                    length: int) -> TaskStorage | None:
        """The finished whole-file task that holds ``[start,
        start+length)``: any range of it is served from its file."""
        ts = self.find_completed_task(parent_task_id)
        if ts is None:
            return None
        if ts.md.content_length >= 0 and start + length <= ts.md.content_length:
            return ts
        return None

    def adopt_content(self, md: TaskMetadata) -> TaskStorage | None:
        """Materialize a whole task from identical content already held:
        when ``md.digest`` names content a completed task holds, the new
        task becomes a hardlink of its data file plus a copy of its piece
        table, before a byte is pulled. Blocking file work: run it on the
        storage executor. None = no hit."""
        if self.castore is None or not md.digest:
            return None
        src_tid = self.castore.find_content(md.digest)
        src = self.get(src_tid) if src_tid else None
        if src is None or not (src.md.done and src.md.success):
            return None
        if src.md.task_id == md.task_id:
            return src
        ts = self.register_task(md)
        if ts.md.done and ts.md.success:
            return ts                  # materialized earlier
        try:
            if not CAStore.link_shared(src, ts):
                return None
        except OSError:
            return None
        ts.adopt_from(src)
        ts.mark_done(success=True, content_length=src.md.content_length,
                     total_piece_count=src.md.total_piece_count)
        self.castore.record_serve(src.md.task_id, src.md.content_length,
                                  weight=0.5)
        return ts

    def tasks(self) -> list[TaskStorage]:
        with self._lock:
            return list(self._tasks.values())

    def delete_task(self, task_id: str) -> bool:
        with self._lock:
            ts = self._tasks.pop(task_id, None)
            self._subtasks.pop(task_id, None)
        if ts is None:
            return False
        if self.castore is not None:
            self.castore.drop_task(task_id)
        ts.destroy()
        return True

    # -- warm restart --------------------------------------------------

    def reload(self) -> int:
        """Re-index tasks from disk: completed ones, and partials whose
        every recorded piece carries a digest to re-verify (a finished
        shard subset's warm partial is one). Torn or digest-less metadata
        is discarded; the bytes are checked by ``verify_reloaded_async``."""
        n = 0
        root = self.cfg.data_dir
        for prefix in sorted(os.listdir(root)):
            pdir = os.path.join(root, prefix)
            if not os.path.isdir(pdir):
                continue
            for tid in sorted(os.listdir(pdir)):
                tdir = os.path.join(pdir, tid)
                if not os.path.exists(os.path.join(tdir, METADATA_FILE)):
                    shutil.rmtree(tdir, ignore_errors=True)
                    continue
                try:
                    md = TaskMetadata.load(tdir)
                except (OSError, ValueError, KeyError, TypeError):
                    # crash-safe saves make a torn file real corruption
                    shutil.rmtree(tdir, ignore_errors=True)
                    continue
                complete = md.done and md.success
                warm = (md.pieces
                        and all(p.digest for p in md.pieces.values()))
                if not complete and not warm:
                    shutil.rmtree(tdir, ignore_errors=True)
                    continue
                ts = TaskStorage(tdir, md, castore=self.castore)
                with self._lock:
                    self._tasks[md.task_id] = ts
                if self.castore is not None:
                    self.castore.add_task(ts)
                n += 1
        self.reloaded_tasks = n
        if n:
            log.info("reloaded %d tasks (completed + warm partials)", n)
        return n

    def _verify_task(self, ts: TaskStorage) -> tuple[int, int, bool, int]:
        """Re-hash one reloaded task's pieces against their recorded
        digests. Blocking: one unit of storage-executor work. Returns
        (pieces_ok, pieces_dropped, task_dropped, pieces_rot). A task that
        loses pieces is demoted to a partial (the next pull fetches just
        the holes); one that loses every piece is deleted. ``pieces_rot``
        counts drops from tasks that were complete: bytes that verified
        once and were finalized, so disk rot, where a partial's drop is a
        crash-torn write (data is not fsynced per write)."""
        md = ts.md
        was_complete = bool(md.done and md.success)
        bad: list[int] = []
        n_ok = 0
        for num, p in sorted(md.pieces.items()):
            ok = False
            if p.digest:
                try:
                    data = ts.read_range(p.start, p.size)
                    ok = (len(data) == p.size
                          and digestlib.verify(p.digest, data))
                except (DFError, OSError, ValueError):
                    ok = False
            if ok:
                n_ok += 1
                _reload_pieces.labels("ok").inc()
            else:
                bad.append(num)
                _reload_pieces.labels("dropped").inc()
        if not bad:
            return n_ok, 0, False, 0
        rot = len(bad) if was_complete else 0
        if len(bad) == len(md.pieces):
            self.delete_task(md.task_id)
            return n_ok, len(bad), True, rot
        with ts._lock:
            for num in bad:
                del md.pieces[num]
            md.done = md.success = False
            ts._cover_cache = None      # the table shrank
        ts.persist()
        if self.castore is not None:
            self.castore.drop_task(md.task_id)
            self.castore.add_task(ts)
        return n_ok, len(bad), False, rot

    def _fold(self, stats: dict, results) -> dict:
        for ok, dropped, gone, rot in results:
            stats["pieces_ok"] += ok
            stats["pieces_dropped"] += dropped
            stats["tasks_dropped"] += 1 if gone else 0
            stats["pieces_rot"] += rot
        if stats["pieces_dropped"] or stats["tasks_dropped"]:
            log.warning("reload verification dropped %d piece(s), "
                        "%d task(s)", stats["pieces_dropped"],
                        stats["tasks_dropped"])
        return stats

    def verify_reloaded(self) -> dict:
        """Blocking form of ``verify_reloaded_async``: a crashed writer's
        torn piece must never be served or counted as held."""
        stats = _verify_stats()
        if not self.cfg.reload_verify:
            return stats
        pending = [ts for ts in self.tasks() if ts.md.pieces]
        stats["tasks"] = len(pending)
        return self._fold(stats, [self._verify_task(ts) for ts in pending])

    async def verify_reloaded_async(self) -> dict:
        """Boot form: one storage-executor job per task, gathered, so the
        re-hash spreads over the pool instead of one thread."""
        stats = _verify_stats()
        if not self.cfg.reload_verify:
            return stats
        pending = [ts for ts in self.tasks() if ts.md.pieces]
        stats["tasks"] = len(pending)
        return self._fold(stats, await asyncio.gather(
            *(run_io(self._verify_task, ts) for ts in pending)))

    # -- GC ------------------------------------------------------------

    def usage(self) -> tuple[int, int]:
        """(logical_bytes, physical_bytes): the per-task sum against the
        inode-deduped footprint, where shared content counts once."""
        logical = 0
        physical = 0
        seen: set[tuple[int, int]] = set()
        for ts in self.tasks():
            sz = ts.disk_usage()
            logical += sz
            ino = ts.inode()
            if ino is None or ino not in seen:
                physical += sz
                if ino is not None:
                    seen.add(ino)
        _logical_gauge.set(logical)
        _physical_gauge.set(physical)
        if self.castore is not None:
            self.castore.update_shared_gauge(logical, physical)
        return logical, physical

    def _usage(self) -> tuple[int, int]:
        """(physical_used_bytes, capacity_bytes) for the GC watermarks."""
        _logical, physical = self.usage()
        if self.cfg.capacity_bytes:
            return physical, self.cfg.capacity_bytes
        try:
            return physical, shutil.disk_usage(self.cfg.data_dir).total
        except OSError:
            return physical, 0

    def try_gc(self) -> int:
        """TTL sweep, then capacity eviction, least popular first.

        A task not done is active while its access time is fresh; stale
        past the TTL it is an abandoned download and reclaimed too.
        Capacity eviction orders by download priority, then the content
        store's class-weighted decayed serve popularity, then oldest
        access. Deleting one alias of hardlink-shared content frees about
        no physical bytes, so the sweep goes on until the physical
        watermark is met."""
        reclaimed = 0
        logical_freed = 0
        physical_freed = 0
        now = time.time()
        candidates: list[TaskStorage] = []
        for ts in self.tasks():
            if ts.md.task_type != TaskType.STANDARD:
                continue  # persistent cache entries are pinned
            stale = now - ts.md.access_time > self.cfg.task_ttl_s
            if not ts.md.done and not stale:
                continue  # active download
            if stale:
                sz = ts.disk_usage()
                shared = ts.nlink() > 1
                if self.delete_task(ts.md.task_id):
                    reclaimed += 1
                    logical_freed += sz
                    if not shared:
                        physical_freed += sz
            else:
                candidates.append(ts)
        with self._lock:
            dead_subs = [tid for tid, st in self._subtasks.items()
                         if st.parent.md.task_id not in self._tasks
                         or now - st.md.access_time > self.cfg.task_ttl_s]
            for tid in dead_subs:
                del self._subtasks[tid]
        used, cap = self._usage()
        if cap and used / cap > self.cfg.disk_gc_high_ratio:
            target = int(cap * self.cfg.disk_gc_low_ratio)
            mono = time.monotonic()

            def evict_key(t: TaskStorage):
                pop = (self.castore.popularity(t.md.task_id, now=mono)
                       if self.castore is not None else 0.0)
                pop *= CLASS_EVICT_WEIGHTS.get(t.md.qos_class, 1.0)
                # lowest download priority first (numeric DESC), then
                # coldest by weighted serve popularity, then oldest access
                return (-t.md.priority, pop, t.md.access_time)

            candidates.sort(key=evict_key)
            for ts in candidates:
                if used <= target:
                    break
                sz = ts.disk_usage()
                # the last link to an inode frees bytes; an alias of
                # still-referenced content frees only its metadata
                freed = sz if ts.nlink() <= 1 else 0
                if self.delete_task(ts.md.task_id):
                    used -= freed
                    logical_freed += sz
                    physical_freed += freed
                    reclaimed += 1
        self.last_gc_stats = {
            "reclaimed_tasks": reclaimed,
            "logical_bytes_freed": logical_freed,
            "physical_bytes_freed": physical_freed,
        }
        return reclaimed
