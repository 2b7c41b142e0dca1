"""CAStore: the daemon's content-addressed index over task piece files.

Counterpart of ``dragonfly2_tpu/storage/castore.py`` (no role in the
upstream Dragonfly2, which keys storage by task id):

* **piece index**: every verified piece recorded in any task's metadata
  is indexed by its content digest. A piece a new task needs that is on
  disk under any task is **placed** (a local, re-verified copy) instead
  of transferred: the conductor consults ``find_piece`` before the
  dispatcher may queue a pull.
* **content identity**: a completed task is fingerprinted by its piece
  geometry and ordered piece-digest vector (``content_key``). When two
  completed tasks carry the same fingerprint, the later one's data file
  becomes a **hardlink** to the first, and a request naming a content
  digest the store holds is adopted whole (``find_content``).
* **popularity**: serves and placements feed a half-life-decayed
  per-task score the storage GC orders eviction by.

Everything here is synchronous dict and file work under one lock; the
byte-moving entry points (``place_piece``, ``on_task_complete``) run on
the storage executor, never the event loop. The index is rebuilt from
task metadata at boot (``StorageManager.reload``), so there is no index
file to tear.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import threading
import time
from typing import Callable

from ..common import digest as digestlib
from ..common.metrics import REGISTRY

log = logging.getLogger("df.storage.cas")

_dedupe_hits = REGISTRY.counter(
    "df_store_dedupe_hits_total",
    "pieces or whole tasks served from the content-addressed store "
    "instead of the wire", ("kind",))
_dedupe_bytes = REGISTRY.counter(
    "df_store_dedupe_bytes_total",
    "bytes placed from already-held content instead of transferred")
_digests_gauge = REGISTRY.gauge(
    "df_store_digests",
    "distinct piece digests currently indexed by the content store")
_shared_gauge = REGISTRY.gauge(
    "df_store_shared_bytes",
    "bytes saved on disk by hardlink-shared task content (logical minus "
    "physical)")
_place_failures = REGISTRY.counter(
    "df_store_place_failures_total",
    "dedupe placements abandoned mid-flight (holder evicted or bytes "
    "failed re-verification)", ("reason",))


class _Pop:
    """Half-life-decayed popularity counter (serves + dedupe placements)."""

    __slots__ = ("score", "at")

    def __init__(self) -> None:
        self.score = 0.0
        self.at = time.monotonic()

    def bump(self, weight: float, halflife_s: float) -> None:
        now = time.monotonic()
        if halflife_s > 0:
            self.score *= 0.5 ** ((now - self.at) / halflife_s)
        self.score += weight
        self.at = now

    def value(self, now: float, halflife_s: float) -> float:
        if halflife_s <= 0:
            return self.score
        return self.score * (0.5 ** ((now - self.at) / halflife_s))


def content_key(md) -> tuple | None:
    """The content fingerprint of a COMPLETE task: geometry + the ordered
    piece-digest vector, hashed. Two tasks with the same key hold
    byte-identical content even when no whole-file digest was ever known
    (the digest vector covers every byte). None while incomplete or while
    any piece lacks a digest."""
    if not (md.done and md.success) or md.content_length < 0 \
            or not md.pieces:
        return None
    if md.total_piece_count >= 0 and len(md.pieces) < md.total_piece_count:
        return None
    vec = []
    for num in sorted(md.pieces):
        dg = md.pieces[num].digest
        if not dg:
            return None
        vec.append(dg)
    h = hashlib.sha256("\n".join(vec).encode()).hexdigest()
    return (md.content_length, md.piece_size, h)


class CAStore:
    """Digest → on-disk location index with popularity accounting.

    ``resolve`` maps a task id to its live TaskStorage (StorageManager
    wires its own lookup in) — the index never outlives the tasks it
    points into because ``drop_task`` runs inside every delete path.
    """

    def __init__(self, *, resolve: Callable | None = None,
                 popularity_halflife_s: float = 600.0):
        self.resolve = resolve or (lambda _tid: None)
        self.popularity_halflife_s = popularity_halflife_s
        # local bit-rot observer: a placement whose source bytes fail
        # re-verification means this daemon's disk lied; the callable gets
        # the failing task id
        self.on_rot: Callable[[str], None] | None = None
        self._lock = threading.Lock()
        # digest -> {task_id -> (start, size)}
        self._locs: dict[str, dict[str, tuple[int, int]]] = {}
        self._task_digests: dict[str, set[str]] = {}
        # content fingerprint -> live completed holders (first = canonical;
        # a LIST so evicting the canonical alias promotes the next holder
        # instead of forgetting that the content is still on disk)
        self._content: dict[tuple, list[str]] = {}
        # whole-content digest ("sha256:...") -> live completed holders
        self._content_digest: dict[str, list[str]] = {}
        self._pop: dict[str, _Pop] = {}

    # -- indexing ------------------------------------------------------

    def add_piece(self, task_id: str, num: int, start: int, size: int,
                  digest: str) -> None:
        if not digest:
            return
        with self._lock:
            self._locs.setdefault(digest, {})[task_id] = (start, size)
            self._task_digests.setdefault(task_id, set()).add(digest)
            _digests_gauge.set(len(self._locs))

    def add_task(self, ts) -> None:
        """Index every recorded piece of a (reloaded or completed) task."""
        md = ts.md
        for num, p in md.pieces.items():
            self.add_piece(md.task_id, num, p.start, p.size, p.digest)
        if md.done and md.success:
            key = content_key(md)
            with self._lock:
                if key is not None:
                    holders = self._content.setdefault(key, [])
                    if md.task_id not in holders:
                        holders.append(md.task_id)
                if md.digest:
                    holders = self._content_digest.setdefault(md.digest, [])
                    if md.task_id not in holders:
                        holders.append(md.task_id)

    def drop_task(self, task_id: str) -> None:
        with self._lock:
            for dg in self._task_digests.pop(task_id, ()):
                holders = self._locs.get(dg)
                if holders is not None:
                    holders.pop(task_id, None)
                    if not holders:
                        del self._locs[dg]
            for index in (self._content, self._content_digest):
                for key in [k for k, ids in index.items()
                            if task_id in ids]:
                    index[key] = [t for t in index[key] if t != task_id]
                    if not index[key]:
                        del index[key]
            self._pop.pop(task_id, None)
            _digests_gauge.set(len(self._locs))

    # -- lookups -------------------------------------------------------

    def find_piece(self, digest: str, size: int,
                   *, exclude_task: str = "") -> tuple[str, int] | None:
        """A live (task_id, start) holding ``digest`` at ``size`` bytes."""
        if not digest:
            return None
        with self._lock:
            holders = self._locs.get(digest)
            if not holders:
                return None
            for tid, (start, sz) in holders.items():
                if sz == size and tid != exclude_task:
                    return tid, start
        return None

    def find_content(self, content_digest: str) -> str | None:
        """A live completed task id holding the given whole-content
        digest (the first holder whose storage still resolves)."""
        with self._lock:
            ids = list(self._content_digest.get(content_digest) or ())
        for tid in ids:
            if self.resolve(tid) is not None:
                return tid
        return None

    # -- byte movement (storage executor only) -------------------------

    def place_piece(self, dst, num: int, offset: int, size: int,
                    digest: str) -> bool:
        """Copy an already-held piece into ``dst`` (a TaskStorage), with
        the bytes re-verified against ``digest`` during the hop — a local
        disk copy instead of a network transfer. BLOCKING: run on the
        storage executor. False = no live holder survived verification
        (the caller falls back to a normal pull)."""
        tried: set[str] = set()
        while True:
            loc = self.find_piece(digest, size, exclude_task=dst.md.task_id)
            if loc is None:
                return False
            src_tid, start = loc
            if src_tid in tried:
                return False
            tried.add(src_tid)
            src = self.resolve(src_tid)
            if src is None:
                self._drop_loc(digest, src_tid)
                continue
            try:
                data = src.read_range(start, size)
            except Exception:  # noqa: BLE001 - holder evicted mid-read
                self._drop_loc(digest, src_tid)
                _place_failures.labels("holder_gone").inc()
                continue
            if len(data) != size or not digestlib.verify(digest, data):
                # bit-rot (or a lying index entry): drop the loc so the
                # next placement never trusts it again
                self._drop_loc(digest, src_tid)
                _place_failures.labels("verify").inc()
                log.warning("cas placement of %s from %s failed "
                            "verification; dropped", digest, src_tid[:12])
                if self.on_rot is not None:
                    self.on_rot(src_tid)
                continue
            dst.write_piece(num, offset, data, digest, source="cas",
                            pre_verified=True)
            _dedupe_hits.labels("piece").inc()
            _dedupe_bytes.inc(size)
            self.record_serve(src_tid, size, weight=0.25)
            return True

    def note_hit(self, kind: str, nbytes: int) -> None:
        """Count a dedupe hit landed by a caller that moved (or skipped)
        the bytes itself — ``task`` = pieces already recorded under the
        requesting task (warm restart), ``content`` = whole-task adoption."""
        _dedupe_hits.labels(kind).inc()
        _dedupe_bytes.inc(nbytes)

    def _drop_loc(self, digest: str, task_id: str) -> None:
        with self._lock:
            holders = self._locs.get(digest)
            if holders is not None:
                holders.pop(task_id, None)
                if not holders:
                    del self._locs[digest]

    def on_task_complete(self, ts) -> bool:
        """Register a freshly completed task; when another completed task
        already carries the identical content fingerprint, replace this
        task's data file with a hardlink to the canonical copy so the
        bytes exist ONCE on disk. BLOCKING (rides mark_done's run_io hop).
        Returns True when the file became shared."""
        md = ts.md
        key = content_key(md)
        canonical_id = None
        if key is not None:
            with self._lock:
                holders = [t for t in self._content.get(key, ())
                           if t != md.task_id]
            canonical_id = next(
                (t for t in holders if self.resolve(t) is not None), None)
        self.add_task(ts)
        if canonical_id is None or canonical_id == md.task_id:
            return False
        src = self.resolve(canonical_id)
        if src is None:
            return False
        already = src.inode() is not None and src.inode() == ts.inode()
        try:
            if self.link_shared(src, ts):
                if not already:
                    # only a NEW coalescing counts: mark_done re-runs on
                    # adopted tasks and must not re-count the same link
                    _dedupe_hits.labels("content").inc()
                return True
        except OSError as exc:
            log.debug("content dedupe link failed (%s); keeping the copy",
                      exc)
        return False

    @staticmethod
    def link_shared(src, dst) -> bool:
        """Atomically swap ``dst``'s data file for a hardlink to ``src``'s.
        Both tasks are complete and immutable; readers mid-flight keep
        their old fd (same bytes), new opens see the shared inode."""
        src_path, dst_path = src.data_path(), dst.data_path()
        st_src, st_dst = os.stat(src_path), os.stat(dst_path)
        if st_src.st_dev != st_dst.st_dev:
            return False               # hardlinks need one filesystem
        if st_src.st_ino == st_dst.st_ino:
            return True                # already shared
        tmp = dst_path + ".cas"
        try:
            os.link(src_path, tmp)
            os.replace(tmp, dst_path)
        finally:
            try:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            except OSError:
                pass
        dst.close()                    # next lease opens the shared inode
        return True

    # -- popularity ----------------------------------------------------

    def record_serve(self, task_id: str, nbytes: int,
                     *, weight: float = 1.0) -> None:
        """Feed the eviction score: one serve (or placement read) of this
        task. Byte-weighted so a task serving whole models outranks one
        serving crumbs; decayed so yesterday's hot model can leave."""
        with self._lock:
            pop = self._pop.get(task_id)
            if pop is None:
                pop = self._pop[task_id] = _Pop()
            pop.bump(weight * (1.0 + math.log2(1 + nbytes / (1 << 20))),
                     self.popularity_halflife_s)

    def popularity(self, task_id: str, *, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            pop = self._pop.get(task_id)
            if pop is None:
                return 0.0
            return pop.value(now, self.popularity_halflife_s)

    # -- accounting ----------------------------------------------------

    def update_shared_gauge(self, logical: int, physical: int) -> None:
        _shared_gauge.set(max(logical - physical, 0))

    def stats(self) -> dict:
        with self._lock:
            return {
                "digests": len(self._locs),
                "piece_refs": sum(len(h) for h in self._locs.values()),
                "contents": len(self._content),
                "content_digests": len(self._content_digest),
                "popular_tasks": len(self._pop),
            }
