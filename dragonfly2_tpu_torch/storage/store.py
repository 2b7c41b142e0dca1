"""TaskStorage: the piece-addressed store for one task, and
SubTaskStorage, a ranged view over it.

Counterpart of ``dragonfly2_tpu/storage/store.py`` (``TaskStorage``,
``SubTaskStorage``). Pieces are written at their offsets with per-piece
digest verification, one at a time (``write_piece``) or as a downloaded
span in one pass (``write_span``); reads feed the device sink, the upload
server and the final output, and ``covered_prefix`` gives the relay plane
the landed frontier (``daemon/relay.py``). Where a piece's digest is crc32c (or none is
given), the native library writes and checksums it in one traversal
(``native.span_write``); otherwise one pwrite and a Python hash. Every
verified piece is indexed in the daemon's content store (``castore``) when
one is attached. Piece IO is pread/pwrite on the task's cached descriptor,
leased through ``_data_fd``: a ``close`` (GC eviction, ``destroy``, the
content store's hardlink swap) that arrives while IO holds a lease is
deferred to the last releaser, and a lease taken while that close is
pending opens a private descriptor, so a task destroyed mid-IO fails the
call cleanly instead of writing into a reused or unlinked descriptor.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import os
import shutil
import threading
import time

from ..common import digest as digestlib
from ..common.errors import Code, DFError
from . import native
from .metadata import DATA_FILE, PieceMeta, TaskMetadata


def _pread_all(fd: int, length: int, offset: int) -> bytes:
    """pread ``length`` bytes at ``offset``; short only at EOF."""
    parts = []
    got = 0
    while got < length:
        b = os.pread(fd, length - got, offset + got)
        if not b:
            break
        parts.append(b)
        got += len(b)
    return parts[0] if len(parts) == 1 else b"".join(parts)


def _pwrite_all(fd: int, data, offset: int) -> None:
    """pwrite the whole buffer (the kernel may write short)."""
    view = memoryview(data)
    while len(view):
        n = os.pwrite(fd, view, offset)
        view = view[n:]
        offset += n


class TaskStorage:
    """One task's on-disk state. Thread-safe for concurrent piece writes."""

    def __init__(self, task_dir: str, metadata: TaskMetadata,
                 castore=None):
        self.dir = task_dir
        self.md = metadata
        # the daemon's content-addressed index (storage/castore.py): every
        # verified piece landed here is registered by digest; None = off
        self.castore = castore
        self._lock = threading.Lock()
        self._save_lock = threading.Lock()     # one metadata save at a time
        self._fd: int | None = None        # cached O_RDWR fd (lazy)
        self._fd_users = 0                 # leases out via _data_fd()
        self._fd_close_deferred = False    # close() arrived mid-lease
        # covered_prefix memo: (piece count, merged [start, end) spans)
        self._cover_cache: tuple[int, list[list[int]]] | None = None
        self._data_path = os.path.join(task_dir, DATA_FILE)
        os.makedirs(task_dir, exist_ok=True)
        if not os.path.exists(self._data_path):
            with open(self._data_path, "wb"):
                pass

    @contextlib.contextmanager
    def _data_fd(self):
        """A refcounted lease on the task's cached data fd.

        ``close`` during a lease is deferred to the last releaser: closing
        the fd under a pread/pwrite would at best fail the IO and at worst,
        once the number is reused by another task's open, land the bytes
        in that task's file. While a close is deferred the cached fd may
        point at an unlinked inode (``destroy`` closes, then removes the
        directory), so a new lease opens a private fd from the path, which
        fails safe after ``destroy``."""
        private = False
        with self._lock:
            if self._fd_close_deferred:
                private = True
            else:
                if self._fd is None:
                    self._fd = os.open(self._data_path, os.O_RDWR)
                fd = self._fd
                self._fd_users += 1
        if private:
            fd = os.open(self._data_path, os.O_RDWR)
            try:
                yield fd
            finally:
                try:
                    os.close(fd)
                except OSError:
                    pass
            return
        try:
            yield fd
        finally:
            with self._lock:
                self._fd_users -= 1
                close_now = (self._fd_close_deferred
                             and self._fd_users == 0
                             and self._fd is not None)
                if close_now:
                    fd, self._fd = self._fd, None
                    self._fd_close_deferred = False
            if close_now:
                try:
                    os.close(fd)
                except OSError:
                    pass

    def close(self) -> None:
        """Drop the cached fd; the next lease reopens the path. With IO
        in flight the close waits for the last lease."""
        with self._lock:
            if self._fd is None:
                self._fd_close_deferred = False
                return
            if self._fd_users:
                self._fd_close_deferred = True
                return
            fd, self._fd = self._fd, None
        try:
            os.close(fd)
        except OSError:
            pass

    def _write(self, offset: int, data, sizes: list[int],
               fused: bool) -> list[str] | None:
        """pwrite ``data`` at ``offset``; with ``fused``, through the native
        library with each piece's crc32c folded in (the list it returns,
        None when the library is absent and the plain write ran)."""
        try:
            with self._data_fd() as fd:
                crcs = (native.span_write(fd, offset, data, sizes)
                        if fused else None)
                if crcs is None:
                    _pwrite_all(fd, data, offset)
                return crcs
        except OSError as exc:
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          f"write @{offset}+{sum(sizes)} failed: "
                          f"{exc}") from None

    def write_piece(self, num: int, offset: int, data: bytes | memoryview,
                    piece_digest: str = "", *, cost_ms: int = 0,
                    source: str = "", pre_verified: bool = False) -> PieceMeta:
        """Verify + persist one piece. Idempotent per piece number.
        ``pre_verified`` skips the re-hash when the transport already
        checked the bytes against ``piece_digest``. A crc32c piece (or one
        without a digest) is written and checksummed in one pass; a
        mismatch found after the write is safe, since the piece is never
        recorded and its region stays absent."""
        with self._lock:
            existing = self.md.pieces.get(num)
            if existing is not None:
                return existing
        algo = want = ""
        if piece_digest:
            algo, want = digestlib.parse(piece_digest)
        crcs = self._write(offset, data, [len(data)],
                           fused=not piece_digest or algo == "crc32c")
        if crcs is not None:
            if not piece_digest:
                piece_digest = f"crc32c:{crcs[0]}"
            elif crcs[0] != want:
                raise DFError(Code.CLIENT_DIGEST_MISMATCH,
                              f"piece {num} digest mismatch")
        elif piece_digest:
            if not pre_verified and not digestlib.verify(piece_digest, data):
                raise DFError(Code.CLIENT_DIGEST_MISMATCH,
                              f"piece {num} digest mismatch")
        else:
            piece_digest = digestlib.for_bytes(
                digestlib.preferred_piece_algo(), data)
        meta = PieceMeta(num=num, start=offset, size=len(data),
                         digest=piece_digest, cost_ms=cost_ms, source=source)
        with self._lock:
            self.md.pieces[num] = meta
            self.md.access_time = time.time()
        if self.castore is not None:
            self.castore.add_piece(self.md.task_id, num, offset, len(data),
                                   piece_digest)
        return meta

    def write_span(self, pieces: list[tuple[int, int, int, str]], data,
                   *, base: int | None = None, cost_ms: int = 0,
                   source: str = "") -> tuple[list[PieceMeta], list[int], str]:
        """Land a contiguous downloaded span in one pass.

        ``pieces``: ``(num, offset, size, digest)`` in ascending offset
        order; ``data[i]`` is content offset ``base + i`` (``base``
        defaults to the first piece's offset). Returns ``(landed_metas,
        corrupt_nums, path)``, ``path`` naming the traversal: ``native``
        (pwrite and crc32c fused in the native library) or ``python``
        (one pwrite and a Python hash). A digest-mismatched piece's bytes hit the file
        but are never recorded, so the region stays absent (never served,
        rewritten by the retry) and its groupmates land normally. Pieces
        already recorded (endgame duplicates) are not rewritten.
        """
        if base is None:
            base = pieces[0][1]
        mv = memoryview(data)
        with self._lock:
            fresh = [p for p in pieces if p[0] not in self.md.pieces]
        # contiguous runs: one covering the span unless a recorded
        # duplicate splits it
        runs: list[list[tuple[int, int, int, str]]] = []
        for p in fresh:
            if runs and runs[-1][-1][1] + runs[-1][-1][2] == p[1]:
                runs[-1].append(p)
            else:
                runs.append([p])
        metas: list[PieceMeta] = []
        corrupt: list[int] = []
        used_native = False
        try:
            for run in runs:
                lo = run[0][1] - base
                sizes = [p[2] for p in run]
                run_view = mv[lo:lo + sum(sizes)]
                digests = [digestlib.parse(p[3]) if p[3] else ("", "")
                           for p in run]
                crcs = self._write(run[0][1], run_view, sizes, fused=all(
                    a in ("", "crc32c") for a, _ in digests))
                pos = 0
                for i, (num, off, size, dg) in enumerate(run):
                    piece_view = run_view[pos:pos + size]
                    pos += size
                    if crcs is not None:
                        used_native = True
                        if dg and crcs[i] != digests[i][1]:
                            corrupt.append(num)
                            continue
                        dg = dg or f"crc32c:{crcs[i]}"
                    elif dg:
                        if not digestlib.verify(dg, piece_view):
                            corrupt.append(num)
                            continue
                    else:
                        dg = digestlib.for_bytes(
                            digestlib.preferred_piece_algo(), piece_view)
                    metas.append(PieceMeta(num=num, start=off, size=size,
                                           digest=dg, cost_ms=cost_ms,
                                           source=source))
                run_view.release()
        finally:
            mv.release()
        with self._lock:
            for meta in metas:
                self.md.pieces.setdefault(meta.num, meta)
            self.md.access_time = time.time()
        if self.castore is not None:
            for meta in metas:
                self.castore.add_piece(self.md.task_id, meta.num,
                                       meta.start, meta.size, meta.digest)
        return metas, corrupt, ("native" if used_native else "python")

    def adopt_from(self, src: "TaskStorage") -> None:
        """Adopt ``src``'s geometry and piece table, once this task's data
        file has become a hardlink of ``src``'s (same content)."""
        with self._lock:
            self.md.pieces = {
                num: PieceMeta(num=p.num, start=p.start, size=p.size,
                               digest=p.digest, source="cas")
                for num, p in src.md.pieces.items()}
            self.md.content_length = src.md.content_length
            self.md.total_piece_count = src.md.total_piece_count
            self.md.piece_size = src.md.piece_size
            # the memo is keyed on the piece count: a wholesale swap of
            # the table must not serve its stale spans
            self._cover_cache = None

    def mark_done(self, *, success: bool, content_length: int | None = None,
                  total_piece_count: int | None = None,
                  digest: str = "") -> None:
        with self._lock:
            if content_length is not None:
                self.md.content_length = content_length
            if total_piece_count is not None:
                self.md.total_piece_count = total_piece_count
            if digest:
                self.md.digest = digest
            self.md.done = True
            self.md.success = success
        self._save()
        if success and self.castore is not None:
            # content-identity dedupe: an identical completed task already
            # on disk absorbs this one's bytes through a hardlink
            self.castore.on_task_complete(self)

    def persist(self) -> None:
        """Save the metadata without marking the task done: a finished
        shard subset stays a warm partial that peers read piece by piece
        and a later request adopts, never whole content."""
        self._save()

    def _save(self) -> None:
        """Save a snapshot of the metadata. Its fsync waits behind the
        data file's write-back (seconds after a multi-GB pull), so it runs
        outside ``_lock``: the upload server's ``has_range`` takes that
        lock on the event loop, which would stall every serve meanwhile.
        The snapshot is taken inside ``_save_lock``, so saves reach the
        disk in the order of their snapshots: a later state is never
        overwritten by an earlier one."""
        with self._save_lock:
            with self._lock:
                snap = dataclasses.replace(self.md,
                                           pieces=dict(self.md.pieces))
            snap.save(self.dir)

    def read_piece(self, num: int) -> bytes:
        meta = self.md.pieces.get(num)
        if meta is None:
            raise DFError(Code.CLIENT_PIECE_NOT_FOUND,
                          f"piece {num} not in task {self.md.task_id[:12]}")
        try:
            with self._data_fd() as fd:
                data = _pread_all(fd, meta.size, meta.start)
        except OSError as exc:
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          f"piece {num} read failed: {exc}") from None
        if len(data) != meta.size:
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          f"short read piece {num}: {len(data)}/{meta.size}")
        self.md.access_time = time.time()
        return data

    def read_range(self, start: int, length: int) -> bytes:
        try:
            with self._data_fd() as fd:
                return _pread_all(fd, length, start)
        except OSError as exc:
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          f"range read @{start}+{length} failed: "
                          f"{exc}") from None

    def covered_prefix(self, start: int, end: int) -> int:
        """How far recorded (verified) pieces contiguously cover from
        ``start``, clipped to ``end``: the landed half of the relay plane's
        frontier (``daemon/relay.py``). Returns ``start`` when the byte at
        ``start`` is not stored.

        The streaming relay serve calls this per chunk and per progress
        wake, on the event loop, so the merged spans are cached and
        rebuilt only when a piece lands (the piece table only grows while
        a task is live, so its count is the cache key) and a call is one
        bisect."""
        if end <= start:
            return start
        with self._lock:
            key = len(self.md.pieces)
            cache = self._cover_cache
            if cache is None or cache[0] != key:
                merged: list[list[int]] = []
                for s, e in sorted((p.start, p.start + p.size)
                                   for p in self.md.pieces.values()):
                    if merged and s <= merged[-1][1]:
                        if e > merged[-1][1]:
                            merged[-1][1] = e
                    else:
                        merged.append([s, e])
                cache = (key, merged)
                self._cover_cache = cache
        spans = cache[1]
        i = bisect.bisect_right(spans, [start, 1 << 62]) - 1
        if i < 0 or spans[i][1] <= start:
            return start
        return min(spans[i][1], end)

    def has_range(self, start: int, length: int) -> bool:
        """True if stored pieces fully cover [start, start+length)."""
        end = start + length
        covered = start
        with self._lock:
            spans = sorted((p.start, p.start + p.size)
                           for p in self.md.pieces.values())
        for s, e in spans:
            if s > covered:
                return False
            if e > covered:
                covered = e
            if covered >= end:
                return True
        return covered >= end

    def piece_infos(self, start_num: int = 0,
                    limit: int = 0) -> list[PieceMeta]:
        with self._lock:
            nums = sorted(n for n in self.md.pieces if n >= start_num)
            if limit > 0:
                nums = nums[:limit]
            return [self.md.pieces[n] for n in nums]

    def content_hash(self, algo: str, length: int = -1) -> str:
        """Hash the data file's first ``length`` bytes (all of it with -1)
        in 4 MiB reads."""
        def chunks():
            remaining = length
            with open(self._data_path, "rb") as f:
                while remaining:
                    b = f.read(4 << 20 if remaining < 0
                               else min(4 << 20, remaining))
                    if not b:
                        return
                    if remaining > 0:
                        remaining -= len(b)
                    yield b
        return digestlib.hash_stream(algo, chunks())

    def verify_content(self) -> bool:
        """Re-hash the whole file against the recorded content digest
        (True when none is recorded)."""
        if not self.md.digest:
            return True
        algo, _ = digestlib.parse(self.md.digest)
        return f"{algo}:{self.content_hash(algo)}" == self.md.digest

    def store_to(self, output_path: str, *, range_start: int = 0,
                 range_length: int = -1) -> None:
        """Land the completed content (or its byte range) at
        ``output_path``: the whole file as a hardlink when possible (same
        filesystem), else a copy; a range is copied."""
        os.makedirs(os.path.dirname(os.path.abspath(output_path)) or ".",
                    exist_ok=True)
        if range_start == 0 and (range_length < 0 or range_length
                                 == self.md.content_length):
            try:
                if os.path.exists(output_path):
                    os.unlink(output_path)
                os.link(self._data_path, output_path)
            except OSError:
                shutil.copyfile(self._data_path, output_path)
            return
        length = (range_length if range_length >= 0
                  else self.md.content_length - range_start)
        with open(self._data_path, "rb") as src, \
                open(output_path, "wb") as dst:
            src.seek(range_start)
            while length > 0:
                b = src.read(min(4 << 20, length))
                if not b:
                    break
                dst.write(b)
                length -= len(b)

    def data_path(self) -> str:
        return self._data_path

    def disk_usage(self) -> int:
        """Logical bytes: hardlink-shared content counts once per task
        here; ``StorageManager.usage`` dedupes by inode."""
        try:
            return os.path.getsize(self._data_path)
        except OSError:
            return 0

    def inode(self) -> tuple[int, int] | None:
        """(st_dev, st_ino) of the data file, or None when it is gone."""
        try:
            st = os.stat(self._data_path)
            return st.st_dev, st.st_ino
        except OSError:
            return None

    def nlink(self) -> int:
        try:
            return os.stat(self._data_path).st_nlink
        except OSError:
            return 0

    def destroy(self) -> None:
        self.close()
        shutil.rmtree(self.dir, ignore_errors=True)


class SubTaskStorage:
    """A ranged sub-task over a parent TaskStorage: piece offsets are
    relative to the range, and the bytes live in the parent's file at
    ``range_start + offset``. Completing the range completes neither the
    parent nor its piece table; the sub-task keeps its own metadata, in
    memory only (a reload finds the parent alone)."""

    def __init__(self, parent: TaskStorage, metadata: TaskMetadata):
        if metadata.range_length < 0:
            raise ValueError("subtask needs range_length")
        self.parent = parent
        self.md = metadata
        self._lock = threading.Lock()

    def write_piece(self, num: int, offset: int, data: bytes | memoryview,
                    piece_digest: str = "", *, cost_ms: int = 0,
                    source: str = "", pre_verified: bool = False) -> PieceMeta:
        if offset + len(data) > self.md.range_length:
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          f"piece {num} spills past sub-range: "
                          f"{offset}+{len(data)} > {self.md.range_length}")
        if piece_digest and not pre_verified \
                and not digestlib.verify(piece_digest, data):
            raise DFError(Code.CLIENT_DIGEST_MISMATCH,
                          f"piece {num} digest mismatch")
        if not piece_digest:
            piece_digest = digestlib.for_bytes(
                digestlib.preferred_piece_algo(), data)
        with self._lock:
            existing = self.md.pieces.get(num)
            if existing is not None:
                return existing
        self.parent._write(self.md.range_start + offset, data, [len(data)],
                           fused=False)
        meta = PieceMeta(num=num, start=offset, size=len(data),
                         digest=piece_digest, cost_ms=cost_ms, source=source)
        with self._lock:
            self.md.pieces[num] = meta
            self.md.access_time = time.time()
        self.parent.md.access_time = time.time()
        return meta

    def read_piece(self, num: int) -> bytes:
        meta = self.md.pieces.get(num)
        if meta is None:
            raise DFError(Code.CLIENT_PIECE_NOT_FOUND, f"piece {num} missing")
        return self.parent.read_range(self.md.range_start + meta.start,
                                      meta.size)

    def piece_infos(self, start_num: int = 0,
                    limit: int = 0) -> list[PieceMeta]:
        with self._lock:
            nums = sorted(n for n in self.md.pieces if n >= start_num)
            if limit > 0:
                nums = nums[:limit]
            return [self.md.pieces[n] for n in nums]

    def mark_done(self, *, success: bool) -> None:
        with self._lock:
            self.md.done = True
            self.md.success = success

    def store_to(self, output_path: str) -> None:
        self.parent.store_to(output_path, range_start=self.md.range_start,
                             range_length=self.md.range_length)
