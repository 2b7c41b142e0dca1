"""TaskStorage: the piece-addressed store for one task.

Counterpart of ``dragonfly2_tpu/storage/store.py`` ``TaskStorage`` without
the native library, the content-addressed store and ranged sub-tasks.
Pieces are written at their offsets with per-piece digest verification,
one at a time (``write_piece``) or as a downloaded span in one pass
(``write_span``); reads feed the device sink, the upload server and the
final output. Each call opens the data
file for itself, so a task destroyed mid-IO fails the call cleanly instead
of writing into a reused descriptor.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time

from ..common import digest as digestlib
from ..common.errors import Code, DFError
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

    def __init__(self, task_dir: str, metadata: TaskMetadata):
        self.dir = task_dir
        self.md = metadata
        self._lock = threading.Lock()
        self._save_lock = threading.Lock()     # one metadata save at a time
        self._data_path = os.path.join(task_dir, DATA_FILE)
        os.makedirs(task_dir, exist_ok=True)
        if not os.path.exists(self._data_path):
            with open(self._data_path, "wb"):
                pass

    def write_piece(self, num: int, offset: int, data: bytes | memoryview,
                    piece_digest: str = "", *, cost_ms: int = 0,
                    source: str = "", pre_verified: bool = False) -> PieceMeta:
        """Verify + persist one piece. Idempotent per piece number.
        ``pre_verified`` skips the re-hash when the transport already
        checked the bytes against ``piece_digest``."""
        with self._lock:
            existing = self.md.pieces.get(num)
            if existing is not None:
                return existing
        if piece_digest:
            if not pre_verified and not digestlib.verify(piece_digest, data):
                raise DFError(Code.CLIENT_DIGEST_MISMATCH,
                              f"piece {num} digest mismatch")
        else:
            piece_digest = digestlib.for_bytes(digestlib.PIECE_ALGO, data)
        try:
            fd = os.open(self._data_path, os.O_WRONLY)
            try:
                _pwrite_all(fd, data, offset)
            finally:
                os.close(fd)
        except OSError as exc:
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          f"piece {num} write failed: {exc}") from None
        meta = PieceMeta(num=num, start=offset, size=len(data),
                         digest=piece_digest, cost_ms=cost_ms, source=source)
        with self._lock:
            self.md.pieces[num] = meta
            self.md.access_time = time.time()
        return meta

    def write_span(self, pieces: list[tuple[int, int, int, str]], data,
                   *, base: int | None = None, cost_ms: int = 0,
                   source: str = "") -> tuple[list[PieceMeta], list[int]]:
        """Land a contiguous downloaded span in one pass.

        ``pieces``: ``(num, offset, size, digest)`` in ascending offset
        order; ``data[i]`` is content offset ``base + i`` (``base``
        defaults to the first piece's offset). Returns ``(landed_metas,
        corrupt_nums)``. A digest-mismatched piece's bytes hit the file
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
        try:
            for run in runs:
                lo = run[0][1] - base
                run_view = mv[lo:lo + sum(p[2] for p in run)]
                try:
                    fd = os.open(self._data_path, os.O_WRONLY)
                    try:
                        _pwrite_all(fd, run_view, run[0][1])
                    finally:
                        os.close(fd)
                except OSError as exc:
                    raise DFError(Code.CLIENT_STORAGE_ERROR,
                                  f"span write @{run[0][1]} failed: "
                                  f"{exc}") from None
                pos = 0
                for num, off, size, dg in run:
                    piece_view = run_view[pos:pos + size]
                    pos += size
                    if dg:
                        if not digestlib.verify(dg, piece_view):
                            corrupt.append(num)
                            continue
                    else:
                        dg = digestlib.for_bytes(digestlib.PIECE_ALGO,
                                                 piece_view)
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
        return metas, corrupt

    def mark_done(self, *, success: bool, content_length: int | None = None,
                  total_piece_count: int | None = None) -> None:
        with self._lock:
            if content_length is not None:
                self.md.content_length = content_length
            if total_piece_count is not None:
                self.md.total_piece_count = total_piece_count
            self.md.done = True
            self.md.success = success
        self._save()

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
            fd = os.open(self._data_path, os.O_RDONLY)
            try:
                data = _pread_all(fd, meta.size, meta.start)
            finally:
                os.close(fd)
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
            fd = os.open(self._data_path, os.O_RDONLY)
            try:
                return _pread_all(fd, length, start)
            finally:
                os.close(fd)
        except OSError as exc:
            raise DFError(Code.CLIENT_STORAGE_ERROR,
                          f"range read @{start}+{length} failed: "
                          f"{exc}") from None

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

    def store_to(self, output_path: str) -> None:
        """Land the completed content at ``output_path``: hardlink when
        possible (same filesystem), else copy."""
        os.makedirs(os.path.dirname(os.path.abspath(output_path)) or ".",
                    exist_ok=True)
        try:
            if os.path.exists(output_path):
                os.unlink(output_path)
            os.link(self._data_path, output_path)
        except OSError:
            shutil.copyfile(self._data_path, output_path)

    def data_path(self) -> str:
        return self._data_path

    def destroy(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
