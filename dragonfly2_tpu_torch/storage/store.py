"""TaskStorage: the piece-addressed store for one task.

Counterpart of ``dragonfly2_tpu/storage/store.py`` ``TaskStorage`` without
the native library, the content-addressed store and ranged sub-tasks.
Pieces are written at their offsets with per-piece digest verification;
reads feed the device sink and the final output. Each call opens the data
file for itself, so a task destroyed mid-IO fails the call cleanly instead
of writing into a reused descriptor.
"""

from __future__ import annotations

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

    def mark_done(self, *, success: bool, content_length: int | None = None,
                  total_piece_count: int | None = None) -> None:
        with self._lock:
            if content_length is not None:
                self.md.content_length = content_length
            if total_piece_count is not None:
                self.md.total_piece_count = total_piece_count
            self.md.done = True
            self.md.success = success
            self.md.save(self.dir)

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

    def piece_infos(self) -> list[PieceMeta]:
        with self._lock:
            return [self.md.pieces[n] for n in sorted(self.md.pieces)]

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
