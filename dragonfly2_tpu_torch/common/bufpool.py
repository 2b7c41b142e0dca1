"""Piece-buffer pool: recycles the 4-16 MiB download buffers.

Counterpart of ``dragonfly2_tpu/common/bufpool.py``. ``acquire(size)``
returns a bytearray of exactly ``size`` bytes, possibly dirty (the
downloader fills every byte it hands on). ``release(buf)`` parks it for
reuse once storage and the device sink's staging copy are done with it; a
buffer still exported to a ``memoryview`` is dropped instead, so a stale
view can never observe another download's bytes. Bounded by parked bytes
and per-size depth; thread-safe.
"""

from __future__ import annotations

import threading

from .metrics import REGISTRY

_acquires = REGISTRY.counter(
    "df_bufpool_acquires_total", "piece-buffer pool acquires", ("result",))
_discards = REGISTRY.counter(
    "df_bufpool_discards_total",
    "piece buffers dropped at release instead of pooled", ("reason",))


class BufferPool:
    def __init__(self, *, max_bytes: int = 256 << 20,
                 max_per_size: int = 16):
        self.max_bytes = max_bytes
        self.max_per_size = max_per_size
        self._lock = threading.Lock()
        self._free: dict[int, list[bytearray]] = {}
        self._bytes = 0

    def acquire(self, size: int) -> bytearray:
        """A buffer of exactly ``size`` bytes; contents undefined."""
        if size <= 0:
            return bytearray(0)
        with self._lock:
            bucket = self._free.get(size)
            if bucket:
                self._bytes -= size
                _acquires.labels("hit").inc()
                return bucket.pop()
        _acquires.labels("miss").inc()
        return bytearray(size)

    def release(self, buf) -> None:
        """Park ``buf`` for reuse; anything not recyclable is dropped."""
        if not isinstance(buf, bytearray) or len(buf) == 0:
            return
        try:
            # resizing raises BufferError iff a memoryview still exports it
            buf.append(0)
            buf.pop()
        except BufferError:
            _discards.labels("exported").inc()
            return
        size = len(buf)
        with self._lock:
            bucket = self._free.setdefault(size, [])
            if (self._bytes + size > self.max_bytes
                    or len(bucket) >= self.max_per_size):
                _discards.labels("full").inc()
                return
            bucket.append(buf)
            self._bytes += size


# process-wide pool, shared by every downloader the way REGISTRY is shared
POOL = BufferPool()
