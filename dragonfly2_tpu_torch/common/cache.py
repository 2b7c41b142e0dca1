"""In-memory TTL cache.

Counterpart of ``dragonfly2_tpu/common/cache.py`` (reference ``pkg/cache``,
go-cache style), copied: a key lives ``ttl`` seconds (0 = never expires)
on the monotonic clock.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Hashable


class TTLCache:
    NO_EXPIRE = 0.0

    def __init__(self, default_ttl: float = 60.0):
        self._default_ttl = default_ttl
        self._lock = threading.Lock()
        self._data: dict[Hashable, tuple[Any, float]] = {}  # key -> (value, expiry; 0 = never)

    def set(self, key: Hashable, value: Any, ttl: float | None = None) -> None:
        ttl = self._default_ttl if ttl is None else ttl
        expiry = time.monotonic() + ttl if ttl > 0 else 0.0
        with self._lock:
            self._data[key] = (value, expiry)

    def get(self, key: Hashable, default: Any = None) -> Any:
        now = time.monotonic()
        with self._lock:
            item = self._data.get(key)
            if item is None:
                return default
            value, expiry = item
            if expiry and expiry < now:
                del self._data[key]
                return default
            return value

    def delete(self, key: Hashable) -> None:
        with self._lock:
            self._data.pop(key, None)

    def purge_expired(self) -> int:
        now = time.monotonic()
        with self._lock:
            dead = [k for k, (_, e) in self._data.items() if e and e < now]
            for k in dead:
                del self._data[k]
            return len(dead)

    def __len__(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(1 for _, e in self._data.values() if not e or e >= now)
