"""Dedicated bounded executor for storage IO and the hashing that rides it.

Counterpart of ``dragonfly2_tpu/storage/io_executor.py``: piece writes and
their verify hashes run on a small pool of their own, never on the event
loop and never queued behind unrelated work in the loop's default executor.
The pool is a plain ``concurrent.futures`` pool wrapped per call with
``run_in_executor``, so sequential ``asyncio.run`` loops share it safely.
"""

from __future__ import annotations

import asyncio
import functools
import threading
from concurrent.futures import ThreadPoolExecutor

from ..common.metrics import REGISTRY

# Small on purpose: storage on one host is one disk (or tmpfs); more
# threads than ~4 only shuffle the same bandwidth while adding GIL churn.
MAX_WORKERS = 4

_depth = REGISTRY.gauge(
    "df_storage_io_queue_depth",
    "storage-executor jobs submitted and not yet finished")

_executor: ThreadPoolExecutor | None = None
_lock = threading.Lock()


def executor() -> ThreadPoolExecutor:
    global _executor
    if _executor is None:
        with _lock:
            if _executor is None:
                _executor = ThreadPoolExecutor(
                    max_workers=MAX_WORKERS,
                    thread_name_prefix="df-storage")
    return _executor


async def run_io(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` on the storage pool; awaitable."""
    loop = asyncio.get_running_loop()
    _depth.inc()
    try:
        return await loop.run_in_executor(
            executor(), functools.partial(fn, *args, **kwargs))
    finally:
        _depth.dec()
