"""Interval-driven GC runner: named tasks swept on their own periods.

Counterpart of ``dragonfly2_tpu/common/gc.py`` (reference ``pkg/gc``
``gc.go:28-130``); the manager's keepalive sweep runs on it.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Awaitable, Callable

from .metrics import REGISTRY

log = logging.getLogger("df.gc")

_gc_last_run = REGISTRY.gauge(
    "df_gc_last_run_timestamp_seconds",
    "unix time a GC task last completed a sweep", ("task",))
_gc_duration = REGISTRY.histogram(
    "df_gc_run_duration_seconds", "wall time of each GC sweep", ("task",))
_gc_reclaimed = REGISTRY.counter(
    "df_gc_reclaimed_total", "items reclaimed by GC sweeps", ("task",))
_gc_runs = REGISTRY.counter(
    "df_gc_runs_total", "GC sweeps by outcome", ("task", "result"))


@dataclass
class GCTask:
    id: str
    interval: float
    run: Callable[[], Awaitable[int] | int]  # returns number reclaimed


class GC:
    def __init__(self) -> None:
        self._tasks: dict[str, GCTask] = {}
        self._runners: list[asyncio.Task] = []
        self._stopped = asyncio.Event()

    def add(self, task: GCTask) -> None:
        if task.id in self._tasks:
            raise ValueError(f"gc task exists: {task.id}")
        self._tasks[task.id] = task

    async def run_one(self, task_id: str) -> int:
        task = self._tasks[task_id]
        t0 = time.monotonic()
        try:
            out = task.run()
            if asyncio.iscoroutine(out):
                out = await out
        except asyncio.CancelledError:
            raise            # shutdown caught a sweep mid-flight: no error
        except Exception:
            _gc_runs.labels(task_id, "error").inc()
            raise
        n = int(out or 0)
        # a sweep that found nothing still proves the runner is alive
        _gc_last_run.labels(task_id).set(time.time())
        _gc_duration.labels(task_id).observe(time.monotonic() - t0)
        _gc_runs.labels(task_id, "ok").inc()
        if n:
            _gc_reclaimed.labels(task_id).inc(n)
        return n

    async def _loop(self, task: GCTask) -> None:
        while not self._stopped.is_set():
            try:
                await asyncio.wait_for(self._stopped.wait(),
                                       timeout=task.interval)
                return
            except asyncio.TimeoutError:
                pass
            try:
                n = await self.run_one(task.id)
                if n:
                    log.debug("gc %s reclaimed %d", task.id, n)
            except Exception:
                log.exception("gc task %s failed", task.id)

    def start(self) -> None:
        self._stopped.clear()
        for task in self._tasks.values():
            self._runners.append(
                asyncio.get_running_loop().create_task(self._loop(task)))

    async def stop(self) -> None:
        self._stopped.set()
        for r in self._runners:
            r.cancel()
        await asyncio.gather(*self._runners, return_exceptions=True)
        self._runners.clear()
