"""Dynamic config: a cached remote-config fetcher with a disk-snapshot
fallback and observer notification.

Counterpart of ``dragonfly2_tpu/common/dynconfig.py`` (reference
``internal/dynconfig``, ``dynconfig.go:45-136``, and the per-service
wrappers ``client/config/dynconfig_manager.go`` and
``scheduler/config/dynconfig.go``). ``fetch`` is an async callable that
returns the config as a dict (for example a cluster's config and its
schedulers from the manager's ``GetSchedulers``). ``refresh`` keeps the
data it holds when a fetch fails, and falls back to the snapshot on disk
only when it holds none; new data is written to the snapshot atomically
(a temporary file, then a rename) and handed to every observer, in
registration order. ``register`` calls a new observer at once when data is
held. ``serve`` refreshes every ``refresh_interval`` seconds until
``stop``. As in the reference, no service of the port constructs one.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Any, Awaitable, Callable

log = logging.getLogger("df.core.dynconfig")

Fetcher = Callable[[], Awaitable[dict[str, Any]]]
Observer = Callable[[dict[str, Any]], None]


class Dynconfig:
    def __init__(self, fetch: Fetcher, *, refresh_interval: float = 30.0,
                 snapshot_path: str | None = None):
        self._fetch = fetch
        self._interval = refresh_interval
        self._snapshot_path = snapshot_path
        self._data: dict[str, Any] | None = None
        self._observers: list[Observer] = []
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()

    def register(self, observer: Observer) -> None:
        self._observers.append(observer)
        if self._data is not None:
            observer(self._data)

    async def get(self) -> dict[str, Any]:
        if self._data is None:
            await self.refresh()
        if self._data is None:
            raise RuntimeError("dynconfig: no data and no snapshot")
        return self._data

    async def refresh(self) -> None:
        try:
            data = await self._fetch()
        except Exception as exc:
            if self._data is None:
                loaded = self._load_snapshot()
                if loaded is not None:
                    log.warning("dynconfig fetch failed (%s); using disk "
                                "snapshot", exc)
                    self._set(loaded, persist=False)
                    return
            log.warning("dynconfig fetch failed: %s (keeping cached data)",
                        exc)
            return
        if data != self._data:
            self._set(data, persist=True)

    def _set(self, data: dict[str, Any], persist: bool) -> None:
        self._data = data
        if persist and self._snapshot_path:
            try:
                tmp = self._snapshot_path + ".tmp"
                # dflint: disable=DF001 — KB-scale config snapshot on the minutes-cadence refresh tick
                with open(tmp, "w") as f:
                    json.dump(data, f)
                # dflint: disable=DF001 — atomic rename, metadata syscall
                os.replace(tmp, self._snapshot_path)
            except OSError as exc:  # the snapshot is best-effort
                log.warning("dynconfig snapshot write failed: %s", exc)
        for ob in self._observers:
            try:
                ob(data)
            except Exception:
                log.exception("dynconfig observer failed")

    def _load_snapshot(self) -> dict[str, Any] | None:
        # dflint: disable=DF001 — one stat on the manager-unreachable fallback path
        if not self._snapshot_path or not os.path.exists(self._snapshot_path):
            return None
        try:
            # dflint: disable=DF001 — KB-scale config snapshot, read only when the manager is away
            with open(self._snapshot_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    async def serve(self) -> None:
        self._stopped.clear()
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                await asyncio.wait_for(self._stopped.wait(),
                                       timeout=self._interval)
                return
            except asyncio.TimeoutError:
                await self.refresh()

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
