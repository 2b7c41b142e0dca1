"""Daemon announcer: periodic host heartbeat and recovery content replay.

Counterpart of ``dragonfly2_tpu/daemon/announcer.py`` (reference
``client/daemon/announcer/announcer.go``): host stats (CPU and memory from
``/proc``, disk from ``shutil``) go to the scheduler's ``AnnounceHost``
every ``announce_interval_s``, so its free-slot and load scores track the
host. Every answer carries the scheduler's boot epoch; when the
connector sees it change, or a register failed over around the ring, the
loop wakes at once and replays what this daemon holds
(``AnnounceContent``: the PEX digest's entry shape plus ``url``, sealed
with the PEX envelope), so a restarted scheduler relearns who holds what
within one interval. The first pass of the loop replays too, so a
daemon restarted over its storage tells the scheduler what it still
holds. Both announces carry the daemon's pulse (``daemon/pulse.py``), a
digest of its health counters with a sequence number that rises by one
per announce, which the scheduler's fleet pulse ingests.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil

from ..idl.messages import (AnnounceContentRequest, AnnounceHostRequest,
                            CPUStat, DiskStat, Host, MemoryStat)
from .pex import DIGEST_VERSION, seal
from .pulse import build_pulse

log = logging.getLogger("df.flow.announcer")


def _memory() -> MemoryStat:
    total = available = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    available = int(line.split()[1]) * 1024
    except OSError:
        pass
    used_pct = 100.0 * (1 - available / total) if total else 0.0
    return MemoryStat(total=total, available=available, used_percent=used_pct)


def _cpu() -> CPUStat:
    n = os.cpu_count() or 1
    try:
        load1 = os.getloadavg()[0]
    except OSError:
        load1 = 0.0
    return CPUStat(logical_count=n, percent=min(100.0, 100.0 * load1 / n))


def _disk(path: str) -> DiskStat:
    try:
        du = shutil.disk_usage(path)
        return DiskStat(total=du.total, free=du.free,
                        used_percent=100.0 * du.used / du.total)
    except OSError:
        return DiskStat()


class Announcer:
    def __init__(self, daemon):
        self.daemon = daemon
        self.interval_s = daemon.cfg.announce_interval_s
        self._task: asyncio.Task | None = None
        # pulse sequence: lets the scheduler order digests and spot a
        # restart (seq reset) independently of wall clocks
        self._pulse_seq = 0

    def _pulse(self):
        """Build this announce's pulse digest; a pulse failure must never
        cost the heartbeat it rides on."""
        self._pulse_seq += 1
        try:
            return build_pulse(self.daemon, self._pulse_seq)
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            return None

    def host_with_stats(self) -> Host:
        host = self.daemon.host_info()
        host.cpu = _cpu()
        host.memory = _memory()
        host.disk = _disk(self.daemon.paths.data_dir)
        return host

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    def _held_content(self) -> list[dict]:
        """PEX digest entry shape + ``url`` (the scheduler needs it to
        re-create the task record). The reference advertises nothing from
        a self-quarantined daemon; the port has no verdict plane yet
        (Queue 1 item 5)."""
        entries = []
        for ts in self.daemon.storage_mgr.tasks():
            md = ts.md
            if not md.pieces and not (md.done and md.success):
                continue
            done = bool(md.done and md.success)
            entry = {"task_id": md.task_id, "url": md.url,
                     "total": md.total_piece_count,
                     "content_length": md.content_length,
                     "piece_size": md.piece_size, "done": done}
            if not done:
                entry["pieces"] = sorted(md.pieces)
            entries.append(entry)
        return entries

    async def _announce_content(self) -> None:
        entries = self._held_content()
        if not entries:
            return
        resp = await self.daemon.scheduler.announce_content(
            AnnounceContentRequest(
                host=self.host_with_stats(), pulse=self._pulse(),
                digest=seal({"v": DIGEST_VERSION, "tasks": entries})))
        log.info("re-announced %d held tasks (%d adopted)", len(entries),
                 getattr(resp, "tasks_adopted", 0))

    async def _loop(self) -> None:
        # initial replay: a daemon restarting over persisted storage
        # tells the brain what it still holds (the reverse direction of
        # scheduler recovery — same RPC, same codec)
        reconcile = True
        while True:
            try:
                await self.daemon.scheduler.announce_host(AnnounceHostRequest(
                    host=self.host_with_stats(), interval_s=self.interval_s,
                    pulse=self._pulse()))
                # announce_host fed the epoch watermark; a change (or a
                # register ring failover) left reconcile_event set
                event = getattr(self.daemon.scheduler, "reconcile_event",
                                None)
                if reconcile or (event is not None and event.is_set()):
                    if event is not None:
                        event.clear()
                    await self._announce_content()
                reconcile = False
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - scheduler may be away
                log.debug("announce failed: %s", exc)
            event = getattr(self.daemon.scheduler, "reconcile_event", None)
            if event is None:
                await asyncio.sleep(self.interval_s)
                continue
            # sleep the interval, but wake EARLY when the connector flags
            # a reconcile (epoch change / ring failover): the recovered
            # brain's first rulings are exactly when amnesia costs origin
            try:
                await asyncio.wait_for(event.wait(), self.interval_s)
            except asyncio.TimeoutError:
                pass

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
