"""Traffic shaper: split the daemon's total download budget across tasks.

Counterpart of ``dragonfly2_tpu/daemon/traffic_shaper.py`` (reference
``client/daemon/peer/traffic_shaper.go``): kinds ``plain`` (an equal
split) and ``sampling`` (shares in proportion to each task's consumption
since the last retune, re-sampled every ``SAMPLE_INTERVAL_S``). Each task
gets its own ``TokenBucket`` whose rate the shaper retunes; the piece
engine acquires from it before each P2P transfer and the back-source
path before each origin read (``PieceManager._limiter``).

The split is hierarchical: the total is first divided across the QoS
classes by ``CLASS_WEIGHTS`` over the classes with live demand
(``common/rate.class_shares``), then within each class across its tasks
by the plain or sampling rule. A ``bulk`` herd alone gets the whole pipe
and keeps about a ninth of it once a ``critical`` task registers, however
many tasks it floods in.
"""

from __future__ import annotations

import asyncio
import logging

from ..common.metrics import REGISTRY
from ..common.rate import TokenBucket, class_shares
from ..idl.messages import DEFAULT_PRIORITY_CLASS, PRIORITY_CLASSES

log = logging.getLogger("df.flow.shaper")

SAMPLE_INTERVAL_S = 1.0
MIN_SHARE_RATIO = 0.05     # no running task starves below 5% of its class

# class weights for the hierarchical split: under full contention
# ``critical`` holds 8/11 of the pipe and ``bulk`` 1/11, the ratio
# dfbench's contended ``--pr11`` scenario measures
CLASS_WEIGHTS = {"critical": 8.0, "standard": 3.0, "bulk": 1.0}

_shaper_rate = REGISTRY.gauge(
    "df_shaper_rate_bps", "total download budget the shaper splits "
    "(0 = unlimited, shaper idle)")
_shaper_tasks = REGISTRY.gauge(
    "df_shaper_tasks", "tasks currently registered with the shaper")
_shaper_bytes = REGISTRY.counter(
    "df_shaper_throttled_bytes_total",
    "bytes recorded through shaper-governed tasks")
_shaper_retunes = REGISTRY.counter(
    "df_shaper_retunes_total", "per-task rate redistributions applied")
_qos_class_rate = REGISTRY.gauge(
    "df_qos_class_rate_bps",
    "download budget currently granted to each QoS class by the "
    "hierarchical shaper split (0 while the class is idle or the shaper "
    "is unlimited)", ("cls",))


class _TaskEntry:
    __slots__ = ("bucket", "consumed", "last_consumed", "rate", "cls",
                 "tenant")

    def __init__(self, cls: str = DEFAULT_PRIORITY_CLASS,
                 tenant: str = "") -> None:
        self.bucket = TokenBucket(0)     # unlimited until first retune
        self.consumed = 0
        self.last_consumed = 0
        self.rate = 0.0
        self.cls = cls
        self.tenant = tenant


class TrafficShaper:
    def __init__(self, *, total_rate_bps: float = 0.0,
                 kind: str = "sampling"):
        self.total_rate_bps = float(total_rate_bps)
        self.kind = kind
        self._tasks: dict[str, _TaskEntry] = {}
        self._loop_task: asyncio.Task | None = None

    def start(self) -> None:
        if self.total_rate_bps > 0 and self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(
                self._retune_loop())

    async def stop(self) -> None:
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass

    # ------------------------------------------------------------------

    def register(self, task_id: str, *,
                 qos_class: str = DEFAULT_PRIORITY_CLASS,
                 tenant: str = "") -> TokenBucket:
        entry = self._tasks.get(task_id)
        if entry is None:
            entry = _TaskEntry(
                qos_class if qos_class in PRIORITY_CLASSES
                else DEFAULT_PRIORITY_CLASS, tenant)
            self._tasks[task_id] = entry
            _shaper_tasks.set(len(self._tasks))
            self._retune()
        return entry.bucket

    def unregister(self, task_id: str) -> None:
        if self._tasks.pop(task_id, None) is not None:
            _shaper_tasks.set(len(self._tasks))
            self._retune()

    def record(self, task_id: str, nbytes: int) -> None:
        entry = self._tasks.get(task_id)
        if entry is not None:
            entry.consumed += nbytes
            if self.total_rate_bps > 0:
                # only governed traffic counts as throttled: with no
                # budget the shaper is a pass-through
                _shaper_bytes.inc(nbytes)

    def class_snapshot(self) -> dict:
        """Per-class registrations, consumption and rates for ``GET
        /debug/qos`` and ``dfdiag --qos`` (observation only)."""
        out: dict[str, dict] = {
            c: {"tasks": 0, "rate_bps": 0.0, "consumed_bytes": 0,
                "tenants": {}} for c in PRIORITY_CLASSES}
        for entry in self._tasks.values():
            row = out[entry.cls]
            row["tasks"] += 1
            row["rate_bps"] += entry.rate
            row["consumed_bytes"] += entry.consumed
            if entry.tenant:
                t = row["tenants"].setdefault(
                    entry.tenant, {"tasks": 0, "consumed_bytes": 0})
                t["tasks"] += 1
                t["consumed_bytes"] += entry.consumed
        return out

    # ------------------------------------------------------------------

    async def _retune_loop(self) -> None:
        while True:
            await asyncio.sleep(SAMPLE_INTERVAL_S)
            self._retune()

    def _retune(self) -> None:
        _shaper_rate.set(self.total_rate_bps)
        if self.total_rate_bps <= 0 or not self._tasks:
            return
        _shaper_retunes.inc()
        # level 1: class shares over live demand. Demand is the bytes
        # consumed since the last retune, floored at 1 for any class with
        # a registered task: a task that has consumed nothing yet must
        # not be scored idle, or it starts at the trickle rate
        deltas: dict[str, int] = {}
        class_demand: dict[str, float] = {}
        for tid, entry in self._tasks.items():
            d = max(0, entry.consumed - entry.last_consumed)
            entry.last_consumed = entry.consumed
            deltas[tid] = d
            class_demand[entry.cls] = class_demand.get(entry.cls, 0.0) \
                + max(d, 1)
        shares = class_shares(self.total_rate_bps, CLASS_WEIGHTS,
                              class_demand)
        for cls in PRIORITY_CLASSES:
            _qos_class_rate.labels(cls).set(shares.get(cls, 0.0))
        # level 2: the plain or sampling rule, within each class
        for cls, budget in shares.items():
            members = {tid: e for tid, e in self._tasks.items()
                       if e.cls == cls}
            if not members or budget <= 0:
                continue
            n = len(members)
            if self.kind == "plain":
                share = budget / n
                for entry in members.values():
                    entry.rate = share
                    entry.bucket.set_rate(share)
                continue
            total_delta = sum(deltas[tid] for tid in members)
            floor = budget * MIN_SHARE_RATIO
            distributable = budget - floor * n
            if distributable <= 0 or total_delta == 0:
                share = budget / n
                for entry in members.values():
                    entry.rate = share
                    entry.bucket.set_rate(share)
                continue
            for tid, entry in members.items():
                entry.rate = floor + distributable * deltas[tid] / total_delta
                entry.bucket.set_rate(entry.rate)
