"""Multi-tenant QoS governor: class-aware admission with explicit brownout.

Counterpart of ``dragonfly2_tpu/daemon/qos.py``. Every new download task
asks the governor for admission with its (tenant, class).
``critical``/``standard`` work is always admitted and counted; ``bulk``
work walks the degradation ladder:

  ``normal``   bulk admitted freely up to ``bulk_active_limit``;
  ``brownout`` foreground pressure (active critical tasks) or a full bulk
               gate: new bulk admissions queue, with a bounded wait, for
               a slot;
  ``shed``     the wait expired or the queue is full: the request is
               refused now with RESOURCE_EXHAUSTED and ``retry_after_ms``,
               which the ``common/retry.py`` ladder honours.

Each ruling is a ``qos`` event on the task's flight and a count in the
``df_qos_*`` metrics; ``GET /debug/qos`` (``add_qos_routes``) and
``dfdiag --qos`` read the whole plane. The shed path cannot deadlock:
admission of a non-bulk class takes no lock and no await, the bulk queue
is bounded, every waiter carries its own deadline, and ``release`` wakes
the next live waiter (cancelled futures are skipped, as in the upload
server's slot queue).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass

from ..common.errors import Code, DFError
from ..common.metrics import REGISTRY
from ..idl.messages import DEFAULT_PRIORITY_CLASS, PRIORITY_CLASSES

log = logging.getLogger("df.flow.qos")

STATES = ("normal", "brownout", "shed")

_qos_state = REGISTRY.gauge(
    "df_qos_state", "current QoS degradation state "
    "(0=normal, 1=brownout, 2=shed)")
_qos_transitions = REGISTRY.counter(
    "df_qos_transitions_total",
    "QoS degradation-state transitions entered", ("state",))
_qos_admitted = REGISTRY.counter(
    "df_qos_admitted_total", "download tasks admitted, by class", ("cls",))
_qos_queued = REGISTRY.counter(
    "df_qos_queued_total",
    "bulk admissions parked at the brownout queue", ("cls",))
_qos_shed = REGISTRY.counter(
    "df_qos_shed_total",
    "admissions rejected with RESOURCE_EXHAUSTED + retry-after",
    ("cls", "reason"))
_qos_active = REGISTRY.gauge(
    "df_qos_active_tasks", "running downloads currently counted by the "
    "QoS governor, by class", ("cls",))


@dataclass
class QosSection:
    """Daemon QoS knobs (``DaemonConfig.qos``). With the defaults a
    classless fleet behaves as without QoS: everything registers as
    ``standard``, which is never queued or shed."""

    enabled: bool = True
    # concurrent bulk downloads admitted before the gate closes
    # (0 = unlimited: brownout still queues on foreground pressure)
    bulk_active_limit: int = 8
    # active critical tasks at which new bulk work browns out even with
    # bulk slots free (foreground pressure signal)
    brownout_critical_threshold: int = 1
    # bounded brownout-queue wait before a bulk admission sheds
    queue_wait_s: float = 5.0
    # queued bulk admissions held at once; beyond this, shed immediately
    queue_limit: int = 64
    # retry-after hint stamped on sheds (the 429 contract)
    shed_retry_after_ms: int = 2000


class QosGovernor:
    """Per-daemon admission governor: one per daemon, consulted by
    ``PeerTaskManager`` before it creates a task's conductor."""

    def __init__(self, cfg: QosSection | None = None, *, shaper=None):
        self.cfg = cfg or QosSection()
        self.shaper = shaper              # class_snapshot() for /debug/qos
        self.active: dict[str, int] = {c: 0 for c in PRIORITY_CLASSES}
        self.state = "normal"
        self._waiters: deque = deque()    # (future, enqueued_at)
        self.counters = {
            "admitted": {c: 0 for c in PRIORITY_CLASSES},
            "queued": 0,
            "shed": {c: 0 for c in PRIORITY_CLASSES},
        }
        self.tenant_counters: dict[str, dict] = {}
        self._state_since = time.monotonic()

    # ------------------------------------------------------------------

    def _set_state(self, state: str) -> None:
        if state == self.state:
            return
        log.info("qos state %s -> %s (active=%s queued=%d)", self.state,
                 state, self.active, len(self._waiters))
        self.state = state
        self._state_since = time.monotonic()
        _qos_state.set(STATES.index(state))
        _qos_transitions.labels(state).inc()

    def _pressure(self) -> bool:
        """Foreground pressure: enough active critical work that new bulk
        admissions should queue rather than contend."""
        return (self.active["critical"]
                >= max(self.cfg.brownout_critical_threshold, 1))

    def _bulk_gate_full(self) -> bool:
        limit = self.cfg.bulk_active_limit
        return limit > 0 and self.active["bulk"] >= limit

    def _note_tenant(self, tenant: str, key: str) -> None:
        if not tenant:
            return
        row = self.tenant_counters.setdefault(
            tenant, {"admitted": 0, "queued": 0, "shed": 0})
        row[key] += 1

    def _shed(self, cls: str, tenant: str, reason: str) -> None:
        self.counters["shed"][cls] += 1
        self._note_tenant(tenant, "shed")
        _qos_shed.labels(cls, reason).inc()
        self._set_state("shed")
        exc = DFError(Code.RESOURCE_EXHAUSTED,
                      f"qos: {cls} admission shed ({reason}); retry later")
        # the retry ladder's hint (common/retry.retry_after_s) and the
        # proxy/object-gateway's Retry-After header both read this
        exc.retry_after_ms = self.cfg.shed_retry_after_ms
        raise exc

    # ------------------------------------------------------------------

    async def admit(self, cls: str, tenant: str = "") -> tuple[str, str]:
        """Admit one new download task of ``cls``; returns ``(class,
        ruling)`` where ruling is ``"ok"`` (admitted immediately) or
        ``"queued"`` (admitted after riding the brownout queue — callers
        journal it as a flight ``qos`` event). The class comes back so
        callers pass the exact accounted value to ``release``. Raises
        RESOURCE_EXHAUSTED (+retry_after_ms) on shed. Non-bulk classes
        never block here."""
        if cls not in PRIORITY_CLASSES:
            cls = DEFAULT_PRIORITY_CLASS
        if not self.cfg.enabled or cls != "bulk":
            self._admit_now(cls, tenant)
            return cls, "ok"
        # fresh arrivals queue behind existing waiters (`self._waiters`
        # in the gate): without it a bulk request landing just after
        # pressure receded would jump the FIFO queue while the waiters
        # ride out their deadlines — the same inversion the upload
        # server's slot gate guards against
        if not self._pressure() and not self._bulk_gate_full() \
                and not self._waiters:
            if self.state != "normal":
                self._set_state("normal")
            self._admit_now(cls, tenant)
            return cls, "ok"
        # brownout: queue the admission with a bounded deadline
        if len(self._waiters) >= self.cfg.queue_limit:
            self._shed(cls, tenant, "queue-full")
        self._set_state("brownout")
        self.counters["queued"] += 1
        self._note_tenant(tenant, "queued")
        _qos_queued.labels(cls).inc()
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        try:
            await asyncio.wait_for(fut, self.cfg.queue_wait_s)
        except asyncio.TimeoutError:
            self._shed(cls, tenant, "queue-timeout")
        except BaseException:
            # caller died while queued: never strand a granted wake —
            # hand it to the next live waiter (upload-slot discipline)
            if fut.done() and not fut.cancelled():
                self._wake_next()
            else:
                fut.cancel()
            raise
        self._admit_now(cls, tenant)
        return cls, "queued"

    def _admit_now(self, cls: str, tenant: str) -> None:
        self.active[cls] += 1
        self.counters["admitted"][cls] += 1
        self._note_tenant(tenant, "admitted")
        _qos_admitted.labels(cls).inc()
        _qos_active.labels(cls).set(self.active[cls])

    def _wake_next(self) -> bool:
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return True
        return False

    def release(self, cls: str) -> None:
        """One admitted task finished (success OR failure — the counter
        must drain either way or the gate wedges shut forever)."""
        if cls not in PRIORITY_CLASSES:
            cls = DEFAULT_PRIORITY_CLASS
        self.active[cls] = max(0, self.active[cls] - 1)
        _qos_active.labels(cls).set(self.active[cls])
        # receding pressure (or a freed bulk slot) wakes AS MANY queued
        # bulk admissions as the gate has headroom for — a critical task
        # finishing with five bulk waiters parked must not drip them out
        # one per release (they would shed on their deadlines while bulk
        # slots sat idle). Each woken admit() re-counts itself via
        # _admit_now, so the wake loop bounds itself by headroom here.
        if self.cfg.enabled and not self._pressure():
            limit = self.cfg.bulk_active_limit
            headroom = (limit - self.active["bulk"]) if limit > 0 \
                else len(self._waiters)
            while headroom > 0 and self._waiters:
                if not self._wake_next():
                    break
                headroom -= 1
        if not self._waiters and self.state != "normal" \
                and not self._pressure() and not self._bulk_gate_full():
            self._set_state("normal")

    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """GET /debug/qos: the whole QoS plane in one read — degradation
        state, per-class active/admitted/queued/shed, per-tenant
        counters, and the shaper's per-class rate grants."""
        out = {
            "state": self.state,
            "state_since_s": round(time.monotonic() - self._state_since, 3),
            "enabled": self.cfg.enabled,
            "active": dict(self.active),
            "queued_now": len(self._waiters),
            "admitted": dict(self.counters["admitted"]),
            "queued_total": self.counters["queued"],
            "shed": dict(self.counters["shed"]),
            "tenants": {t: dict(row)
                        for t, row in self.tenant_counters.items()},
            "limits": {
                "bulk_active_limit": self.cfg.bulk_active_limit,
                "brownout_critical_threshold":
                    self.cfg.brownout_critical_threshold,
                "queue_wait_s": self.cfg.queue_wait_s,
                "queue_limit": self.cfg.queue_limit,
                "shed_retry_after_ms": self.cfg.shed_retry_after_ms,
            },
        }
        if self.shaper is not None:
            out["classes"] = self.shaper.class_snapshot()
        return out


def add_qos_routes(router, governor: QosGovernor) -> None:
    """``GET /debug/qos`` on a ``common.httpd.Router``: read-only and
    always on, like ``/debug/health``; a browned-out daemon must be
    diagnosable without a restart."""

    async def qos(_params: dict, _query: dict) -> tuple[int, dict]:
        return 200, governor.snapshot()

    router.add_get("/debug/qos", qos)
