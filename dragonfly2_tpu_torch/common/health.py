"""Runtime health plane: event-loop watchdog + per-stage SLO engine.

Counterpart of ``dragonfly2_tpu/common/health.py``. asyncio has no Go
runtime to keep a wedged coroutine from silencing a peer, so this plane
makes that failure class self-reporting:

* **Loop lag sampler**: a monitor coroutine sleeps a fixed interval and
  measures the overshoot (``df_loop_lag_seconds``, a high-water gauge);
  an overshoot past ``stall_threshold_s`` is a stall, logged with the full
  await-chain dump and the active flight-recorder state, and kept in the
  ``/debug/health`` ring.
* **Coroutine watchdog**: hot paths register sections (``with
  PLANE.watchdog.section("piece.wire", deadline_s=...)``) around awaits
  that own a latency budget; the monitor walks open sections each tick,
  and one past its deadline gets its task's await chain dumped
  (``cr_await`` followed by hand: ``Task.get_stack`` shows only the
  outermost frame) and counts an SLO breach for its stage.
* **SLO engine**: per-stage latency budgets (schedule, first byte, wire,
  device ingest) judged over flight-recorder piece rows at task finish
  and on watchdog overruns, exported as ``df_slo_breach_total{stage,
  rung}`` and annotated onto flight summaries.

Overhead: one monitor coroutine per process ticking at
``sample_interval_s``; a section is a dict insert, skipped while the plane
is not running. Exposure: ``GET /debug/health`` on the daemon's upload
port and on every launcher's ``--debug-port`` (``?dump=1`` returns the
text stack dump).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
import weakref
from collections import deque
from dataclasses import dataclass

from .metrics import REGISTRY

log = logging.getLogger("df.health")

# flight-recorder piece-row key -> SLO stage name (the budget vocabulary)
STAGE_KEYS = (("queue_ms", "schedule"), ("ttfb_ms", "first_byte"),
              ("wire_ms", "wire"), ("hbm_ms", "hbm"))

_loop_lag = REGISTRY.histogram(
    "df_loop_lag_seconds", "event-loop scheduling lag sampled by the "
    "health monitor", buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                               1.0, 2.5, 5.0, 10.0, 30.0))
_loop_lag_max = REGISTRY.gauge(
    "df_loop_lag_max_seconds", "high-water event-loop lag since boot")
_loop_stalls = REGISTRY.counter(
    "df_loop_stalls_total", "loop-lag samples past the stall threshold")
_overruns = REGISTRY.counter(
    "df_watchdog_overrun_total", "watchdog sections past their deadline",
    ("section",))
_slo_breaches = REGISTRY.counter(
    "df_slo_breach_total", "per-stage latency budget breaches",
    ("stage", "rung"))
_qos_slo_breaches = REGISTRY.counter(
    "df_qos_slo_breach_total",
    "per-stage latency budget breaches by QoS class (budgets scaled by "
    "CLASS_SLO_MULTIPLIERS: critical answers to tighter budgets, bulk "
    "gets brownout headroom)", ("cls", "stage"))


@dataclass
class HealthConfig:
    """Knobs for the runtime health plane (daemon config ``health``)."""

    enabled: bool = True
    sample_interval_s: float = 0.1     # monitor tick / lag sample period
    stall_threshold_s: float = 1.0     # lag past this = loop stall event
    dump_min_interval_s: float = 10.0  # stack-dump rate limit
    # per-stage SLO budgets (ms) evaluated over flight-recorder piece rows;
    # <= 0 disables that stage's budget
    slo_schedule_ms: float = 1000.0    # scheduled -> dispatched (queue)
    slo_first_byte_ms: float = 2000.0  # dispatched -> first body byte
    slo_wire_ms: float = 5000.0        # first byte -> piece verified
    slo_hbm_ms: float = 1000.0         # wire done -> staged for the sink

    def budgets_ms(self) -> dict[str, float]:
        return {"schedule": self.slo_schedule_ms,
                "first_byte": self.slo_first_byte_ms,
                "wire": self.slo_wire_ms,
                "hbm": self.slo_hbm_ms}


# ---------------------------------------------------------------- stacks

def format_stacks(*, max_depth: int = 16) -> str:
    """Every thread's stack + every asyncio task's FULL await chain.

    ``Task.get_stack`` reports only the outermost coroutine frame, which is
    exactly the frame that hides a parked hang, so walk ``cr_await`` /
    ``gi_yieldfrom`` by hand. Shared by ``/debug/stacks`` (debug_http) and
    the watchdog's auto-dumps.
    """
    import io
    import sys
    import threading
    import traceback

    buf = io.StringIO()
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        buf.write(f"--- thread {names.get(tid, tid)} ---\n")
        traceback.print_stack(frame, file=buf)
    buf.write("--- asyncio tasks ---\n")
    try:
        tasks = asyncio.all_tasks()
    except RuntimeError:        # no running loop (called from a thread)
        tasks = set()
    for task in tasks:
        buf.write(f"{task.get_name()}: {task.get_coro()}\n")
        buf.write(format_await_chain(task, max_depth=max_depth))
    return buf.getvalue()


def format_await_chain(task: asyncio.Task, *, max_depth: int = 16) -> str:
    """One task's await chain, innermost frame last (where it is parked)."""
    out: list[str] = []
    coro, depth = task.get_coro(), 0
    while coro is not None and depth < max_depth:
        frame = (getattr(coro, "cr_frame", None)
                 or getattr(coro, "gi_frame", None))
        if frame is not None:
            out.append(f"  {frame.f_code.co_filename}:{frame.f_lineno} "
                       f"{frame.f_code.co_name}\n")
        nxt = (getattr(coro, "cr_await", None)
               or getattr(coro, "gi_yieldfrom", None))
        if nxt is None and frame is None:
            break
        coro = nxt
        depth += 1
    return "".join(out)


# ---------------------------------------------------------------- SLO

# per-class SLO budget multipliers (multi-tenant QoS): a flight summary
# carrying ``qos_class`` is judged against its class's scaled budgets —
# ``critical`` work answers to HALF the configured budgets (it exists to
# hold a tight tail), ``bulk`` gets 4x headroom (being throttled under
# brownout is its contract, not a breach). ``standard`` and classless
# ("" — every pre-QoS caller) stay exactly on the configured budgets.
CLASS_SLO_MULTIPLIERS = {"critical": 0.5, "standard": 1.0, "bulk": 4.0,
                         "": 1.0}


class SLOEngine:
    """Per-stage latency budgets over flight-recorder timestamps.

    Budgets come from ``HealthConfig``; breaches are counted once per task
    (``observe_summary`` at conductor finish) or per watchdog overrun
    (``breach``), labeled by the degradation-ladder rung that was serving
    when the budget blew — "the wire stage breached while on back_source"
    reads very differently from the same breach on p2p.
    """

    def __init__(self, budgets_ms: dict[str, float] | None = None, *,
                 enabled: bool = True):
        self.enabled = enabled
        self.budgets_ms: dict[str, float] = dict(
            budgets_ms or HealthConfig().budgets_ms())
        self._counts: dict[tuple[str, str], int] = {}

    def configure(self, budgets_ms: dict[str, float]) -> None:
        self.budgets_ms.update(budgets_ms)

    def budget_s(self, stage: str) -> float:
        return max(self.budgets_ms.get(stage, 0.0), 0.0) / 1000.0

    def section_deadline_s(self, n_pieces: int = 1) -> float:
        """Watchdog deadline for one parent request: the request window
        covers connection+TTFB plus the wire time of EVERY piece in the
        group — judging it against the single-piece wire budget alone
        would trip the watchdog on healthy multi-piece spans. 0 (section
        disabled) when both budgets are unset."""
        wire = self.budget_s("wire")
        if wire <= 0:
            return 0.0
        return self.budget_s("first_byte") + wire * max(n_pieces, 1)

    def annotate(self, summary: dict) -> dict:
        """Pure annotation (no counters): per-stage breach counts over the
        summary's piece rows, attached as ``summary['slo_breaches']`` so
        every flight surface (HTTP, dfdiag, PeerResult) carries the
        verdict. Idempotent; untouched summary when the engine is off
        (``health.enabled: false`` must really mean off)."""
        if not self.enabled:
            return summary
        mult = CLASS_SLO_MULTIPLIERS.get(
            summary.get("qos_class", ""), 1.0)
        breaches: dict[str, int] = {}
        for row in summary.get("piece_rows") or []:
            for key, stage in STAGE_KEYS:
                budget = self.budgets_ms.get(stage, 0.0) * mult
                if budget > 0 and row.get(key, 0.0) > budget:
                    breaches[stage] = breaches.get(stage, 0) + 1
        summary["slo_breaches"] = breaches
        summary["slo_budgets_ms"] = {
            k: v * mult for k, v in self.budgets_ms.items() if v > 0}
        return summary

    def observe_summary(self, summary: dict) -> dict[str, int]:
        """Count the summary's breaches into ``df_slo_breach_total`` —
        called ONCE per task, at conductor finish."""
        if not self.enabled:
            return {}
        breaches = summary.get("slo_breaches")
        if breaches is None:
            breaches = self.annotate(summary)["slo_breaches"]
        rung = summary.get("served_rung") or "p2p"
        cls = summary.get("qos_class") or "standard"
        for stage, n in breaches.items():
            self._count(stage, rung, n)
            # per-class breach accounting (QoS): the per-class SLO budget
            # verdict operators alert on — a critical-class breach pages,
            # a bulk-class one is the brownout working as designed
            _qos_slo_breaches.labels(cls, stage).inc(n)
        return breaches

    def breach(self, stage: str, rung: str = "p2p", n: int = 1) -> None:
        """A breach observed OUTSIDE a flight summary (watchdog overrun)."""
        if self.enabled:
            self._count(stage, rung, n)

    def _count(self, stage: str, rung: str, n: int) -> None:
        _slo_breaches.labels(stage, rung).inc(n)
        key = (stage, rung)
        self._counts[key] = self._counts.get(key, 0) + n

    def snapshot(self) -> dict:
        return {"budgets_ms": dict(self.budgets_ms),
                "breaches": [{"stage": s, "rung": r, "count": c}
                             for (s, r), c in sorted(self._counts.items())]}


# ---------------------------------------------------------------- watchdog

class _Section:
    __slots__ = ("id", "name", "stage", "rung", "deadline_at", "task",
                 "opened_at", "fired")

    def __init__(self, sid: int, name: str, stage: str, rung: str,
                 deadline_at: float, task: asyncio.Task | None):
        self.id = sid
        self.name = name
        self.stage = stage
        self.rung = rung
        self.deadline_at = deadline_at
        self.task = task
        self.opened_at = time.monotonic()
        self.fired = False


class _SectionCtx:
    __slots__ = ("_wd", "_section")

    def __init__(self, wd: "Watchdog | None", section: _Section | None):
        self._wd = wd
        self._section = section

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if self._wd is not None and self._section is not None:
            self._wd._close(self._section, failed=exc_type is not None)
        return False


_NULL_CTX = _SectionCtx(None, None)


class Watchdog:
    """Deadline sections over awaits; the plane's monitor sweeps them."""

    def __init__(self, plane: "HealthPlane"):
        self._plane = plane
        self._ids = itertools.count(1)
        self._sections: dict[int, _Section] = {}

    def section(self, name: str, deadline_s: float, *, stage: str = "",
                rung: str = "p2p") -> _SectionCtx:
        """Register a deadline around the caller's next await(s). No-op
        (shared null context) while the plane is not running or the
        deadline is unset — the hot path pays one attribute load."""
        if not self._plane.active or deadline_s <= 0:
            return _NULL_CTX
        try:
            task = asyncio.current_task()
        except RuntimeError:
            task = None
        s = _Section(next(self._ids), name, stage, rung,
                     time.monotonic() + deadline_s, task)
        self._sections[s.id] = s
        return _SectionCtx(self, s)

    def _close(self, section: _Section, *, failed: bool = False) -> None:
        self._sections.pop(section.id, None)
        # SLO accounting is exactly-once per piece: a section that overran
        # and then FAILED (deadline cancel, transport error) never lands a
        # flight row, so the breach is counted here; one that completed
        # late is counted by its own flight row at task finish instead
        if section.fired and failed and section.stage:
            self._plane.slo.breach(section.stage, section.rung)

    def check(self, now: float) -> None:
        """Monitor tick: fire each overdue section once (the await-chain
        dump + overrun counter; the SLO breach is settled at close)."""
        for s in list(self._sections.values()):
            if s.fired or now < s.deadline_at:
                continue
            s.fired = True
            age = now - s.opened_at
            _overruns.labels(s.name).inc()
            chain = (format_await_chain(s.task)
                     if s.task is not None and not s.task.done() else "")
            self._plane.record_event(
                "section_overrun",
                f"watchdog: section {s.name} over deadline "
                f"({age:.2f}s held, budget {s.deadline_at - s.opened_at:.2f}s)",
                stacks=chain, section=s.name, stage=s.stage, rung=s.rung)
            self._plane.maybe_dump(
                f"watchdog section {s.name} overran its deadline")

    def snapshot(self) -> dict:
        now = time.monotonic()
        return {"active_sections": [
            {"name": s.name, "stage": s.stage,
             "held_s": round(now - s.opened_at, 3),
             "deadline_in_s": round(s.deadline_at - now, 3),
             "overdue": s.fired}
            for s in self._sections.values()]}


# ---------------------------------------------------------------- plane

class HealthPlane:
    """Process-wide health runtime: one monitor coroutine, refcounted.

    Co-resident services (the test suite runs several daemons per process)
    share the plane the way they share the metrics REGISTRY: ``acquire()``
    at service start, ``release()`` at stop; the monitor runs while any
    holder is alive and is recreated transparently when a fresh event loop
    replaces the one it was started on (sequential ``asyncio.run`` calls).
    """

    MAX_EVENTS = 32

    def __init__(self) -> None:
        self.cfg = HealthConfig()
        self.slo = SLOEngine(self.cfg.budgets_ms())
        self.watchdog = Watchdog(self)
        self.events: deque = deque(maxlen=self.MAX_EVENTS)
        self.started_at = time.time()
        self.last_lag_s = 0.0
        self.max_lag_s = 0.0
        self.samples = 0
        self.stalls = 0
        self._refs = 0
        self._monitor: asyncio.Task | None = None
        self._last_dump = 0.0
        self._recorders: list = []      # weakrefs to FlightRecorders

    # -- lifecycle -----------------------------------------------------

    @property
    def active(self) -> bool:
        return self._monitor is not None and not self._monitor.done()

    def acquire(self, cfg: HealthConfig | None = None) -> None:
        """Adopt config and ensure the monitor runs on the CURRENT loop.
        Requires a running loop. Refcounted against release().

        The plane is process-wide, so config is LAST-CALLER-WINS (the
        same contract as tracing.configure and the shared REGISTRY):
        co-resident services share one set of budgets and one
        enabled/disabled state — in production each process runs one
        service, so the shared knobs only show in multi-daemon tests."""
        if cfg is not None:
            self.cfg = cfg
            self.slo.configure(cfg.budgets_ms())
            # disabling the plane disables the WHOLE plane: no monitor,
            # no sections (watchdog.section short-circuits on active), and
            # no SLO counting/annotation either
            self.slo.enabled = cfg.enabled
        self._refs += 1
        if not self.cfg.enabled:
            # last-caller-wins includes OFF: a disabled acquire stops a
            # monitor an earlier holder started
            if self._monitor is not None:
                self._monitor.cancel()
                self._monitor = None
            return
        if self._monitor is not None and self._monitor.done():
            self._monitor = None        # prior loop gone (sequential runs)
        if self._monitor is None:
            self._monitor = asyncio.get_running_loop().create_task(
                self._run(), name="df-health-monitor")

    def release(self) -> None:
        self._refs = max(0, self._refs - 1)
        if self._refs == 0 and self._monitor is not None:
            self._monitor.cancel()
            self._monitor = None

    def attach_recorder(self, recorder) -> None:
        """Register a FlightRecorder whose active-flight state rides the
        stall dumps (weakly — a stopped daemon must not pin its journal)."""
        self._recorders = [r for r in self._recorders if r() is not None]
        if all(r() is not recorder for r in self._recorders):
            self._recorders.append(weakref.ref(recorder))

    # -- monitor -------------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # re-read each tick: a later acquire() may retune the cadence
            interval = max(self.cfg.sample_interval_s, 0.01)
            t0 = loop.time()
            await asyncio.sleep(interval)
            lag = max(loop.time() - t0 - interval, 0.0)
            self.samples += 1
            self.last_lag_s = lag
            _loop_lag.observe(lag)
            if lag > self.max_lag_s:
                self.max_lag_s = lag
                _loop_lag_max.set(lag)
            if lag >= self.cfg.stall_threshold_s:
                self.stalls += 1
                _loop_stalls.inc()
                self.record_event(
                    "loop_stall",
                    f"event loop stalled {lag:.2f}s (threshold "
                    f"{self.cfg.stall_threshold_s:.2f}s)", lag_s=lag)
                self.maybe_dump(f"loop stalled {lag:.2f}s")
            self.watchdog.check(time.monotonic())

    # -- events + dumps ------------------------------------------------

    def record_event(self, kind: str, message: str, *, stacks: str = "",
                     **extra) -> None:
        log.warning("%s", message)
        self.events.append({"t": time.time(), "kind": kind,
                            "message": message, "stacks": stacks, **extra})

    def flight_state(self) -> list[dict]:
        out = []
        for ref in list(self._recorders):
            rec = ref()
            if rec is None:
                self._recorders.remove(ref)
                continue
            out.append({"tasks": rec.index()})
        return out

    def dump(self) -> str:
        """Full await-chain stacks + active flight-recorder state — the
        first two questions of any hang investigation, answered in one
        read."""
        parts = [format_stacks()]
        flights = self.flight_state()
        if flights:
            parts.append("--- flight recorders ---")
            for i, f in enumerate(flights):
                for t in f["tasks"]:
                    parts.append(f"recorder[{i}] task {t['task_id'][:16]} "
                                 f"state={t['state']} events={t['events']}")
        return "\n".join(parts)

    def maybe_dump(self, why: str) -> None:
        """Rate-limited full dump to the log: a wedged pod self-reports
        once per window instead of log-flooding (or saying nothing at
        all)."""
        now = time.monotonic()
        if now - self._last_dump < self.cfg.dump_min_interval_s:
            return
        self._last_dump = now
        log.warning("health dump (%s):\n%s", why, self.dump())

    # -- exposure ------------------------------------------------------

    def snapshot(self) -> dict:
        stalled = (self.events and self.events[-1]["kind"] == "loop_stall"
                   and time.time() - self.events[-1]["t"] < 60.0)
        overdue = any(s["overdue"]
                      for s in self.watchdog.snapshot()["active_sections"])
        return {
            "status": ("stalled" if stalled or overdue else "ok"),
            "active": self.active,
            "loop": {"last_lag_s": round(self.last_lag_s, 6),
                     "max_lag_s": round(self.max_lag_s, 6),
                     "samples": self.samples,
                     "stalls": self.stalls,
                     "sample_interval_s": self.cfg.sample_interval_s,
                     "stall_threshold_s": self.cfg.stall_threshold_s},
            "watchdog": self.watchdog.snapshot(),
            "slo": self.slo.snapshot(),
            "events": list(self.events),
            "flight_recorders": self.flight_state(),
        }


PLANE = HealthPlane()


def add_health_routes(router) -> None:
    """``GET /debug/health``: the plane's snapshot (``?dump=1``: the text
    stack dump). Read-only and cheap, so mounted on the daemon's upload
    server always and on every launcher's ``--debug-port``."""

    async def health(_params, query):
        if query.get("dump"):
            return 200, PLANE.dump()
        return 200, PLANE.snapshot()

    router.add_get("/debug/health", health)
