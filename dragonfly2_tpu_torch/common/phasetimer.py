"""Control-plane ruling profiler: per-phase timing for scheduler rulings.

Counterpart of ``dragonfly2_tpu/common/phasetimer.py``. Every
``Scheduling`` ruling (``find``/``refresh``/``shard``; ``preempt`` waits
for the QoS plane) is timed and decomposed into the pinned PHASES
vocabulary, aggregated into per-phase latency histograms
(``df_sched_ruling_seconds{phase}``), rulings/sec, and a queue-wait vs
compute split, read live at ``GET /debug/ctrl`` (``scheduler/
ctrl_debug.py``).

Overhead contract (the faultgate idiom): ``ARMED`` is a module-level
boolean, and ``phase()``/``ruling()`` return the shared no-op ``_NULL``
context manager when it is down. Hot loops that cannot afford even that
(the per-candidate exclusion checks) hoist ``armed = phasetimer.ARMED``
once per ruling, accumulate a local ``perf_counter`` delta, and hand it
in with ``record()``.

Purity contract: the profiler observes rulings and never takes part in
one (no rng, no candidate order, no scheduler state), so an armed run's
``schedule_digest`` is the disarmed one's.

Attribution: phases nest (``dag-walk`` and ``exclusion`` run inside
``filter``, every phase inside a ``ruling``); each frame records its self
time, wall elapsed minus its nested children, so the phase columns sum to
about the ruling total and the remainder (``unattributed_ms``) is the
profiler's own overhead plus un-phased ruling code. A phase that raises
still closes and attributes its time. Concurrent rulings (one per report
stream's task) each get their own frame stack through a ``ContextVar``;
the aggregate tables are mutated under one lock.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque

from .metrics import REGISTRY

# The pinned phase vocabulary. Every ``phase(...)``/``record(...)`` call
# site must name a member: an unregistered phase is an invisible
# histogram label.
PHASES = (
    "filter",       # filter_candidates: the whole legality pass
    "dag-walk",     # the one descendant sweep feeding the cycle check
    "exclusion",    # quarantine + federation lookups inside the filter
    "score",        # evaluator evaluate()/explain() + the sort
    "relay",        # relay-tree fan-out shaping (_relay_shape)
    "emit",         # decision-ledger row construction + sink call
)

# The ruling kinds ``ruling(...)`` wraps — the control plane's unit of
# work, matching the decision ledger's find/refresh/preempt/shard
# decision kinds. Same closed-vocabulary contract as PHASES.
RULING_KINDS = ("find", "refresh", "preempt", "shard")

# Ruling phases live at us..ms scale — the default request buckets
# (5ms floor) would put every sample in the first bucket.
_CTRL_BUCKETS = (0.000005, 0.00002, 0.00005, 0.0001, 0.00025, 0.0005,
                 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)

_phase_seconds = REGISTRY.histogram(
    "df_sched_ruling_seconds",
    "per-phase self time inside scheduler rulings (the PHASES "
    "vocabulary; self time = wall minus nested phases, so the phases "
    "sum to ~the ruling total)", ("phase",), buckets=_CTRL_BUCKETS)
_ruling_seconds = REGISTRY.histogram(
    "df_ctrl_ruling_seconds",
    "end-to-end scheduler ruling wall time, by ruling kind "
    "(find/refresh/preempt/shard)", ("kind",), buckets=_CTRL_BUCKETS)
_rulings_total = REGISTRY.counter(
    "df_ctrl_rulings_total",
    "scheduler rulings profiled, by ruling kind", ("kind",))
_queue_wait_seconds = REGISTRY.histogram(
    "df_ctrl_queue_wait_seconds",
    "time a ruling request waited before its ruling ran (cold-herd "
    "arrival-to-service in dfbench --ctrl; patience-loop wait in the "
    "live scheduler)", buckets=_CTRL_BUCKETS + (2.5, 10.0))

ARMED = False

_RECENT = 2048          # per-name self-time samples kept for p50/p99
_ENDS = 8192            # ruling end stamps kept for the rulings/sec window
_RATE_WINDOW_S = 60.0

_lock = threading.Lock()
_armed_at = 0.0

# name -> _Agg; rulings keyed by kind, phases by PHASES member
_phases: dict[str, "_Agg"] = {}
_rulings: dict[str, "_Agg"] = {}
_queue_wait: "_Agg | None" = None
_ruling_ends: deque = deque(maxlen=_ENDS)

# per-asyncio-task (and per-thread) frame stack; each frame is a one-slot
# list holding the child-elapsed accumulator, so nested phases charge
# their wall time to the enclosing frame without any global state
_stack: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "df_phase_stack", default=None)


class _Agg:
    __slots__ = ("count", "total_s", "self_s", "max_s", "recent")

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0      # wall elapsed (children included)
        self.self_s = 0.0       # wall minus nested children
        self.max_s = 0.0
        self.recent: deque = deque(maxlen=_RECENT)

    def add(self, elapsed: float, self_s: float) -> None:
        self.count += 1
        self.total_s += elapsed
        self.self_s += self_s
        if self_s > self.max_s:
            self.max_s = self_s
        self.recent.append(self_s)

    def row(self) -> dict:
        vals = sorted(self.recent)
        return {
            "count": self.count,
            "total_ms": round(self.total_s * 1000, 4),
            "self_ms": round(self.self_s * 1000, 4),
            "mean_ms": round(self.self_s / self.count * 1000, 4)
            if self.count else 0.0,
            "p50_ms": round(_pctl(vals, 0.50) * 1000, 4),
            "p99_ms": round(_pctl(vals, 0.99) * 1000, 4),
            "max_ms": round(self.max_s * 1000, 4),
        }


def _pctl(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over pre-sorted values (the repo-wide
    rule; kept local so common/ stays free of daemon imports)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class _NullCtx:
    """The disarmed path: one shared instance, no-op enter/exit."""
    __slots__ = ()

    def __enter__(self) -> "_NullCtx":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullCtx()


class _Frame:
    """One armed phase/ruling context. Exception-safe by construction:
    ``__exit__`` records whether or not the body raised, so a phase that
    blows up still closes and attributes its time."""
    __slots__ = ("name", "table", "t0", "children")

    def __init__(self, name: str, table: dict) -> None:
        self.name = name
        self.table = table
        self.t0 = 0.0
        self.children = [0.0]

    def __enter__(self) -> "_Frame":
        stack = _stack.get()
        if stack is None:
            stack = []
            _stack.set(stack)
        stack.append(self.children)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        elapsed = time.perf_counter() - self.t0
        stack = _stack.get()
        if stack and stack[-1] is self.children:
            stack.pop()
        if stack:
            stack[-1][0] += elapsed
        self_s = max(elapsed - self.children[0], 0.0)
        with _lock:
            agg = self.table.get(self.name)
            if agg is None:
                agg = self.table[self.name] = _Agg()
            agg.add(elapsed, self_s)
            if self.table is _rulings:
                _ruling_ends.append(time.perf_counter())
                _rulings_total.labels(self.name).inc()
                # a ruling's headline number is its WALL time; phases
                # below it report self time
                _ruling_seconds.labels(self.name).observe(elapsed)
            else:
                _phase_seconds.labels(self.name).observe(self_s)
        return False


def phase(name: str):
    """Time one named phase of a ruling. Disarmed: returns the shared
    no-op context. Armed: validates the name against PHASES (a typo'd
    phase must fail loudly, not mint a new histogram label)."""
    if not ARMED:
        return _NULL
    if name not in PHASES:
        raise ValueError(f"unknown phase {name!r} (PHASES={PHASES})")
    return _Frame(name, _phases)


def ruling(kind: str, queue_wait_s: float | None = None):
    """Time one whole ruling (the outermost frame; phases nest inside).
    ``queue_wait_s`` — how long the request waited before this ruling
    ran — feeds the queue-wait vs compute split when the caller knows
    it (dfbench's cold-herd arrival delta, the service's patience
    wait)."""
    if not ARMED:
        return _NULL
    if kind not in RULING_KINDS:
        raise ValueError(
            f"unknown ruling kind {kind!r} (RULING_KINDS={RULING_KINDS})")
    if queue_wait_s is not None:
        note_queue_wait(queue_wait_s)
    return _Frame(kind, _rulings)


def record(name: str, seconds: float) -> None:
    """Hand in a pre-measured phase duration (the hot-loop accumulation
    path: the filter's per-candidate exclusion checks sum a local
    perf_counter delta and record once per ruling). Charges the open
    enclosing frame like a nested phase would."""
    if not ARMED:
        return
    if name not in PHASES:
        raise ValueError(f"unknown phase {name!r} (PHASES={PHASES})")
    stack = _stack.get()
    if stack:
        stack[-1][0] += seconds
    with _lock:
        agg = _phases.get(name)
        if agg is None:
            agg = _phases[name] = _Agg()
        agg.add(seconds, seconds)
        _phase_seconds.labels(name).observe(seconds)


def note_queue_wait(seconds: float) -> None:
    """Record how long a ruling request sat waiting for the scheduler's
    attention before its ruling started (no-op disarmed)."""
    global _queue_wait
    if not ARMED:
        return
    seconds = max(seconds, 0.0)
    with _lock:
        if _queue_wait is None:
            _queue_wait = _Agg()
        _queue_wait.add(seconds, seconds)
        _queue_wait_seconds.observe(seconds)


def arm() -> None:
    """Arm the profiler (aggregates start empty; re-arming resets)."""
    global ARMED, _armed_at
    with _lock:
        _clear_locked()
        _armed_at = time.time()
    ARMED = True


def disarm() -> None:
    """Stop timing; aggregates stay readable (snapshot/ /debug/ctrl)."""
    global ARMED
    ARMED = False


def reset() -> None:
    """Disarm and drop every aggregate (test isolation)."""
    global ARMED
    ARMED = False
    with _lock:
        _clear_locked()


def _clear_locked() -> None:
    global _queue_wait, _armed_at
    _phases.clear()
    _rulings.clear()
    _ruling_ends.clear()
    _queue_wait = None
    _armed_at = 0.0


def snapshot() -> dict:
    """The live profile: rulings/sec, per-kind and per-phase latency,
    queue-wait vs compute. Pure read — /debug/ctrl serves this."""
    with _lock:
        now = time.perf_counter()
        ends = [t for t in _ruling_ends if now - t <= _RATE_WINDOW_S]
        total = sum(a.count for a in _rulings.values())
        compute_s = sum(a.total_s for a in _rulings.values())
        lifetime_s = (time.time() - _armed_at) if _armed_at else 0.0
        phase_rows = {n: _phases[n].row() for n in sorted(_phases)}
        ruling_rows = {k: _rulings[k].row() for k in sorted(_rulings)}
        qw = _queue_wait.row() if _queue_wait is not None else None
        phase_self_s = sum(a.self_s for a in _phases.values())
    return {
        "armed": ARMED,
        "since": _armed_at,
        "rulings": {
            "total": total,
            # two rates: the recent window (what the fleet is doing NOW)
            # and busy-rate (rulings per second of actual ruling compute
            # — the single-brain capacity number dfbench reports)
            "per_sec_60s": round(len(ends) / min(
                max(lifetime_s, 1e-9), _RATE_WINDOW_S), 3)
            if ends else 0.0,
            "per_sec_busy": round(total / compute_s, 1)
            if compute_s > 0 else 0.0,
            "by_kind": ruling_rows,
        },
        "phases": phase_rows,
        "compute_ms": round(compute_s * 1000, 3),
        # ruling wall time not attributed to any phase: profiler
        # overhead + un-phased ruling code; a growing share here means
        # the phase vocabulary no longer covers the hot path
        "unattributed_ms": round(
            max(compute_s - phase_self_s, 0.0) * 1000, 3),
        "queue_wait_ms": qw,
    }
