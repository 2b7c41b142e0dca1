"""Fleet pulse: push-based continuous telemetry and anomaly detection.

Counterpart of ``dragonfly2_tpu/scheduler/fleetpulse.py``. Podscope's
HTTP sweep is O(pod) and point in time: a stall that resolved before an
operator ran ``dfdiag --pod`` is unobservable. Here telemetry is pushed:
each daemon folds its counters into a ``PulseDigest``
(``daemon/pulse.py``) and piggybacks it on the ``AnnounceHost``
heartbeat it already sends. This module keeps a bounded ring of samples
per daemon and fleet rollups, runs an EWMA / z-score detector over the
streams, emits each firing as a ``decision_kind=anomaly`` ledger row, and
captures an incident bundle (the daemon's recent pulses and, where the
planes exist, its quarantine and federation standing) into a bounded
ring, all served at ``GET /debug/fleet`` and rendered by ``dfdiag
--fleet``.

``ingest`` mutates only FleetPulse state, metrics and the decision
ledger, never the resource model or a ruling input.

The anomaly vocabulary is closed:

* ``loop-stall``: a daemon's event-loop lag high-water mark spiked;
* ``slo-storm``: per-stage SLO breaches burst past baseline;
* ``rung-escalation``: serves escalated off the primary ladder rung;
* ``shed-wave``: QoS admissions shed in a burst;
* ``corrupt-burst``: corrupt verdicts or shunned parents burst, or the
  daemon self-quarantined;
* ``silent-daemon``: announces stopped arriving.

Detection: per (daemon, signal) EWMA mean and variance, fire when the
z-score and an absolute floor are both crossed, latch the episode so a
sustained anomaly fires once, freeze the baseline while latched, and
suppress everything until ``WARMUP_SAMPLES`` announces have been seen.
The clock is injectable: dfbench replays detection on a virtual clock.

The port's scheduler builds it with ``quarantine``, ``federation`` and
``statestore`` set to ``None`` until ROADMAP Queue 1 items 5a and 5c
land; its rings are then not registered with a state store.
"""

from __future__ import annotations

import logging
import math
import time
from collections import deque
from typing import Any, Callable

from ..common.metrics import REGISTRY

log = logging.getLogger("df.sched.fleetpulse")

# The closed anomaly vocabulary (the reference's, kind for kind).
ANOMALY_KINDS = (
    "loop-stall",
    "slo-storm",
    "rung-escalation",
    "shed-wave",
    "corrupt-burst",
    "silent-daemon",
)

PULSE_RING = 32             # samples retained per daemon
INCIDENT_RING = 64          # incident bundles retained fleet-wide
ANOMALY_LOG = 256           # recent anomaly rows kept for /debug/fleet
EWMA_ALPHA = 0.3            # per-signal EWMA smoothing
Z_THRESHOLD = 4.0           # fire at this z-score (and the abs floor)
Z_CLEAR = 2.0               # episode clears back under this z-score
WARMUP_SAMPLES = 8          # announces before a daemon's detector arms
SILENT_AFTER_INTERVALS = 2.5   # missed-announce factor -> silent-daemon
EVICT_AFTER_INTERVALS = 20.0   # missed-announce factor -> series aged out
PRIMARY_RUNG = "p2p"        # ladder rung that does NOT count as escalated

# signal name -> (anomaly kind, absolute floor the value must also cross:
# a z-spike on near-zero noise is arithmetic, not an incident)
_SIGNALS = {
    "lag_ms": ("loop-stall", 50.0),
    "slo_delta": ("slo-storm", 3.0),
    "rung_delta": ("rung-escalation", 3.0),
    "shed_delta": ("shed-wave", 3.0),
    "corrupt_delta": ("corrupt-burst", 2.0),
}

_daemons_gauge = REGISTRY.gauge(
    "df_fleet_daemons", "daemons with a live fleet-pulse series")
_pulse_total = REGISTRY.counter(
    "df_fleet_pulse_total",
    "pulse digests ingested from announces, by result "
    "(ok / ignored_version / malformed)", ("result",))
_anomalies_total = REGISTRY.counter(
    "df_fleet_anomalies_total",
    "fleet anomaly episodes fired, by kind", ("kind",))
_incidents_gauge = REGISTRY.gauge(
    "df_fleet_incidents", "incident bundles held in the bounded ring")
_pulse_bytes = REGISTRY.gauge(
    "df_fleet_pulse_bytes",
    "encoded size of the last ingested pulse digest (the per-announce "
    "piggyback overhead; dfbench --pr18 gates it at <= 512 B)")


class _Ewma:
    """EWMA mean/variance over one signal of one daemon's stream."""

    __slots__ = ("mean", "var", "n")

    def __init__(self) -> None:
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> None:
        if self.n == 0:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += EWMA_ALPHA * d
            self.var = (1.0 - EWMA_ALPHA) * (self.var + EWMA_ALPHA * d * d)
        self.n += 1

    def z(self, x: float) -> float:
        # sd floor: a flat stream must not turn the first wiggle into an
        # infinite z — absolute floors in _SIGNALS carry the real gate
        sd = max(math.sqrt(max(self.var, 0.0)), 1.0, 0.1 * abs(self.mean))
        return (x - self.mean) / sd


class _Series:
    """One daemon's bounded pulse history + detector state."""

    __slots__ = ("ring", "last", "last_at", "first_at", "interval_s",
                 "ewma", "active", "silent", "samples")

    def __init__(self, ring: int) -> None:
        self.ring: deque = deque(maxlen=ring)
        self.last: dict[str, Any] = {}
        self.last_at = 0.0
        self.first_at = 0.0
        self.interval_s = 30.0
        self.ewma: dict[str, _Ewma] = {s: _Ewma() for s in _SIGNALS}
        self.active: dict[str, float] = {}   # anomaly kind -> since
        self.silent = False
        self.samples = 0


def _pulse_dict(pulse: Any) -> dict | None:
    """Accept a PulseDigest message or a plain dict; None on junk."""
    if pulse is None:
        return None
    if isinstance(pulse, dict):
        return pulse
    d = getattr(pulse, "__dict__", None)
    return dict(d) if isinstance(d, dict) else None


def _escalated(rungs: Any) -> int:
    """Serves beyond the primary ladder rung (the degradation ladder): the
    count that grows when a pod degrades down the ladder."""
    if not isinstance(rungs, dict):
        return 0
    total = 0
    for name, n in rungs.items():
        if name not in (PRIMARY_RUNG, ""):
            try:
                total += int(n)
            except (TypeError, ValueError):
                continue
    return total


class FleetPulse:
    """Scheduler-side pulse ingest, rings, detector, incident capture.

    ``sink`` is the decision-ledger hook (``DecisionLedger.on_decision``
    in production, a plain list append in dfbench) — every anomaly
    firing lands there as a ``decision_kind=anomaly`` row. ``clock`` is
    injectable monotonic; dfbench drives it virtually so detection
    latency replays byte-identically.
    """

    def __init__(self, *, sink: Callable[[dict], None] | None = None,
                 quarantine=None, federation=None, statestore=None,
                 ring: int = PULSE_RING, incident_ring: int = INCIDENT_RING,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.sink = sink
        self.quarantine = quarantine
        self.federation = federation
        self.statestore = statestore
        self.ring = ring
        self.clock = clock
        self._series: dict[str, _Series] = {}
        self.incidents: deque = deque(maxlen=incident_ring)
        self.anomalies: deque = deque(maxlen=ANOMALY_LOG)
        self.anomaly_counts: dict[str, int] = {k: 0 for k in ANOMALY_KINDS}
        self.seq = 0                 # anomaly decision-id counter
        self.ingested = 0
        self.ignored = 0

    # -- ingest (the announce path: must never raise) -------------------

    def ingest(self, host_id: str, pulse: Any, *,
               interval_s: float = 30.0) -> bool:
        """Fold one announce's pulse into the rings and run the
        detector. Total: version skew, junk fields, or a crash anywhere
        inside is counted and swallowed — a daemon's telemetry must
        never be able to take the announce plane down."""
        try:
            return self._ingest(host_id, pulse, interval_s)
        except Exception as exc:  # noqa: BLE001 - announce path, never raise
            self.ignored += 1
            _pulse_total.labels("malformed").inc()
            log.warning("pulse from %s refused: %s", host_id, exc)
            return False

    def _ingest(self, host_id: str, pulse: Any, interval_s: float) -> bool:
        from ..idl.base import dumps
        from ..idl.messages import PULSE_VERSION

        p = _pulse_dict(pulse)
        if p is None or not host_id:
            self.ignored += 1
            _pulse_total.labels("malformed").inc()
            return False
        if p.get("v") != PULSE_VERSION:
            # unknown-version digest: a newer (or torn) daemon — ignored
            # WHOLESALE, never half-applied (the PEX schema-refusal rule)
            self.ignored += 1
            _pulse_total.labels("ignored_version").inc()
            return False
        now = self.clock()
        s = self._series.get(host_id)
        if s is None:
            s = self._series[host_id] = _Series(self.ring)
            s.first_at = now
            _daemons_gauge.set(len(self._series))
        if interval_s > 0:
            s.interval_s = float(interval_s)
        if s.silent:
            # the daemon is back: the silent-daemon episode ends here
            s.silent = False
            s.active.pop("silent-daemon", None)

        lag_ms = float(p.get("loop_lag_max_ms") or 0.0)
        cum = {
            "slo": int(p.get("slo_breaches") or 0),
            "rung": _escalated(p.get("served_rungs")),
            "shed": int(p.get("qos_shed") or 0),
            "corrupt": (int(p.get("corrupt_verdicts") or 0)
                        + int(p.get("shunned_parents") or 0)),
        }
        # counters are since-boot monotonic; a daemon restart resets them
        # (negative delta) — clamp to zero and re-baseline
        deltas = {k: max(v - int(s.last.get(k, 0)), 0)
                  for k, v in cum.items()}
        values = {
            "lag_ms": lag_ms,
            "slo_delta": float(deltas["slo"]),
            "rung_delta": float(deltas["rung"]),
            "shed_delta": float(deltas["shed"]),
            "corrupt_delta": float(deltas["corrupt"]),
        }

        sample = {
            "at": round(now, 3),
            "seq": int(p.get("seq") or 0),
            "flight": int(p.get("flight_tasks") or 0),
            "lag_ms": round(lag_ms, 3),
            "slo": cum["slo"],
            "rung_hi": cum["rung"],
            "shed": cum["shed"],
            "corrupt": cum["corrupt"],
            "qos": str(p.get("qos_state") or "normal"),
            "quar": bool(p.get("self_quarantined")),
        }
        prev_quar = bool(s.last.get("quar"))
        s.ring.append(sample)
        s.samples += 1
        s.last = dict(cum)
        s.last["quar"] = sample["quar"]
        s.last_at = now
        self.ingested += 1
        _pulse_total.labels("ok").inc()
        try:
            if not isinstance(pulse, dict):
                _pulse_bytes.set(len(dumps(pulse)))
        except Exception:  # noqa: BLE001 - size gauge is best-effort
            pass

        # -- detector: one pass per signal, exactly-once per episode
        for sig, value in values.items():
            kind, floor = _SIGNALS[sig]
            ew = s.ewma[sig]
            if kind in s.active:
                # latched: clear when the stream is back under both gates;
                # baseline stays FROZEN so the anomaly never becomes normal.
                # A corrupt-burst latched by the self-quarantine flag holds
                # until the flag clears, whatever the verdict deltas do.
                held = (kind == "corrupt-burst" and sample["quar"])
                if not held and (value < floor or ew.z(value) < Z_CLEAR):
                    s.active.pop(kind, None)
                    ew.update(value)
                continue
            if ew.n >= WARMUP_SAMPLES and value >= floor \
                    and ew.z(value) >= Z_THRESHOLD:
                self._fire(kind, host_id, s, now,
                           value=value, zscore=ew.z(value), signal=sig)
                continue
            ew.update(value)
        # self-quarantine flip is hard first-hand evidence, not a z-score
        # call: fire on the False->True transition, no warm-up required
        if sample["quar"] and not prev_quar \
                and "corrupt-burst" not in s.active:
            self._fire("corrupt-burst", host_id, s, now,
                       value=1.0, zscore=0.0, signal="self_quarantined")
        return True

    # -- tick (GC cadence): silent daemons + ring aging ------------------

    def tick(self) -> int:
        """Sweep for daemons whose announces stopped (``silent-daemon``)
        and age out series long gone (bounded memory under churn).
        Runs on the scheduler's GC ticker; returns fired + evicted."""
        now = self.clock()
        fired = 0
        evict: list[str] = []
        for host_id, s in self._series.items():
            gone_s = now - s.last_at
            if gone_s > EVICT_AFTER_INTERVALS * s.interval_s:
                # a tick cadence coarser than the silent window can jump
                # a dead daemon straight past the eviction horizon — the
                # death must still fire ONCE before the series goes
                if not s.silent and s.samples >= 1:
                    s.silent = True
                    self._fire("silent-daemon", host_id, s, now,
                               value=round(gone_s, 1), zscore=0.0,
                               signal="announce_gap_s")
                    fired += 1
                evict.append(host_id)
                continue
            if not s.silent and s.samples >= 1 \
                    and gone_s > SILENT_AFTER_INTERVALS * s.interval_s:
                s.silent = True
                self._fire("silent-daemon", host_id, s, now,
                           value=round(gone_s, 1), zscore=0.0,
                           signal="announce_gap_s")
                fired += 1
        for host_id in evict:
            del self._series[host_id]
        if evict:
            _daemons_gauge.set(len(self._series))
        return fired + len(evict)

    # -- anomaly firing + incident capture -------------------------------

    def _fire(self, kind: str, host_id: str, s: _Series, now: float, *,
              value: float, zscore: float, signal: str) -> None:
        s.active[kind] = now
        self.seq += 1
        self.anomaly_counts[kind] = self.anomaly_counts.get(kind, 0) + 1
        _anomalies_total.labels(kind).inc()
        row = {
            "kind": "decision",
            "decision_kind": "anomaly",
            "decision_id": f"a{self.seq:08d}.{kind}",
            "anomaly": kind,
            "host_id": host_id,
            "signal": signal,
            "value": round(float(value), 3),
            "zscore": round(float(zscore), 2),
            "at": round(now, 3),
            "task_id": "",
            "peer_id": "",
            "candidates": [],
            "excluded": [],
            "chosen": [host_id],
        }
        self.anomalies.append({k: row[k] for k in
                               ("decision_id", "anomaly", "host_id",
                                "signal", "value", "zscore", "at")})
        if self.sink is not None:
            self.sink(row)
        self.incidents.append(self._bundle(row, s))
        _incidents_gauge.set(len(self.incidents))
        log.warning("fleet anomaly %s on %s (%s=%.3f z=%.2f)",
                    kind, host_id, signal, value, zscore)

    def _bundle(self, row: dict, s: _Series) -> dict:
        """The post-hoc reconstruction kit: the offending daemon's recent
        pulse ring plus its standing in the quarantine ladder and the
        federation's pod map, captured AT firing time (state later moves
        on; the bundle is what the operator wishes they had screenshotted)."""
        bundle = {
            "id": row["decision_id"],
            "anomaly": row["anomaly"],
            "host_id": row["host_id"],
            "signal": row["signal"],
            "value": row["value"],
            "zscore": row["zscore"],
            "at": row["at"],
            "active": sorted(s.active),
            "pulses": list(s.ring),
        }
        if self.quarantine is not None:
            try:
                bundle["quarantine"] = self.quarantine.state(row["host_id"])
            except Exception:  # noqa: BLE001 - capture is best-effort
                bundle["quarantine"] = None
        if self.federation is not None:
            try:
                bundle["pod"] = self.federation.pod_of_host(row["host_id"])
            except Exception:  # noqa: BLE001 - capture is best-effort
                bundle["pod"] = ""
        return bundle

    # -- state store integration: incidents survive a crash --------------

    def export_state(self) -> dict:
        """Incident history + anomaly totals for the scheduler snapshot.
        Per-daemon rings are trimmed to their tail: the full streams are
        fast-moving live telemetry the announce plane rebuilds within a
        few intervals — incident bundles are the part amnesia destroys."""
        return {
            "seq": self.seq,
            "anomaly_counts": dict(self.anomaly_counts),
            "incidents": list(self.incidents),
            "anomalies": list(self.anomalies)[-64:],
            "rings": {hid: list(s.ring)[-8:]
                      for hid, s in self._series.items()},
        }

    def restore(self, state: dict, *, gap_s: float = 0.0) -> int:
        """Refill the incident/anomaly rings from the snapshot. Detector
        baselines deliberately re-warm live (EWMA over a restart gap is
        stale evidence); restored ring tails give /debug/fleet history
        continuity across the failover."""
        n = 0
        self.seq = max(self.seq, int(state.get("seq") or 0))
        for kind, c in (state.get("anomaly_counts") or {}).items():
            if kind in self.anomaly_counts:
                self.anomaly_counts[kind] = max(
                    self.anomaly_counts[kind], int(c))
        for bundle in (state.get("incidents") or []):
            if isinstance(bundle, dict):
                self.incidents.append(bundle)
                n += 1
        for row in (state.get("anomalies") or []):
            if isinstance(row, dict):
                self.anomalies.append(row)
        for hid, tail in (state.get("rings") or {}).items():
            if not isinstance(tail, list):
                continue
            s = self._series.get(hid)
            if s is None:
                s = self._series[hid] = _Series(self.ring)
            for sample in tail:
                if isinstance(sample, dict):
                    s.ring.append(sample)
            n += 1
        _incidents_gauge.set(len(self.incidents))
        _daemons_gauge.set(len(self._series))
        return n

    def state_bytes(self) -> int:
        import sys
        return sum(sys.getsizeof(s.ring) + sys.getsizeof(s.last)
                   for s in self._series.values()) \
            + sys.getsizeof(self.incidents)

    # -- /debug/fleet -----------------------------------------------------

    def snapshot(self, *, compact: bool = False) -> dict:
        """The ``GET /debug/fleet`` payload: fleet rollups over each
        daemon's LATEST sample, active episodes, recent anomalies, and
        the incident ring (ids only when ``compact``; the full bundles
        stay behind the debug port)."""
        now = self.clock()
        latest = [(hid, s.ring[-1]) for hid, s in self._series.items()
                  if s.ring]
        active = [{"host_id": hid, "anomaly": kind,
                   "since_s": round(now - since, 1)}
                  for hid, s in self._series.items()
                  for kind, since in sorted(s.active.items())]
        qos_states: dict[str, int] = {}
        for _, smp in latest:
            qos_states[smp["qos"]] = qos_states.get(smp["qos"], 0) + 1
        fleet = {
            "flight_tasks": sum(smp["flight"] for _, smp in latest),
            "loop_lag_max_ms": round(
                max((smp["lag_ms"] for _, smp in latest), default=0.0), 3),
            "slo_breaches": sum(smp["slo"] for _, smp in latest),
            "escalated_serves": sum(smp["rung_hi"] for _, smp in latest),
            "qos_shed": sum(smp["shed"] for _, smp in latest),
            "corrupt_verdicts": sum(smp["corrupt"] for _, smp in latest),
            "self_quarantined": sum(1 for _, smp in latest if smp["quar"]),
            "qos_states": qos_states,
        }
        out = {
            "daemons": len(self._series),
            "samples": sum(s.samples for s in self._series.values()),
            "ingested": self.ingested,
            "ignored": self.ignored,
            "ring": {"per_daemon": self.ring,
                     "incidents_max": self.incidents.maxlen},
            "fleet": fleet,
            "active": sorted(active, key=lambda a: (a["anomaly"],
                                                    a["host_id"])),
            "anomaly_counts": {k: v for k, v in
                               sorted(self.anomaly_counts.items()) if v},
            "recent_anomalies": list(self.anomalies)[-20:],
            "incidents": len(self.incidents),
        }
        if compact:
            out["incident_ids"] = [b.get("id") for b in
                                   list(self.incidents)[-10:]]
        else:
            out["incident_bundles"] = list(self.incidents)[-10:]
        # recovered-vs-rebuilt provenance (same honesty contract as
        # /debug/ctrl): did this incident history survive a failover?
        if self.statestore is not None:
            out["recovery"] = self.statestore.provenance
        return out


def add_fleet_routes(router, fp: FleetPulse) -> None:
    """``GET /debug/fleet`` on the scheduler launcher's ``--debug-port``
    server, next to ``/debug/cluster`` and ``/debug/ctrl``. ``?compact=1``
    returns incident ids instead of full bundles."""

    async def fleet(_params, query):
        compact = query.get("compact", "") in ("1", "true")
        return 200, fp.snapshot(compact=compact)

    router.add_get("/debug/fleet", fleet)
