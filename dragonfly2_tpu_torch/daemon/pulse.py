"""Pulse digest builder: the daemon's half of the fleet telemetry plane.

Counterpart of ``dragonfly2_tpu/daemon/pulse.py``. Folds counters the
daemon already keeps (the flight ring, served-rung tallies, the health
plane's loop-lag high-water mark and stalls, SLO breaches, storage
occupancy) into one ``PulseDigest`` that the announcer piggybacks on
``AnnounceHost`` and ``AnnounceContent``. No new connections and no new
timers: building it is a handful of attribute reads.

Counters are monotonic since boot; the scheduler differentiates them and
clamps restart resets (``scheduler/fleetpulse.py``). Every read is
getattr-defensive, as in the reference: a daemon wired without some
subsystem still pulses what it has. The verdict ledger gives
``corrupt_verdicts``, ``shunned_parents`` and ``self_quarantined``; the
QoS governor (``daemon/qos.py``) gives ``qos_state`` and ``qos_shed``.
"""

from __future__ import annotations

from ..common import health
from ..idl.messages import PulseDigest


def _slo_breaches(plane) -> int:
    slo = getattr(plane, "slo", None)
    counts = getattr(slo, "_counts", None)
    if not counts:
        return 0
    try:
        return int(sum(counts.values()))
    except Exception:
        return 0


def _corrupt_verdicts(verdicts) -> int:
    parents = getattr(verdicts, "_parents", None)
    if not parents:
        return 0
    total = 0.0
    for p in parents.values():
        codes = getattr(p, "codes", None)
        if codes:
            total += codes.get("corrupt", 0.0)
    return int(total)


def build_pulse(daemon, seq: int) -> PulseDigest:
    """One pulse digest from the daemon's live counters. Pure reads —
    calling this must never perturb the subsystems it observes."""
    plane = health.PLANE
    rec = getattr(daemon, "flight_recorder", None)
    verdicts = getattr(daemon, "verdicts", None)
    qos = getattr(daemon, "qos", None)
    storage = getattr(daemon, "storage_mgr", None)

    flight_tasks = len(getattr(rec, "_tasks", ()) or ())
    rungs = dict(getattr(rec, "rung_tallies", None) or {})

    qos_shed = 0
    shed = (getattr(qos, "counters", None) or {}).get("shed")
    if shed:
        try:
            qos_shed = int(sum(shed.values()))
        except Exception:
            qos_shed = 0

    storage_tasks = 0
    if storage is not None:
        try:
            storage_tasks = len(storage.tasks())
        except Exception:
            storage_tasks = 0

    shunned = getattr(verdicts, "shunned_addrs", None)
    return PulseDigest(
        seq=seq,
        flight_tasks=flight_tasks,
        flight_evicted=int(getattr(rec, "evicted", 0) or 0),
        served_rungs=rungs or None,
        loop_lag_max_ms=float(getattr(plane, "max_lag_s", 0.0)) * 1000.0,
        loop_stalls=int(getattr(plane, "stalls", 0)),
        slo_breaches=_slo_breaches(plane),
        corrupt_verdicts=_corrupt_verdicts(verdicts),
        shunned_parents=len(shunned()) if callable(shunned) else 0,
        self_quarantined=bool(getattr(verdicts, "self_quarantined", False)),
        qos_state=str(getattr(qos, "state", "normal") or "normal"),
        qos_shed=qos_shed,
        storage_tasks=storage_tasks,
    )
