"""Durable scheduler state: the crash-survivable snapshot journal.

Counterpart of ``dragonfly2_tpu/scheduler/statestore.py``: the same
file name, schema version and blob layout, so a snapshot written by
either package restores in the other. Dragonfly2's scheduler keeps every
ruling input in process memory and leans on Redis for nothing but job
queues; a crashed scheduler restarts with amnesia and the cluster pays
for it in re-elections, re-offered poisoners, and an origin stampede.
Here the slow-moving, expensive-to-relearn control state — the
quarantine ladder (minutes of cross-reporter evidence), shard-affinity
memos (whose loss scatters ≥90 %-sticky assignments), federation seed
elections (whose loss re-elects per pod), and the tenant quota table —
is journaled to ONE versioned JSON blob with the ``TaskMetadata.save``
crash-safety idiom: write ``.tmp``, flush, fsync, atomic
rename, fsync the directory. A reader sees the old complete snapshot or
the new complete snapshot, never a torn one.

Deliberately NOT covered: per-peer download FSMs, piece maps, and host
liveness — the announce/register plane rebuilds those within one
announce interval (daemons re-announce held content when they see the
scheduler's epoch change), and persisting them would turn a KB-scale
snapshot into a GB-scale one that is stale the moment it lands.

Cadence is periodic + event-driven: components mark the store dirty on
quarantine/affinity/election transitions (their ledger sinks are
wrapped), and the ticker persists when dirty or when ``interval_s`` has
elapsed. The persist path carries the ``sched.snapshot.io`` faultgate
site (torn / ENOSPC / wedged disk) and swallows EVERY failure into a
counter — a snapshot that cannot land must never block or perturb a
ruling; the next tick retries.

Load refuses wholesale (the PEX schema-refusal guard): a blob
that is not a dict, carries the wrong ``v``, or fails JSON parse is
counted and ignored — never half-applied. Restore hands each component
its own sub-blob plus the wall-clock downtime gap, so evidence decay
keeps running across the outage.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable

from ..common import faultgate
from ..common.metrics import REGISTRY

log = logging.getLogger("df.sched.statestore")

SCHEMA_VERSION = 1
STATE_FILE = "scheduler_state.json"

_snapshots = REGISTRY.counter(
    "df_sched_snapshot_total",
    "scheduler state-snapshot persist attempts, by result", ("result",))
_snapshot_bytes = REGISTRY.gauge(
    "df_sched_snapshot_bytes",
    "size of the last successfully persisted scheduler state snapshot")
_rejected = REGISTRY.counter(
    "df_sched_snapshot_rejected_total",
    "scheduler state snapshots refused wholesale at load, by reason",
    ("reason",))
_recovered = REGISTRY.counter(
    "df_sched_recovery_restored_total",
    "control-plane entries restored from the snapshot at recovery, "
    "by component", ("component",))
_recovery_gap = REGISTRY.gauge(
    "df_sched_recovery_gap_seconds",
    "wall-clock downtime between the recovered snapshot's export and "
    "the restore that loaded it")


class SchedulerStateStore:
    """One snapshot file, many registered components.

    Each component registers an ``export`` (returns a JSON-safe dict)
    and a ``restore`` (takes that dict back, returns entries restored).
    ``wall`` is injectable wall-clock (snapshot age / downtime gap);
    ``clock`` is injectable monotonic (cadence) — dfbench drives both
    virtually so the recovery digest replays byte-identically.
    """

    def __init__(self, directory: str, *, interval_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        self.dir = directory
        self.path = os.path.join(directory, STATE_FILE)
        self.interval_s = interval_s
        self.clock = clock
        self.wall = wall
        self._exports: dict[str, Callable[[], dict]] = {}
        self._restores: dict[str, Callable[..., int]] = {}
        self._dirty = False
        self._last_save = clock()
        # recovered-vs-rebuilt provenance for /debug/ctrl: what the last
        # restore() brought back, per component, plus the downtime gap
        self.provenance: dict[str, Any] = {"recovered": False}

    def register(self, name: str, export: Callable[[], dict],
                 restore: Callable[..., int]) -> None:
        self._exports[name] = export
        self._restores[name] = restore

    # -- event-driven cadence -------------------------------------------

    def mark_dirty(self) -> None:
        """A covered component transitioned (quarantine ruling, shard
        re-assignment, seed (re)election, quota refresh): persist on the
        next tick instead of waiting out the periodic interval."""
        self._dirty = True

    def wrap_sink(self, sink: Callable[[dict], None] | None,
                  ) -> Callable[[dict], None]:
        """Interpose dirty-marking on a component's decision sink — the
        transitions that matter already flow through the ledger hook, so
        the event-driven cadence costs one extra attribute store per
        ruling, not a new wiring surface."""
        def _wrapped(row: dict) -> None:
            self._dirty = True
            if sink is not None:
                sink(row)
        return _wrapped

    def maybe_save(self) -> bool:
        """Ticker body: persist when dirty or when the periodic interval
        elapsed. Never raises."""
        now = self.clock()
        if not self._dirty and now - self._last_save < self.interval_s:
            return False
        return self.save(reason="dirty" if self._dirty else "periodic")

    # -- persist ---------------------------------------------------------

    def save(self, *, reason: str = "explicit") -> bool:
        """Serialize every registered component and land the blob with
        the tmp+fsync+rename idiom. Returns True on success; every
        failure (serialization, injected fault, real disk error) is
        counted and swallowed — rulings must never wait on, or die with,
        a snapshot."""
        try:
            body = {"v": SCHEMA_VERSION, "saved_at": self.wall(),
                    "components": {name: export()
                                   for name, export in self._exports.items()}}
            payload = json.dumps(body, sort_keys=True,
                                 separators=(",", ":")).encode()
            if faultgate.ARMED:
                faultgate.fire_sync("sched.snapshot.io", reason)
                payload = faultgate.corrupt("sched.snapshot.io", payload)
            self._write(payload)
        except Exception as exc:  # noqa: BLE001 - snapshot must not raise
            _snapshots.labels("error").inc()
            log.warning("state snapshot failed (%s): %s — next tick "
                        "retries", reason, exc)
            return False
        self._dirty = False
        self._last_save = self.clock()
        _snapshots.labels("ok").inc()
        _snapshot_bytes.set(len(payload))
        return True

    def _write(self, payload: bytes) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = self.path + ".tmp"
        f = open(tmp, "wb")
        try:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        finally:
            f.close()               # fd released even on a torn write
        os.replace(tmp, self.path)
        try:
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass                    # dir fsync is best-effort (metadata)

    # -- load / restore --------------------------------------------------

    def load(self) -> dict | None:
        """Read + verify the snapshot. Refusal is WHOLESALE (the PEX
        digest-codec rule): wrong version, non-dict, or unparseable JSON
        rejects the entire blob — a half-applied snapshot is worse than
        amnesia, because it looks like knowledge."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        except OSError as exc:
            _rejected.labels("io").inc()
            log.warning("state snapshot unreadable: %s", exc)
            return None
        try:
            body = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            _rejected.labels("parse").inc()
            log.warning("state snapshot refused: torn/corrupt JSON "
                        "(%d bytes)", len(raw))
            return None
        if not isinstance(body, dict) or body.get("v") != SCHEMA_VERSION:
            _rejected.labels("version").inc()
            log.warning("state snapshot refused: schema v%r != v%d",
                        body.get("v") if isinstance(body, dict) else None,
                        SCHEMA_VERSION)
            return None
        return body

    def restore(self) -> dict:
        """Load + hand each component its sub-blob. Components missing
        from the snapshot (older writer) or raising on restore are
        skipped independently — partial recovery of the components that
        DO verify beats discarding the lot. Returns (and retains, for
        /debug/ctrl) the provenance map."""
        body = self.load()
        if body is None:
            self.provenance = {"recovered": False}
            return self.provenance
        gap = max(self.wall() - float(body.get("saved_at", 0.0)), 0.0)
        _recovery_gap.set(round(gap, 3))
        components: dict[str, Any] = {}
        for name, restore in self._restores.items():
            sub = (body.get("components") or {}).get(name)
            if not isinstance(sub, dict):
                components[name] = {"restored": 0, "present": False}
                continue
            try:
                try:
                    n = restore(sub, gap_s=gap)
                except TypeError:
                    n = restore(sub)    # component ignores downtime gap
            except Exception as exc:  # noqa: BLE001 - per-component gate
                log.warning("restore of %s failed: %s — rebuilding live",
                            name, exc)
                components[name] = {"restored": 0, "present": True,
                                    "error": str(exc)}
                continue
            _recovered.labels(name).inc(max(int(n or 0), 0))
            components[name] = {"restored": int(n or 0), "present": True}
        self.provenance = {"recovered": True, "gap_s": round(gap, 3),
                           "components": components}
        log.info("control-plane state recovered (gap %.1fs): %s", gap,
                 {k: v.get("restored") for k, v in components.items()})
        return self.provenance
