"""Pod-wide peer quarantine registry: the scheduler half of the swarm
immune system.

Counterpart of ``dragonfly2_tpu/scheduler/quarantine.py``: the same
ladder, constants, decision rows and durable-state format, so a verdict
stream on one clock gives the same states in both packages and either
package restores the other's ``export_state``. Dragonfly2's scheduler sees a failed
piece as a generic ``ok=False``, blocklists the pair for ten seconds, and
keeps offering the same host to everyone else; its only long-term ejector
(``IsBadNode``) is per-task statistical *slowness*, which a bit-rotted or
byzantine daemon serving corrupt bytes at full speed never trips. This
registry promotes HARD evidence — typed ``corrupt`` verdicts
(``PieceResult.fail_code``), aggregated per HOST across every task and
reporter, plus a daemon's own self-quarantine flag — into an explicit
per-host ladder:

    healthy ──corrupt verdict──▶ suspect ──≥ threshold──▶ quarantined
       ▲                                                      │
       │◀──probe successes── probation ◀──probation delay─────┘

* **healthy** — offerable everywhere (the default; unknown hosts never
  allocate registry state).
* **suspect** — some decayed corrupt evidence, below the threshold:
  still offerable (the evaluator/blocklist handle it), but counted.
* **quarantined** — evidence reached ``corrupt_threshold`` (or the host
  self-quarantined): excluded from offers (``EXCLUSION_REASONS``
  ``quarantined``), relay-tree shaping, and seed election, pod-wide.
* **probation** — ``probation_delay_s`` after the last evidence, the
  host earns bounded reprieve probes: it may be offered to at most
  ``probe_children`` concurrent children (one low-stakes piece each).
  ``probe_successes`` clean verdicts climb it back to healthy without an
  operator; one more corrupt verdict sends it straight back to
  quarantined with the timer reset.

Every transition is emitted as a ``kind=decision`` row
(``decision_kind="quarantine"``) through the same sink the scheduling
ledger uses, so rulings are replayable offline (dfsched / the records
JSONL) and visible live at ``/debug/decisions``.

Evidence decays (half-life) on an injectable clock, so the registry is a
pure deterministic function of (verdict stream, clock) — dfbench drives
it on a virtual clock and its ``--pr12`` numbers replay byte-identically.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from ..common.metrics import REGISTRY

log = logging.getLogger("df.sched.quarantine")

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"
STATES = (HEALTHY, SUSPECT, QUARANTINED, PROBATION)

_transitions = REGISTRY.counter(
    "df_quarantine_transitions_total",
    "quarantine-ladder state transitions, by the state entered", ("to",))
_hosts_gauge = REGISTRY.gauge(
    "df_quarantine_hosts",
    "hosts currently in each non-healthy quarantine-ladder state",
    ("state",))
_evidence = REGISTRY.counter(
    "df_quarantine_verdicts_total",
    "corrupt piece verdicts recorded as quarantine evidence")
_probes = REGISTRY.counter(
    "df_quarantine_probes_total",
    "probation reprieve-probe outcomes", ("result",))


class _HostLadder:
    __slots__ = ("state", "corrupt", "relayed", "at", "reporters", "tasks",
                 "last_evidence", "entered_at", "probe_children",
                 "probe_ok", "self_flagged", "reason")

    def __init__(self, now: float) -> None:
        self.state = HEALTHY
        self.corrupt = 0.0            # decayed DIRECT corrupt-verdict mass
        self.relayed = 0.0            # decayed cut-through corrupt mass:
        # circumstantial (the bytes originated upstream of this host) —
        # reaches `suspect`, NEVER `quarantined` on its own
        self.at = now                 # decay anchor
        self.reporters: set[str] = set()
        self.tasks: set[str] = set()
        self.last_evidence = now
        self.entered_at = now         # when the current state was entered
        # children currently granted a probe slot -> grant time: a
        # grant EXPIRES if the child never actually fetches from the
        # host (its dispatcher may simply prefer other parents), or a
        # stuck grant would hold the bounded probe budget forever and
        # the host could never be reprieved (found by the live drive)
        self.probe_children: dict[str, float] = {}
        self.probe_ok = 0
        self.self_flagged = False
        self.reason = ""

    def decay(self, now: float, halflife_s: float) -> None:
        if halflife_s > 0:
            factor = 0.5 ** (max(now - self.at, 0.0) / halflife_s)
            self.corrupt *= factor
            self.relayed *= factor
            if self.corrupt < 0.01:
                self.corrupt = 0.0
            if self.relayed < 0.01:
                self.relayed = 0.0
        self.at = now


class QuarantineRegistry:
    """Per-host quarantine ladder with decision-ledger emission.

    ``sink`` receives one ``kind=decision`` row per transition (the
    scheduler wires the DecisionLedger's ``on_decision``); ``clock`` is
    injectable so dfbench replays the ladder on its virtual clock.
    """

    def __init__(self, *, corrupt_threshold: float = 3.0,
                 halflife_s: float = 600.0,
                 probation_delay_s: float = 30.0,
                 probe_successes: int = 2,
                 probe_children: int = 1,
                 min_reporters: int = 2,
                 sink: Callable[[dict], None] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.corrupt_threshold = corrupt_threshold
        self.halflife_s = halflife_s
        self.probation_delay_s = probation_delay_s
        self.probe_successes = probe_successes
        self.probe_children = probe_children
        # the report-plane anti-slander rule: the QUARANTINED transition
        # needs corrupt evidence from at least this many DISTINCT
        # reporting hosts — one faulty (bad RAM on its receive side) or
        # byzantine CHILD forging corrupt reports must not be able to
        # serially evict the pod's honest parents; a single reporter
        # tops out at `suspect`. Reporterless verdicts (offline tools,
        # sims) count as one anonymous reporter. Probation regression is
        # exempt (the host carries a prior multi-reporter conviction).
        self.min_reporters = max(1, min_reporters)
        self.sink = sink
        self.clock = clock
        self._hosts: dict[str, _HostLadder] = {}
        self._seq = 0

    # -- transitions ---------------------------------------------------

    def _get(self, host_id: str) -> _HostLadder:
        h = self._hosts.get(host_id)
        if h is None:
            h = self._hosts[host_id] = _HostLadder(self.clock())
        return h

    def _transit(self, host_id: str, h: _HostLadder, to: str,
                 why: str) -> None:
        frm = h.state
        if frm == to:
            return
        h.state = to
        h.entered_at = self.clock()
        h.probe_children.clear()
        h.probe_ok = 0
        _transitions.labels(to).inc()
        self._export()
        log.warning("quarantine: host %s %s -> %s (%s)", host_id[-28:],
                    frm, to, why)
        if self.sink is not None:
            self._seq += 1
            self.sink({
                "kind": "decision",
                "decision_kind": "quarantine",
                "decision_id": f"q{self._seq:08d}.{host_id[-12:]}",
                "host_id": host_id,
                "from_state": frm,
                "to_state": to,
                "why": why,
                "corrupt_evidence": round(h.corrupt, 3),
                "reporters": sorted(h.reporters),
                "tasks": len(h.tasks),
                "self_flagged": h.self_flagged,
                # the scheduling rows' fields, empty, so every ledger
                # consumer (stitch, dfsched, /debug/decisions filters)
                # reads quarantine rulings without special cases
                "task_id": "",
                "peer_id": "",
                "candidates": [],
                "excluded": [],
                "chosen": [],
            })

    def _export(self) -> None:
        counts = {s: 0 for s in STATES if s != HEALTHY}
        for h in self._hosts.values():
            if h.state != HEALTHY:
                counts[h.state] += 1
        for state, n in counts.items():
            _hosts_gauge.labels(state).set(n)

    # -- evidence (called from the piece-report path) -------------------

    def record_corrupt(self, host_id: str, *, task_id: str = "",
                       reporter: str = "", relayed: bool = False) -> None:
        """One verified ``corrupt`` piece verdict against ``host_id``
        (cross-task, cross-reporter — the evidence the ladder promotes).

        ``relayed`` (PieceResult.relayed — the transfer rode the host's
        cut-through path): CIRCUMSTANTIAL, kept in its own counter that
        can reach `suspect` but NEVER `quarantined` — the bytes
        originated upstream of the relay, and promoting relayed mass
        would let one poisoner get every honest relay below it evicted
        (a sophisticated host that poisons ONLY its cut-through windows
        evades eviction but stays suspect/deprioritized, and the moment
        it serves corrupt bytes from disk it earns direct evidence)."""
        if not host_id:
            return
        _evidence.inc()
        now = self.clock()
        h = self._get(host_id)
        h.decay(now, self.halflife_s)
        if task_id:
            h.tasks.add(task_id)
        if reporter:
            h.reporters.add(reporter)
        if relayed:
            h.relayed += 1.0
            if h.state == HEALTHY:
                self._transit(host_id, h, SUSPECT,
                              "relayed-corruption evidence (suspect "
                              "ceiling: circumstantial)")
            return
        h.corrupt += 1.0
        h.last_evidence = now
        if h.state == PROBATION:
            # a probed host that serves corruption again goes straight
            # back — with the timer reset, not a fresh evidence budget
            _probes.labels("corrupt").inc()
            self._transit(host_id, h, QUARANTINED,
                          "corrupt verdict during probation")
        elif h.corrupt >= self.corrupt_threshold \
                and max(len(h.reporters), 1) >= self.min_reporters:
            if h.state != QUARANTINED:
                self._transit(host_id, h, QUARANTINED,
                              f"{h.corrupt:.1f} decayed corrupt verdicts "
                              f"from {len(h.reporters)} reporter(s) over "
                              f"{len(h.tasks)} task(s)")
        elif h.state == HEALTHY:
            self._transit(host_id, h, SUSPECT,
                          "first corrupt verdict (below threshold)")

    def record_ok(self, host_id: str) -> None:
        """A successful piece served by ``host_id``: in probation this is
        a reprieve-probe pass; elsewhere it is just decay time passing."""
        h = self._hosts.get(host_id)
        if h is None:
            return
        if h.state == PROBATION:
            h.probe_ok += 1
            _probes.labels("ok").inc()
            if h.probe_ok >= self.probe_successes:
                h.corrupt = 0.0
                h.reporters.clear()
                h.tasks.clear()
                self._transit(host_id, h, HEALTHY,
                              f"{h.probe_ok} clean probe piece(s)")
        elif h.state == SUSPECT:
            h.decay(self.clock(), self.halflife_s)
            if h.corrupt <= 0.0 and h.relayed <= 0.0:
                self._transit(host_id, h, HEALTHY, "evidence decayed")

    def record_self(self, host_id: str, flagged: bool,
                    *, reason: str = "") -> None:
        """The host's own register/announce carried (or cleared) the
        ``Host.quarantined`` self-flag — first-hand evidence from the
        daemon itself (boot re-verify / placement re-hash failed)."""
        if not host_id:
            return
        if flagged:
            h = self._get(host_id)
            h.self_flagged = True
            h.reason = reason or "self-quarantine flag on announce"
            h.last_evidence = self.clock()
            if h.state != QUARANTINED:
                self._transit(host_id, h, QUARANTINED, h.reason)
            return
        h = self._hosts.get(host_id)
        if h is not None and h.self_flagged:
            # the flag cleared (daemon restarted and re-verified clean):
            # the host still walks back through probation like everyone
            # else — a clean boot says nothing about the bytes it serves
            h.self_flagged = False
            if h.state == QUARANTINED:
                self._transit(host_id, h, PROBATION,
                              "self-quarantine flag cleared")

    # -- queries (the scheduling filter / seed election) ----------------

    def state(self, host_id: str) -> str:
        """Current ladder state, with the lazy quarantine→probation
        promotion applied (time-based: no ticker to wire or leak)."""
        h = self._hosts.get(host_id)
        if h is None:
            return HEALTHY
        if (h.state == QUARANTINED and not h.self_flagged
                and self.clock() - h.last_evidence
                >= self.probation_delay_s):
            self._transit(host_id, h, PROBATION,
                          f"{self.probation_delay_s:.0f}s without fresh "
                          f"evidence")
        return h.state

    def offerable(self, host_id: str, child_id: str = "") -> bool:
        """May ``host_id`` be offered as a parent to ``child_id``?

        healthy/suspect: yes. quarantined: no. probation: only within
        the bounded probe budget — at most ``probe_children`` concurrent
        children get it (one low-stakes exposure each); everyone else
        keeps being steered around it until the probes settle it."""
        st = self.state(host_id)
        if st in (HEALTHY, SUSPECT):
            return True
        if st == QUARANTINED:
            return False
        h = self._hosts[host_id]
        now = self.clock()
        for cid in [c for c, at in h.probe_children.items()
                    if now - at > self.probation_delay_s]:
            del h.probe_children[cid]      # expired grant frees the slot
        if child_id and child_id in h.probe_children:
            return True
        if len(h.probe_children) < self.probe_children:
            if child_id:
                h.probe_children[child_id] = now
            return True
        return False

    def quarantined_hosts(self) -> list[str]:
        return sorted(hid for hid in self._hosts
                      if self.state(hid) == QUARANTINED)

    # -- debug surface ---------------------------------------------------

    def state_bytes(self) -> int:
        """Bytes of quarantine state (per-host ladders, evidence sets)
        for the /debug/ctrl bytes-per-peer accounting. Deep sizeof walk
        — snapshot cadence only, never on a ruling path."""
        from ..common.sizeof import deep_sizeof
        return deep_sizeof(self._hosts)

    def snapshot(self) -> dict:
        now = self.clock()
        hosts = {}
        for hid, h in self._hosts.items():
            st = self.state(hid)
            if st == HEALTHY and h.corrupt <= 0.0 and h.relayed <= 0.0:
                continue              # fully recovered: no row to read
            h.decay(now, self.halflife_s)
            hosts[hid] = {
                "state": st,
                "corrupt_evidence": round(h.corrupt, 3),
                "relayed_evidence": round(h.relayed, 3),
                "reporters": len(h.reporters),
                "tasks": len(h.tasks),
                "self_flagged": h.self_flagged,
                "probe_ok": h.probe_ok,
                "probing_children": len(h.probe_children),
                "since_s": round(max(now - h.entered_at, 0.0), 1),
            }
        return {
            "corrupt_threshold": self.corrupt_threshold,
            "probation_delay_s": self.probation_delay_s,
            "probe_successes": self.probe_successes,
            "hosts": hosts,
        }

    # -- durable state (scheduler/statestore.py) -------------------------

    def export_state(self) -> dict:
        """The crash-survivable half of the ladder, decayed to now and
        anchored in AGES (seconds before the export), never in absolute
        monotonic stamps — a restarted process has a different monotonic
        origin, and the statestore adds the wall-clock downtime gap on
        restore so decay keeps running while the scheduler is down."""
        now = self.clock()
        hosts = {}
        for hid, h in self._hosts.items():
            h.decay(now, self.halflife_s)
            if h.state == HEALTHY and h.corrupt <= 0.0 and h.relayed <= 0.0:
                continue              # fully recovered: nothing to carry
            hosts[hid] = {
                "state": h.state,
                "corrupt": round(h.corrupt, 6),
                "relayed": round(h.relayed, 6),
                "reporters": sorted(h.reporters),
                "tasks": sorted(h.tasks),
                "last_evidence_age_s": round(max(now - h.last_evidence,
                                                 0.0), 3),
                "entered_age_s": round(max(now - h.entered_at, 0.0), 3),
                "probe_ok": h.probe_ok,
                "self_flagged": h.self_flagged,
                "reason": h.reason,
            }
        return {"seq": self._seq, "hosts": hosts}

    def restore(self, state: dict, *, gap_s: float = 0.0) -> int:
        """Rebuild the ladder from :meth:`export_state` output. ``gap_s``
        is the wall-clock downtime between export and now: evidence ages
        by ``age + gap`` so the lazy decay arithmetic lands exactly where
        an uninterrupted registry would (a suspect whose evidence crosses
        the decay horizon during the outage comes back HEALTHY — its
        entry is simply dropped, unknown hosts being healthy by default).

        QUARANTINED hosts are the one deliberate exception: their
        probation timer restarts at recovery (``last_evidence = now``)
        instead of aging through the gap — no probe could possibly have
        run while the brain was down, and a poisoner must never walk
        itself into offerable probation on the strength of the
        scheduler's own outage. Restores are silent (no ledger rows, no
        transition counters): nothing here is a fresh ruling."""
        now = self.clock()
        gap = max(float(gap_s), 0.0)
        restored = 0
        for hid, row in (state.get("hosts") or {}).items():
            h = _HostLadder(now)
            h.state = row.get("state", SUSPECT)
            if h.state not in STATES:
                continue
            h.corrupt = float(row.get("corrupt", 0.0))
            h.relayed = float(row.get("relayed", 0.0))
            # the export decayed evidence to export time; anchoring the
            # decay clock `gap` in the past makes the next decay() charge
            # the downtime too
            h.at = now - gap
            h.decay(now, self.halflife_s)
            h.reporters = set(row.get("reporters") or ())
            h.tasks = set(row.get("tasks") or ())
            h.probe_ok = int(row.get("probe_ok", 0))
            h.self_flagged = bool(row.get("self_flagged", False))
            h.reason = row.get("reason", "")
            if h.state == QUARANTINED:
                h.last_evidence = now
                h.entered_at = now
            else:
                h.last_evidence = now - (
                    float(row.get("last_evidence_age_s", 0.0)) + gap)
                h.entered_at = now - (
                    float(row.get("entered_age_s", 0.0)) + gap)
                if h.state == SUSPECT and h.corrupt <= 0.0 \
                        and h.relayed <= 0.0:
                    continue          # decayed across the outage: healthy
            self._hosts[hid] = h
            restored += 1
        self._seq = max(self._seq, int(state.get("seq", 0)))
        self._export()
        return restored

    def import_summary(self, state: dict, *, source: str = "") -> int:
        """Failover handoff import — the anti-slander rule applied
        to second-hand state: a demoted scheduler's exported summary
        warms the successor's ladder to at most SUSPECT. Imported mass
        lands in the RELAYED (circumstantial) counter, which by
        construction can never cross into QUARANTINED — only fresh
        first-hand corrupt reports arriving at THIS scheduler can evict.
        Reporter identities are deliberately not imported (carrying them
        over would let a forged blob pre-stage ``min_reporters``)."""
        imported = 0
        now = self.clock()
        for hid, row in (state.get("hosts") or {}).items():
            mass = float(row.get("corrupt", 0.0)) \
                + float(row.get("relayed", 0.0))
            if mass <= 0.0 and row.get("state") == HEALTHY:
                continue
            h = self._get(hid)
            h.decay(now, self.halflife_s)
            h.relayed += min(mass, self.corrupt_threshold) or 1.0
            if h.state == HEALTHY:
                self._transit(hid, h, SUSPECT,
                              f"imported verdict from {source or 'peer'} "
                              "(anti-slander: suspect ceiling)")
            imported += 1
        return imported
