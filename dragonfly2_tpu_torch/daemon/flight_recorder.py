"""Download flight recorder: a ring-buffered per-task event journal.

Counterpart of ``dragonfly2_tpu/daemon/flight_recorder.py``, whole: every
piece's lifecycle

    scheduled -> dispatched -> first_byte -> wire_done -> hbm_done

with its parent peer id, source (p2p or origin) and byte counts, the
task-level stages (registered, rungs, placements, shard readiness and
fallbacks, device transfer spans, done), and the serve-side edge rows the
upload server journals. ``summarize`` attributes a finished task
(per-piece stage breakdown, per-parent throughput, slowest piece, tail
latencies, back-to-source ratio); ``compact_summary`` is the form carried
by the terminal ``PeerResult``.

Overhead contract: recording one event is one ``deque.append`` of a
tuple; a flight's events and serves are ring-capped (``max_events``,
``max_serves``, drop-oldest) and the recorder keeps at most ``max_tasks``
flights; while disabled, ``begin()`` returns None and callers hold a None.

Exposure: ``GET /debug/flight`` and ``/debug/flight/<task_id>`` on the
daemon's upload server (``add_flight_routes``), and the compact summary on
the terminal ``PeerResult`` (``scheduler_session.py``). Every summary
carries the health plane's SLO budget verdict (``PLANE.slo.annotate``:
``slo_breaches``, ``slo_budgets_ms``), as the reference's does.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque

from ..common import health
from ..common.metrics import REGISTRY
# the package's one percentile rule: every flight-summary consumer
# (dfbench, the SLO engine, podscope) keys on these exact cut points
from ..common.podscope import _pctl

# flight-ring visibility: operators must be able to tell when max_tasks
# is silently dropping history under churn (the index carries occupancy
# and this counter carries the drops)
_flight_evicted = REGISTRY.counter(
    "df_flight_evicted_total",
    "flights dropped from the recorder ring to admit newer tasks")
_flight_tasks = REGISTRY.gauge(
    "df_flight_tasks", "flights currently held in the recorder ring")
_serve_rows = REGISTRY.counter(
    "df_flight_serve_rows_total",
    "serve-side edge rows journaled by the upload server")

# piece lifecycle stages (strings, interned by the parser — kept short
# because every event tuple carries one)
SCHEDULED = "scheduled"      # dispatcher handed the piece to a worker
DISPATCHED = "dispatched"    # HTTP GET to the parent is about to fire
FIRST_BYTE = "first_byte"    # first body chunk arrived (per request)
WIRE_DONE = "wire_done"      # piece bytes fully on the wire, verified
HBM_DONE = "hbm_done"        # piece staged for the device sink
CORRUPT = "corrupt"          # digest mismatch at landing (parent = sender):
# the piece was requeued; repeated corrupt events from one parent are the
# dfdiag fingerprint of a corrupting peer (bad NIC/disk), and the summary
# counts them per parent so the verdict can name it
# typed transfer-failure kinds (idl.FAIL_CODES minus corrupt, which has
# its own richer event above): one event per failed fetch, parent = the
# failing sender — the summary folds all four into ``fail_codes`` so
# dfdiag and the ledger joins can learn from failure *kind*, not just a
# bare ok=False
STALL = "stall"              # transfer died mid-body (short read/reset)
TIMEOUT = "timeout"          # per-piece deadline fired
REFUSED = "refused"          # parent errored before any payload moved
QUARANTINE = "quarantine"    # the verdict ledger flipped a parent to
# locally shunned DURING this task (parent = the shunned address): the
# journal shows exactly when the immune response engaged, next to the
# corrupt events that triggered it
PLACED = "placed"            # dedupe hit (parent = "cas"): the piece's
# bytes were already on disk under another task's digest and were placed
# locally by the content store — zero wire bytes moved; the summary
# carries these as bytes_placed so podscope can tell a warm pod (origin
# bytes 0 because nothing needed transferring) from a blind one
SHARD_READY = "shard_ready"  # a named manifest shard's bytes all verified
# (parent = shard name, bytes = shard size, piece = source class index
# into SHARD_SRC_NAMES): the moment the shard became eligible to be a
# ready device array — the sharded-task analog of wire_done, and the
# series dfget's per-shard timestamps and the pr14 bench makespan read
SHARD_FALLBACK = "shard_fallback"  # a swap-class piece (a shard assigned
# to a co-located replica's tree fetch) ran out its swap hold and was
# re-pulled from the tree instead (parent = the serving parent): the
# ICI-swap partner died or stalled, and the bounded hold kept the task
# from wedging on it — the sharded analog of a degradation-ladder rung
# task-level stages
REGISTERED = "registered"    # scheduler register returned
HBM_SHARD = "hbm_shard"      # one device DMA completed (piece = shard idx)
DONE = "done"                # task reached a terminal state
RUNG = "rung"                # degradation-ladder transition (parent = rung)
QOS = "qos"                  # QoS admission ruling (parent = governor
# state the task was admitted under: a bulk task that rode the brownout
# queue carries a qos/brownout event, so "why did this pull start late"
# is answerable from the journal — the admission-side analog of a rung)
UPLOAD = "upload"            # serve-side edge row (TaskFlight.serve ring):
# a piece/range THIS daemon served to a child, journaled by the upload
# server so every transfer edge is observed from both ends — podscope
# stitches these against the child's download rows even on the
# scheduler-less pex rung, where no scheduler ever saw the edge

# the conductor's six-rung degradation ladder (docs/RESILIENCE.md): the
# rung event's parent field names which rung the task just entered, so
# dfdiag can show which rung ultimately served a slow task
RUNG_P2P = "p2p"                      # scheduler gave parents; mesh pull
RUNG_RESCHEDULE = "reschedule"        # parents died; waiting re-assignment
RUNG_RING_FAILOVER = "ring_failover"  # hashed scheduler dead; next member
RUNG_PEX = "pex"                      # schedulers gone; gossip-found parents
RUNG_BACK_SOURCE = "back_source"      # fetching from origin
RUNG_FAIL = "fail"                    # ladder exhausted; coded verdict

ORIGIN = ""                  # parent id of a back-to-source fetch

# SHARD_READY source classes, indexed by the event's piece field: which
# path supplied the shard's bytes — the host's own assigned tree fetch,
# or co-located replicas over ICI-near P2P (the shard swap)
SHARD_SRC_NAMES = ("tree", "swap")
SHARD_SRC_TREE, SHARD_SRC_SWAP = 0, 1


class TaskFlight:
    """One task's event journal. Events are ``(t_ms, stage, piece, parent,
    bytes, dur_ms)`` tuples relative to the flight's start."""

    __slots__ = ("task_id", "peer_id", "started_at", "_m0", "events",
                 "serves", "state", "url", "report_drops", "_sum_key",
                 "_sum_cache", "qos_class", "tenant", "shards_total",
                 "on_rung")

    def __init__(self, task_id: str, peer_id: str, *, url: str = "",
                 max_events: int = 4096, max_serves: int = 1024,
                 qos_class: str = "", tenant: str = ""):
        self.task_id = task_id
        self.peer_id = peer_id
        self.url = url
        # QoS attribution: the class rides the summary so the SLO engine
        # can judge this flight against ITS class's budgets and podscope
        # can attribute contention to the tenant that caused it
        self.qos_class = qos_class
        self.tenant = tenant
        self.started_at = time.time()
        self._m0 = time.monotonic()
        self.events: deque = deque(maxlen=max_events)
        # serve-side edge journal (UPLOAD rows): (t_ms, peer, addr, piece,
        # bytes, serve_ms, wait_ms) per range served to a child. A separate
        # ring so a hot seed's thousands of serves can never evict its own
        # download journal, and so the piece-row stage math stays blind to
        # them.
        self.serves: deque = deque(maxlen=max_serves)
        self.state = "running"
        # piece reports dropped because the scheduler stream's writer died
        # (scheduler_session.report_piece) — a silent drop becomes a ghost
        # peer on the scheduler, so the count rides the flight summary
        self.report_drops = 0
        # sharded tasks: how many manifest shards this download tracks
        # (0 = not sharded) — set by the conductor so the summary's
        # shards block can report ready/total without replaying events
        self.shards_total = 0
        self._sum_key: tuple | None = None   # summarize() memo (see there)
        self._sum_cache: dict = {}
        # daemon-wide rung tally hook (FlightRecorder._note_rung): the
        # fleet pulse needs cumulative served-rung counts without a
        # summarize() replay per announce, so rung() tallies through here
        self.on_rung = None

    # -- recording (hot path) ------------------------------------------

    def now_ms(self) -> float:
        return (time.monotonic() - self._m0) * 1000.0

    def event(self, stage: str, piece: int = -1, parent: str = ORIGIN,
              nbytes: int = 0, dur_ms: float = 0.0,
              t_ms: float | None = None) -> None:
        """``t_ms``: explicit timestamp (from now_ms()) for events whose
        moment precedes their recording — a wire_done journaled only once
        the piece verified and landed."""
        self.events.append(
            (self.now_ms() if t_ms is None else t_ms, stage, piece,
             parent, nbytes, dur_ms))

    def finish(self, state: str) -> None:
        self.state = state
        self.event(DONE)

    def rung(self, name: str) -> None:
        """Journal a degradation-ladder transition (RUNG_* constants)."""
        self.event(RUNG, parent=name)
        if self.on_rung is not None:
            self.on_rung(name)

    def serve(self, *, peer: str, addr: str = "", piece: int = -1,
              nbytes: int = 0, serve_ms: float = 0.0,
              wait_ms: float = 0.0, pieces: int = 1,
              relayed: bool = False) -> None:
        """Journal one range served to a child (the UPLOAD edge row).

        ``peer`` is the requesting child's peer id (the ?peerId= on the
        piece GET) and ``addr`` its socket address; ``serve_ms`` covers
        limiter wait + storage read + body transmit (the upload slot's
        hold time), ``wait_ms`` the limiter share of it. ``piece`` is the
        FIRST piece of the range and ``pieces`` how many it spans — a
        grouped span GET is one row, but the parent-side piece count must
        still agree with the child's per-piece rows. ``relayed`` marks a
        cut-through serve (the range streamed against the landing
        watermark, daemon/relay.py) so podscope can surface relay edges
        and their depth. One deque append — same hot-path overhead
        contract as event()."""
        self.serves.append((self.now_ms(), peer, addr, piece, nbytes,
                            serve_ms, wait_ms, pieces, relayed))
        _serve_rows.inc()

    def hbm_spans(self, spans: list) -> None:
        """Adopt a DeviceIngest's completed transfer spans ((monotonic
        start, end) pairs) as shard-level events on this flight's clock."""
        for idx, (t0, t1) in enumerate(spans):
            self.events.append(((t0 - self._m0) * 1000.0, HBM_SHARD, idx,
                                ORIGIN, 0, (t1 - t0) * 1000.0))

    # -- consumption ---------------------------------------------------

    def timeline(self) -> dict:
        return {
            "task_id": self.task_id, "peer_id": self.peer_id,
            "url": self.url, "started_at": self.started_at,
            "state": self.state,
            "events": [{"t_ms": round(t, 3), "stage": stage, "piece": piece,
                        "parent": parent, "bytes": nbytes,
                        "dur_ms": round(dur, 3)}
                       for t, stage, piece, parent, nbytes, dur in
                       self.events],
            "serves": [{"t_ms": round(t, 3), "stage": UPLOAD, "peer": peer,
                        "addr": addr, "piece": piece, "pieces": pieces,
                        "bytes": nbytes,
                        "serve_ms": round(serve, 3),
                        "wait_ms": round(wait, 3),
                        "relayed": relayed}
                       for t, peer, addr, piece, nbytes, serve, wait,
                       pieces, relayed in self.serves],
        }

    def summarize(self) -> dict:
        """Machine-readable attribution: per-piece stage breakdown,
        per-parent throughput, slowest piece + its dominant stage, tail
        latencies, back-to-source ratio.

        Memoized on (event count, state): a finished task is summarized
        at least twice back-to-back (SLO accounting at conductor finish,
        then the compact PeerResult form), and the O(events) walk need
        not run twice. Returns a shallow copy so consumers may del/replace
        top-level keys (compact_summary does)."""
        # last event rides the key: a ring at maxlen keeps a constant
        # length while events churn, so length alone would serve a stale
        # mid-flight summary from the HTTP surface
        key = (len(self.events), self.state, self.report_drops,
               self.events[-1] if self.events else None,
               len(self.serves), self.serves[-1] if self.serves else None,
               self.shards_total)
        if key == self._sum_key:
            return dict(self._sum_cache)
        pieces: dict[int, dict] = {}
        parents: dict[str, dict] = {}
        rungs: list[str] = []
        corrupt: dict[str, int] = {}
        fail_codes: dict[str, int] = {}
        quarantined: list[str] = []
        hbm_dma_ms = 0.0
        placed_pieces = 0
        bytes_placed = 0
        shard_rows: list[dict] = []
        shard_fallbacks = 0
        for t, stage, piece, parent, nbytes, dur in self.events:
            if stage == HBM_SHARD:
                hbm_dma_ms += dur
                continue
            if stage == SHARD_READY:
                src = (SHARD_SRC_NAMES[piece]
                       if 0 <= piece < len(SHARD_SRC_NAMES) else "tree")
                shard_rows.append({"name": parent, "src": src,
                                   "t_ms": round(t, 3), "bytes": nbytes})
                continue
            if stage == SHARD_FALLBACK:
                shard_fallbacks += 1
                continue
            if stage == PLACED:
                # content-store placements moved zero wire bytes: counted
                # apart from p2p/source so origin accounting stays honest
                placed_pieces += 1
                bytes_placed += nbytes
                continue
            if stage == CORRUPT:
                corrupt[parent] = corrupt.get(parent, 0) + 1
                fail_codes[CORRUPT] = fail_codes.get(CORRUPT, 0) + 1
                continue
            if stage in (STALL, TIMEOUT, REFUSED):
                fail_codes[stage] = fail_codes.get(stage, 0) + 1
                continue
            if stage == QUARANTINE:
                if parent not in quarantined:
                    quarantined.append(parent)
                continue
            if stage == RUNG:
                # dedupe consecutive repeats (reschedule can re-fire while
                # the same outage is still in progress)
                if not rungs or rungs[-1] != parent:
                    rungs.append(parent)
                continue
            if piece < 0:
                continue
            p = pieces.setdefault(piece, {})
            if stage == WIRE_DONE:
                p[WIRE_DONE] = t
                p["bytes"] = nbytes
                p["parent"] = parent
                p["wire_dur"] = dur
            elif stage == HBM_DONE:
                p[HBM_DONE] = t
            else:
                # pre-wire stages keyed by parent: endgame racers journal
                # their own attempts, and only the entries of the parent
                # that actually delivered (the WIRE_DONE one) are read at
                # row-build time — a loser can never rewrite the winner's
                # stage history, whichever order their events landed
                p.setdefault(stage, {})[parent] = t
        piece_rows = []
        for num in sorted(pieces):
            p = pieces[num]
            wire_end = p.get(WIRE_DONE)
            if wire_end is None:
                continue
            winner = p.get("parent", ORIGIN)
            # pieces that skipped the dispatcher (back-source) carry their
            # measured duration on the wire_done event: back-date the start
            sched = (p.get(SCHEDULED) or {}).get(winner)
            if sched is None:
                sched = wire_end - p.get("wire_dur", 0.0)
            disp = (p.get(DISPATCHED) or {}).get(winner, sched)
            first = (p.get(FIRST_BYTE) or {}).get(winner)
            if first is None:
                # grouped-span members get no first_byte of their own:
                # back-date from the per-piece duration so wire_ms is this
                # piece's transfer share, not the whole span window
                first = max(disp, wire_end - p.get("wire_dur", 0.0))
            hbm = p.get(HBM_DONE, wire_end)
            stages = {
                "queue_ms": max(disp - sched, 0.0),
                "ttfb_ms": max(first - disp, 0.0),
                "wire_ms": max(wire_end - first, 0.0),
                "hbm_ms": max(hbm - wire_end, 0.0),
            }
            total = wire_end - sched + stages["hbm_ms"]
            parent = winner
            row = {"piece": num, "parent": parent,
                   "source": "origin" if parent == ORIGIN else "p2p",
                   "bytes": p.get("bytes", 0),
                   "start_ms": round(sched, 3),
                   "total_ms": round(total, 3),
                   **{k: round(v, 3) for k, v in stages.items()}}
            piece_rows.append(row)
            # accrued from the DEDUPED piece table, not per event (endgame
            # duplicates must not inflate a parent), and from wire time
            # only — folding ttfb in would divide a span-serving parent's
            # throughput by its group size and flag it as a straggler
            pp = parents.setdefault(
                parent, {"bytes": 0, "pieces": 0, "wire_ms": 0.0})
            pp["bytes"] += row["bytes"]
            pp["pieces"] += 1
            pp["wire_ms"] += stages["wire_ms"]
        for pp in parents.values():
            ms = pp["wire_ms"]
            pp["wire_ms"] = round(ms, 3)
            pp["throughput_bps"] = (
                round(pp["bytes"] / (ms / 1000.0)) if ms > 0 else 0)
        # serve-side edges, aggregated per requesting child: the parent
        # half of every transfer edge (podscope joins this against the
        # child's piece rows to confirm the edge from both ends)
        uploads: dict[str, dict] = {}
        for _t, peer, addr, _piece, nbytes, serve, wait, npieces, \
                relayed in self.serves:
            up = uploads.setdefault(peer or addr, {
                "addr": addr, "bytes": 0, "pieces": 0,
                "serve_ms": 0.0, "wait_ms": 0.0, "relayed_pieces": 0})
            up["bytes"] += nbytes
            up["pieces"] += npieces
            up["serve_ms"] += serve
            up["wait_ms"] += wait
            if relayed:
                up["relayed_pieces"] += npieces
        for up in uploads.values():
            ms = up["serve_ms"]
            up["serve_ms"] = round(ms, 3)
            up["wait_ms"] = round(up["wait_ms"], 3)
            up["serve_bps"] = (round(up["bytes"] / (ms / 1000.0))
                               if ms > 0 else 0)
        totals = sorted(r["total_ms"] for r in piece_rows)
        slowest = max(piece_rows, key=lambda r: r["total_ms"],
                      default=None)
        summary = {
            "task_id": self.task_id, "peer_id": self.peer_id,
            "state": self.state,
            "pieces": len(piece_rows),
            "bytes_p2p": sum(r["bytes"] for r in piece_rows
                             if r["source"] == "p2p"),
            "bytes_source": sum(r["bytes"] for r in piece_rows
                                if r["source"] == "origin"),
            "bytes_placed": bytes_placed,
            "placed_pieces": placed_pieces,
            "per_parent": parents,
            "uploads": uploads,
            "bytes_served": sum(u["bytes"] for u in uploads.values()),
            "tail_ms": {"p50": _pctl(totals, 0.50),
                        "p90": _pctl(totals, 0.90),
                        "p99": _pctl(totals, 0.99)},
            "hbm_dma_ms": round(hbm_dma_ms, 3),
            # the degradation-ladder trail and the rung the task ended on —
            # dfdiag's verdict names it so "why did this go to origin"
            # never needs log spelunking
            "rungs": rungs,
            "served_rung": rungs[-1] if rungs else "",
            # QoS attribution ("" = pre-QoS / classless): the SLO engine
            # scales stage budgets by this class, dfdiag names it
            "qos_class": self.qos_class,
            "tenant": self.tenant,
            "report_drops": self.report_drops,
            # digest-mismatched transfers per sending parent (the piece
            # itself was requeued and its eventual row credits whoever
            # delivered the good copy)
            "corrupt_pieces": corrupt,
            # typed failure tallies (FAIL_CODES) across the whole flight:
            # what KIND of failures this download absorbed — the wasted-
            # work attribution the quarantine plane is judged by
            "fail_codes": fail_codes,
            # parent addresses the local verdict ledger shunned during
            # this task (the `quarantine` events): dfdiag names them
            "quarantined_parents": quarantined,
            "piece_rows": piece_rows,
        }
        if self.shards_total or shard_rows:
            # sharded-task readiness: one row per completed shard (name,
            # tree vs swap, ready timestamp) plus the slowest — what
            # dfdiag's verdict and podscope's per-task shards line read
            shards: dict = {
                "total": self.shards_total or len(shard_rows),
                "ready": len(shard_rows),
                "tree_bytes": sum(r["bytes"] for r in shard_rows
                                  if r["src"] == "tree"),
                "swap_bytes": sum(r["bytes"] for r in shard_rows
                                  if r["src"] == "swap"),
                "fallbacks": shard_fallbacks,
                "rows": shard_rows,
            }
            if shard_rows:
                shards["slowest"] = max(shard_rows,
                                        key=lambda r: r["t_ms"])
            summary["shards"] = shards
        total_bytes = summary["bytes_p2p"] + summary["bytes_source"]
        summary["back_to_source_ratio"] = (
            round(summary["bytes_source"] / total_bytes, 4)
            if total_bytes else 0.0)
        # the per-stage SLO budget verdict rides every summary surface
        # (HTTP, the compact PeerResult form): pure annotation; the breach
        # counters are counted once per task by the conductor
        health.PLANE.slo.annotate(summary)
        if slowest is not None:
            stage = max(("queue_ms", "ttfb_ms", "wire_ms", "hbm_ms"),
                        key=lambda k: slowest[k])
            summary["slowest_piece"] = {
                "piece": slowest["piece"], "parent": slowest["parent"],
                "total_ms": slowest["total_ms"],
                "dominant_stage": stage.removesuffix("_ms"),
                "dominant_ms": slowest[stage]}
        self._sum_key, self._sum_cache = key, summary
        return dict(summary)

    def compact_summary(self, *, max_parents: int = 8) -> dict:
        """The wire form attached to the terminal PeerResult: the summary
        minus per-piece rows, parents capped to the heaviest few (a
        1000-piece task must not ship a 1000-row report)."""
        s = self.summarize()
        del s["piece_rows"]
        if "shards" in s:
            # same cap rationale as piece_rows: a 1000-shard checkpoint
            # must not ship a 1000-row report — keep the latest-ready few
            # (the tail that sets time-to-serving), totals stay exact
            sh = dict(s["shards"])
            sh["rows"] = sorted(sh["rows"], key=lambda r: r["t_ms"],
                                reverse=True)[:max_parents]
            s["shards"] = sh
        parents = sorted(s["per_parent"].items(),
                         key=lambda kv: kv[1]["bytes"], reverse=True)
        s["per_parent"] = dict(parents[:max_parents])
        uploads = sorted(s["uploads"].items(),
                         key=lambda kv: kv[1]["bytes"], reverse=True)
        s["uploads"] = dict(uploads[:max_parents])
        return s


class FlightRecorder:
    """Daemon-wide registry of TaskFlights, ring-capped on task count."""

    def __init__(self, *, enabled: bool = True, max_tasks: int = 64,
                 max_events: int = 4096, max_serves: int = 1024):
        self.enabled = enabled
        self.max_tasks = max_tasks
        self.max_events = max_events
        self.max_serves = max_serves
        # flights dropped to admit newer tasks since boot — surfaced in
        # the /debug/flight index so an operator can tell a quiet pod
        # from one whose history is churning out of the ring
        self.evicted = 0
        # cumulative served-rung tallies since boot (rung name -> count):
        # flights tally through on_rung at transition time so the fleet
        # pulse reads a dict, never replays journals; survives flight
        # eviction (the ring caps history, not the counters)
        self.rung_tallies: dict[str, int] = {}
        self._tasks: OrderedDict[str, TaskFlight] = OrderedDict()

    def _note_rung(self, name: str) -> None:
        self.rung_tallies[name] = self.rung_tallies.get(name, 0) + 1

    def begin(self, task_id: str, peer_id: str, url: str = "",
              qos_class: str = "", tenant: str = "") -> TaskFlight | None:
        """Open (or reopen) a flight; None while disabled so callers hold
        a None and the hot path never calls back in."""
        if not self.enabled:
            return None
        # the upload port is mesh-reachable and the flight surface is not
        # auth-gated: strip the query string (presigned-URL credentials)
        # before the URL becomes queryable debug state
        flight = TaskFlight(task_id, peer_id, url=url.split("?", 1)[0],
                            max_events=self.max_events,
                            max_serves=self.max_serves,
                            qos_class=qos_class, tenant=tenant)
        flight.on_rung = self._note_rung
        self._tasks[task_id] = flight
        self._tasks.move_to_end(task_id)
        while len(self._tasks) > self.max_tasks:
            self._tasks.popitem(last=False)
            self.evicted += 1
            _flight_evicted.inc()
        _flight_tasks.set(len(self._tasks))
        return flight

    def serving(self, task_id: str, peer_id: str = "") -> TaskFlight | None:
        """Get-or-create the flight a serve row lands on. A daemon that
        downloaded the task journals serves onto its download flight (one
        surface per task); a daemon serving content it never downloaded
        here — a restarted seed re-seeded from disk — gets a fresh flight
        in state 'serving' so its edges are still observable.

        Serve traffic must NEVER evict a download flight: a seed holding
        more tasks than ``max_tasks`` would otherwise churn its own
        in-flight download journals out of the ring with every fan-out.
        A serve-only flight is admitted by evicting the oldest OTHER
        serve-only flight; with the ring full of download flights it is
        simply not journaled (the child side still observes the edge)."""
        if not self.enabled:
            return None
        flight = self._tasks.get(task_id)
        if flight is not None:
            return flight            # no move_to_end: serves don't renew
        if len(self._tasks) >= self.max_tasks:
            victim = next((tid for tid, f in self._tasks.items()
                           if f.state == "serving"), None)
            if victim is None:
                return None
            del self._tasks[victim]
            self.evicted += 1
            _flight_evicted.inc()
        flight = TaskFlight(task_id, peer_id,
                            max_events=self.max_events,
                            max_serves=self.max_serves)
        flight.on_rung = self._note_rung
        flight.state = "serving"
        self._tasks[task_id] = flight
        _flight_tasks.set(len(self._tasks))
        return flight

    def get(self, task_id: str) -> TaskFlight | None:
        return self._tasks.get(task_id)

    def index(self) -> list[dict]:
        return [{"task_id": f.task_id, "state": f.state,
                 "started_at": f.started_at, "events": len(f.events),
                 "serves": len(f.serves)}
                for f in self._tasks.values()]


def add_flight_routes(router, recorder: FlightRecorder) -> None:
    """``GET /debug/flight`` (index) and ``/debug/flight/{task_id}``
    (``?summary=1`` for the attribution summary instead of the raw
    timeline). ``router`` is the upload server's (``add_get(path,
    handler)``; a handler takes the path parameters and the query and
    returns ``(status, json body)``). Read-only and ring-bounded, so
    served like ``/healthy`` rather than behind a flag."""

    async def flight_index(_params: dict, _query: dict) -> tuple[int, dict]:
        # ring visibility: occupancy against max_tasks and the eviction
        # count (evicted > 0 with a full ring: history is being dropped)
        return 200, {"enabled": recorder.enabled,
                     "max_tasks": recorder.max_tasks,
                     "occupancy": len(recorder._tasks),
                     "evicted_total": recorder.evicted,
                     "tasks": recorder.index()}

    async def flight_one(params: dict, query: dict) -> tuple[int, dict]:
        task_id = params["task_id"]
        flight = recorder.get(task_id)
        if flight is None:
            # prefix match: operators paste truncated ids from logs
            matches = [f for tid, f in recorder._tasks.items()
                       if tid.startswith(task_id)]
            if len(matches) != 1:
                return 404, {"error": f"no flight for {task_id}"}
            flight = matches[0]
        if query.get("summary"):
            return 200, flight.summarize()
        body = flight.timeline()
        body["summary"] = flight.summarize()
        return 200, body

    router.add_get("/debug/flight", flight_index)
    router.add_get("/debug/flight/{task_id}", flight_one)
