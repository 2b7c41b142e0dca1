"""Cluster-wide download health view, fed by piece reports and flight
summaries.

Counterpart of ``dragonfly2_tpu/scheduler/cluster_view.py``: the
scheduler's half of the flight recorder. The service folds every piece
report and every ``PeerResult``'s compact flight summary into per-host
aggregates, read at ``GET /debug/cluster`` on the scheduler launcher's
``--debug-port``: throughput per host (bytes, pieces, mean piece cost),
the cluster's back-to-source ratio, and straggler parents (a mean
served-piece cost far above the cluster's median). Updates are O(1) per
report; a snapshot walks the host table, behind a one-second cache.
"""

from __future__ import annotations

import time

from ..common.metrics import REGISTRY

_cluster_bytes = REGISTRY.counter(
    "df_cluster_bytes_total",
    "bytes reported downloaded cluster-wide", ("source",))
_flights = REGISTRY.counter(
    "df_cluster_flight_reports_total",
    "flight summaries received from daemons")

STRAGGLER_FACTOR = 3.0      # mean cost beyond this x median -> straggler
MIN_STRAGGLER_PIECES = 4    # don't judge a parent on one slow piece
SNAPSHOT_TTL_S = 1.0        # /debug/cluster rebuild cadence (see snapshot)


class _HostAgg:
    __slots__ = ("bytes_down_p2p", "bytes_down_source", "pieces_down",
                 "pieces_served", "serve_cost_ms_sum", "fails",
                 "flights", "last_seen", "last_flight")

    def __init__(self) -> None:
        self.bytes_down_p2p = 0
        self.bytes_down_source = 0
        self.pieces_down = 0
        self.pieces_served = 0
        self.serve_cost_ms_sum = 0.0
        self.fails = 0
        self.flights = 0
        self.last_seen = time.time()
        self.last_flight: dict | None = None

    def mean_serve_ms(self) -> float:
        return (self.serve_cost_ms_sum / self.pieces_served
                if self.pieces_served else 0.0)


class ClusterView:
    def __init__(self, ledger=None, quarantine=None,
                 snapshot_ttl_s: float = SNAPSHOT_TTL_S) -> None:
        self._hosts: dict[str, _HostAgg] = {}
        self.started_at = time.time()
        # /debug/cluster rebuilds walk every host; on a 10k-host fleet a
        # tight poller would turn that O(hosts) sweep into scheduler load.
        # Snapshots are cached for snapshot_ttl_s and the payload reports
        # its own staleness so pollers know what vintage they read.
        self.snapshot_ttl_s = snapshot_ttl_s
        self._snap: dict | None = None
        self._snap_at = 0.0
        # decision ledger (scheduler/decision_ledger.py): its compact
        # counters ride the cluster snapshot so /debug/cluster answers
        # "is the pod herding onto no-slots/bad-node exclusions" next to
        # the throughput it is costing
        self.ledger = ledger
        # quarantine registry (scheduler/quarantine.py): ladder states
        # ride the snapshot so /debug/cluster names quarantined hosts
        self.quarantine = quarantine

    def _agg(self, host_id: str) -> _HostAgg:
        agg = self._hosts.get(host_id)
        if agg is None:
            agg = self._hosts[host_id] = _HostAgg()
        agg.last_seen = time.time()
        return agg

    # -- hooks called by SchedulerService (hot path: O(1)) -------------

    def on_piece(self, peer, result) -> None:
        agg = self._agg(peer.host.id)
        if not result.success:
            agg.fails += 1
            return
        info = result.piece_info
        if info is None:
            return
        agg.pieces_down += 1
        if result.dst_peer_id:
            agg.bytes_down_p2p += info.range_size
            _cluster_bytes.labels("p2p").inc(info.range_size)
            parent = peer.task.peers.get(result.dst_peer_id)
            if parent is not None:
                pagg = self._agg(parent.host.id)
                pagg.pieces_served += 1
                pagg.serve_cost_ms_sum += info.download_cost_ms
        else:
            agg.bytes_down_source += info.range_size
            _cluster_bytes.labels("source").inc(info.range_size)

    def on_flight(self, peer, summary: dict) -> None:
        agg = self._agg(peer.host.id)
        agg.flights += 1
        # keep only the latest per host (bounded by host count, not tasks)
        agg.last_flight = {
            k: summary.get(k) for k in
            ("task_id", "state", "pieces", "bytes_p2p", "bytes_source",
             "back_to_source_ratio", "tail_ms", "slowest_piece",
             "hbm_dma_ms")}
        _flights.inc()

    # -- consumption ---------------------------------------------------

    def stragglers(self) -> list[dict]:
        """Serving hosts whose mean piece cost is far beyond the cluster
        median — the parents a slow fan-out is waiting on."""
        means = [(hid, a.mean_serve_ms(), a.pieces_served)
                 for hid, a in self._hosts.items()
                 if a.pieces_served >= MIN_STRAGGLER_PIECES]
        if len(means) < 2:
            return []
        costs = sorted(m for _, m, _ in means)
        # lower median: with two serving hosts the slow one must be judged
        # against the fast one, not against itself
        median = costs[(len(costs) - 1) // 2]
        if median <= 0:
            return []
        return [{"host_id": hid, "mean_serve_ms": round(m, 3),
                 "pieces_served": n,
                 "slowdown": round(m / median, 2)}
                for hid, m, n in means
                if m > STRAGGLER_FACTOR * median]

    def snapshot(self) -> dict:
        """TTL-cached view; ``staleness_s`` in the payload says how old."""
        now = time.monotonic()
        if (self._snap is not None
                and now - self._snap_at <= self.snapshot_ttl_s):
            snap = dict(self._snap)
            snap["staleness_s"] = round(now - self._snap_at, 3)
            return snap
        snap = self._build_snapshot()
        snap["snapshot_ttl_s"] = self.snapshot_ttl_s
        snap["staleness_s"] = 0.0
        self._snap = snap
        self._snap_at = now
        return snap

    def _build_snapshot(self) -> dict:
        p2p = sum(a.bytes_down_p2p for a in self._hosts.values())
        src = sum(a.bytes_down_source for a in self._hosts.values())
        hosts = {}
        for hid, a in self._hosts.items():
            hosts[hid] = {
                "bytes_p2p": a.bytes_down_p2p,
                "bytes_source": a.bytes_down_source,
                "pieces_down": a.pieces_down,
                "pieces_served": a.pieces_served,
                "mean_serve_ms": round(a.mean_serve_ms(), 3),
                "fails": a.fails,
                "flights": a.flights,
                "last_seen": a.last_seen,
                "last_flight": a.last_flight,
            }
        snap = {
            "since": self.started_at,
            "hosts": hosts,
            "bytes_p2p": p2p,
            "bytes_source": src,
            "back_to_source_ratio": (round(src / (p2p + src), 4)
                                     if (p2p + src) else 0.0),
            "stragglers": self.stragglers(),
        }
        if self.ledger is not None:
            snap["decisions"] = self.ledger.stats()
        if self.quarantine is not None:
            snap["quarantine"] = self.quarantine.snapshot()
        return snap


def add_cluster_routes(router, view: ClusterView) -> None:
    """``GET /debug/cluster``, on the scheduler launcher's
    ``--debug-port`` server next to ``/metrics``."""

    async def cluster(_params, _query):
        return 200, view.snapshot()

    router.add_get("/debug/cluster", cluster)
