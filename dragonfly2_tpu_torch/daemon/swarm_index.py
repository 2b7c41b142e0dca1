"""SwarmIndex: the daemon's TTL'd local view of who holds which pieces.

Counterpart of ``dragonfly2_tpu/daemon/swarm_index.py``. The PEX gossip
plane (``daemon/pex.py``) replicates a decaying summary of piece
locations onto every daemon, so a task can still find mesh parents when
every scheduler is unreachable (the ``pex`` rung of the conductor's
ladder).

Per task, one entry per remote host: the address triple (ip, rpc_port,
download_port), the host's topology, and the piece set it advertised
(``None`` = every piece, the compact form for completed tasks), plus the
in-flight landing watermark (``relay_pieces``). Entries expire ``ttl_s``
after the last digest that named them. ``progress_at`` stamps when a
holder's advertised set last grew: a watermark that stopped advancing
stops counting as coverage (``progress_fresh``). ``parents_for`` orders
live holders complete first, then fresh before stale, then by link class
and chip-mesh hops, as the scheduler's evaluator would. The
``df_swarm_tasks`` and ``df_swarm_entries`` gauges track the size.
"""

from __future__ import annotations

import time

from ..common.metrics import REGISTRY
from ..idl.messages import TopologyInfo
from ..tpu.topology import ici_hops, link_type

_swarm_tasks = REGISTRY.gauge(
    "df_swarm_tasks", "tasks the PEX swarm index currently knows holders for")
_swarm_entries = REGISTRY.gauge(
    "df_swarm_entries", "live (task, holder) entries in the PEX swarm index")


class SwarmEntry:
    """One remote host's advertised availability for one task."""

    __slots__ = ("host_id", "ip", "rpc_port", "download_port", "is_seed",
                 "topology", "pieces", "relay_pieces", "total_pieces",
                 "content_length", "piece_size", "done", "expires_at",
                 "progress_at")

    def __init__(self, *, host_id: str, ip: str, rpc_port: int,
                 download_port: int, is_seed: bool = False,
                 topology: TopologyInfo | None = None,
                 pieces: set[int] | None = None,
                 relay_pieces: set[int] | None = None,
                 total_pieces: int = -1,
                 content_length: int = -1, piece_size: int = 0,
                 done: bool = False, expires_at: float = 0.0):
        self.host_id = host_id
        self.ip = ip
        self.rpc_port = rpc_port
        self.download_port = download_port
        self.is_seed = is_seed
        self.topology = topology
        self.pieces = pieces          # None = complete (all pieces)
        # the advertised landing watermark (daemon/relay.py): pieces
        # IN-FLIGHT at the holder when it gossiped — usable for parent
        # ordering and (while FRESH, see progress_at) for the pex rung's
        # coverage gate; a watermark that stopped advancing is a claim,
        # not a holding
        self.relay_pieces = relay_pieces
        self.total_pieces = total_pieces
        self.content_length = content_length
        self.piece_size = piece_size
        self.done = done
        self.expires_at = expires_at
        # when this holder's advertised piece/watermark set last GREW
        # (maintained by SwarmIndex.update): the freshness the coverage
        # gate checks before trusting relay_pieces
        self.progress_at = 0.0

    @property
    def addr(self) -> str:
        return f"{self.ip}:{self.download_port}"

    def piece_count(self) -> int:
        if self.pieces is None:
            return self.total_pieces if self.total_pieces >= 0 else 1 << 30
        return len(self.pieces)

    def advertised_count(self) -> int:
        """Landed + in-flight — the growth signal progress_at tracks."""
        return self.piece_count() + len(self.relay_pieces or ())

    def progress_fresh(self, now: float, ttl_s: float) -> bool:
        """True while the holder's watermark advanced within ``ttl_s`` —
        only then may its in-flight claims count as coverage."""
        return self.done or self.pieces is None \
            or now - self.progress_at <= ttl_s

    def describe(self) -> dict:
        return {"host_id": self.host_id, "addr": self.addr,
                "rpc_port": self.rpc_port, "is_seed": self.is_seed,
                "done": self.done, "pieces": self.piece_count(),
                "relay_pieces": len(self.relay_pieces or ()),
                "total_pieces": self.total_pieces,
                "content_length": self.content_length,
                "progress_age_s": round(
                    max(time.monotonic() - self.progress_at, 0.0), 1),
                "expires_in_s": round(max(self.expires_at - time.monotonic(),
                                          0.0), 1)}


class SwarmIndex:
    """task_id -> {host_id -> SwarmEntry}, TTL'd and size-capped."""

    def __init__(self, *, ttl_s: float = 60.0, max_tasks: int = 512,
                 max_holders_per_task: int = 64,
                 progress_ttl_s: float = 15.0):
        self.ttl_s = ttl_s
        self.max_tasks = max_tasks
        self.max_holders_per_task = max_holders_per_task
        # how long a partial holder's watermark may sit still before its
        # in-flight claims stop counting as coverage (pex._covers_task) —
        # a few gossip intervals: one missed round is jitter, three is a
        # download that died
        self.progress_ttl_s = progress_ttl_s
        self._tasks: dict[str, dict[str, SwarmEntry]] = {}

    # -- ingest --------------------------------------------------------

    def update(self, task_id: str, entry: SwarmEntry,
               *, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        entry.expires_at = now + self.ttl_s
        prev = self._tasks.get(task_id, {}).get(entry.host_id)
        if prev is None or entry.piece_count() > prev.piece_count() \
                or entry.advertised_count() > prev.advertised_count() \
                or (entry.done and not prev.done):
            # first sighting, or the watermark moved: the holder is alive
            # AND landing — only growth refreshes progress (re-gossiping
            # the same stuck set forever must not). The LANDED count is
            # checked on its own: in a download's tail each landing
            # converts an in-flight piece to a landed one one-for-one,
            # so the sum stays flat while the holder is demonstrably
            # still making progress
            entry.progress_at = now
        else:
            entry.progress_at = prev.progress_at
        holders = self._tasks.get(task_id)
        if holders is None:
            if len(self._tasks) >= self.max_tasks:
                # drop the task whose best entry dies soonest — the one the
                # index was about to forget anyway
                victim = min(self._tasks,
                             key=lambda t: max(e.expires_at for e in
                                               self._tasks[t].values()))
                del self._tasks[victim]
            holders = self._tasks[task_id] = {}
        holders[entry.host_id] = entry
        if len(holders) > self.max_holders_per_task:
            victim = min(holders, key=lambda h: holders[h].expires_at)
            del holders[victim]
        self._export_gauges()

    def forget_host(self, host_id: str) -> None:
        """Drop every entry a (now unreachable) host advertised."""
        for holders in self._tasks.values():
            holders.pop(host_id, None)
        self._purge_empty()
        self._export_gauges()

    # -- queries -------------------------------------------------------

    def purge(self, *, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        for holders in self._tasks.values():
            for host_id in [h for h, e in holders.items()
                            if e.expires_at <= now]:
                del holders[host_id]
        self._purge_empty()
        self._export_gauges()

    def _purge_empty(self) -> None:
        for task_id in [t for t, h in self._tasks.items() if not h]:
            del self._tasks[task_id]

    def parents_for(self, task_id: str, *,
                    self_topology: TopologyInfo | None = None,
                    exclude_host: str = "",
                    now: float | None = None) -> list[SwarmEntry]:
        """Live holders of ``task_id``, best parents first: completed
        holders before partial ones, then nearest by link class (ICI
        neighbors before DCN before WAN) and chip-mesh hops — the same
        locality order the scheduler's evaluator applies, collapsed to a
        sort key this side of the control-plane outage."""
        now = time.monotonic() if now is None else now
        holders = self._tasks.get(task_id)
        if not holders:
            return []
        live = [e for e in holders.values()
                if e.expires_at > now and e.host_id != exclude_host]

        def key(e: SwarmEntry):
            lt = link_type(self_topology, e.topology)
            hops = (ici_hops(self_topology, e.topology)
                    if self_topology is not None and e.topology is not None
                    else 1 << 16)
            # stale-watermark partials rank behind fresh ones: a holder
            # whose advertised progress stopped moving is likelier to be
            # a dead download than a busy one
            stale = not e.progress_fresh(now, self.progress_ttl_s)
            return (not e.done, stale, int(lt), hops, -e.piece_count(),
                    e.host_id)

        return sorted(live, key=key)

    def tasks(self) -> list[str]:
        return list(self._tasks)

    def snapshot(self) -> dict:
        return {
            "ttl_s": self.ttl_s,
            "tasks": {tid: [e.describe() for e in holders.values()]
                      for tid, holders in self._tasks.items()},
        }

    def _export_gauges(self) -> None:
        _swarm_tasks.set(len(self._tasks))
        _swarm_entries.set(sum(len(h) for h in self._tasks.values()))
