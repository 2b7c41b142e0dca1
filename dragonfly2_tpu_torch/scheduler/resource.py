"""In-memory cluster state: Task / Peer / Host with explicit state machines.

Counterpart of ``dragonfly2_tpu/scheduler/resource.py`` (reference
``scheduler/resource/``): the per-task piece-holder DAG over peers, the
peer and task state machines with validated transitions, host upload-slot
accounting, and TTL GC, with the eviction hooks the shard-affinity view
forgets departed hosts and tasks through. The state-size accounting of
the control-plane observatory is left out.
"""

from __future__ import annotations

import enum
import logging
import time

from ..common.dag import DAG, DAGError
from ..common.errors import Code, DFError
from ..idl.messages import Host as HostMsg
from ..idl.messages import HostType, PieceInfo, SizeScope, TaskType
from .config import HOST_TTL_S, PEER_TTL_S, TASK_TTL_S

log = logging.getLogger("df.sched.resource")


# ---------------------------------------------------------------- FSMs

class PeerState(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"            # registered, downloading via P2P
    BACK_SOURCE = "back_source"    # told to fetch from origin
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    LEAVING = "leaving"


_PEER_TRANSITIONS: dict[PeerState, set[PeerState]] = {
    PeerState.PENDING: {PeerState.RUNNING, PeerState.BACK_SOURCE,
                        PeerState.FAILED, PeerState.LEAVING},
    PeerState.RUNNING: {PeerState.BACK_SOURCE, PeerState.SUCCEEDED,
                        PeerState.FAILED, PeerState.LEAVING},
    PeerState.BACK_SOURCE: {PeerState.SUCCEEDED, PeerState.FAILED,
                            PeerState.LEAVING},
    PeerState.SUCCEEDED: {PeerState.LEAVING},
    PeerState.FAILED: {PeerState.RUNNING, PeerState.LEAVING},
    PeerState.LEAVING: set(),
}


class TaskState(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"        # at least one peer finished the content
    FAILED = "failed"


_TASK_TRANSITIONS: dict[TaskState, set[TaskState]] = {
    TaskState.PENDING: {TaskState.RUNNING, TaskState.FAILED},
    TaskState.RUNNING: {TaskState.SUCCEEDED, TaskState.FAILED},
    TaskState.SUCCEEDED: {TaskState.RUNNING},   # re-validated after GC/expiry
    TaskState.FAILED: {TaskState.RUNNING},
}


# ---------------------------------------------------------------- entities

class Host:
    # Defaults when the daemon announces 0 ("auto"). Slots ride DAG edges
    # (one slot per parent->child assignment for the child's whole download),
    # so the limit is the node's max direct children in the distribution
    # DAG — a loose safety valve against unbounded fan-in, NOT the transfer
    # throttle. Reference parity: 200 peer / 500 seed
    # (scheduler/config/constants.go:27-31). The per-TRANSFER limits live
    # where the bytes move: the upload server's concurrency gate + token
    # bucket, and the dispatcher's busy-backoff/load-aware scoring on the
    # demand side. A host's announced ``concurrent_upload_limit`` overrides.
    DEFAULT_PEER_UPLOAD_LIMIT = 200
    DEFAULT_SEED_UPLOAD_LIMIT = 500

    def __init__(self, msg: HostMsg, *, peer_upload_limit: int = 0,
                 seed_upload_limit: int = 0):
        self.id = msg.id
        self.msg = msg
        # the scheduler's per-type limits (config; 0 = the defaults above)
        self.peer_upload_limit = (peer_upload_limit
                                  or self.DEFAULT_PEER_UPLOAD_LIMIT)
        self.seed_upload_limit = (seed_upload_limit
                                  or self.DEFAULT_SEED_UPLOAD_LIMIT)
        self.concurrent_upload_count = 0
        self.upload_success = 0
        self.upload_fail = 0
        self.created_at = time.time()
        self.updated_at = self.created_at

    @property
    def upload_limit(self) -> int:
        if self.msg.concurrent_upload_limit > 0:
            return self.msg.concurrent_upload_limit
        if self.msg.type != HostType.NORMAL:
            return self.seed_upload_limit
        return self.peer_upload_limit

    def free_upload_slots(self) -> int:
        return max(0, self.upload_limit - self.concurrent_upload_count)

    def acquire_upload_slot(self) -> None:
        self.concurrent_upload_count += 1

    def release_upload_slot(self) -> None:
        self.concurrent_upload_count = max(0, self.concurrent_upload_count - 1)

    def touch(self, msg: HostMsg | None = None) -> None:
        if msg is not None:
            self.msg = msg
        self.updated_at = time.time()

    def observe_upload(self, ok: bool) -> None:
        if ok:
            self.upload_success += 1
        else:
            self.upload_fail += 1

    def upload_success_ratio(self) -> float:
        total = self.upload_success + self.upload_fail
        return self.upload_success / total if total else 1.0


class Peer:
    def __init__(self, peer_id: str, task: "Task", host: Host):
        self.id = peer_id
        self.task = task
        self.host = host
        self.state = PeerState.PENDING
        self.finished_pieces: set[int] = set()
        self.piece_costs_ms: list[int] = []       # recent piece costs (bad-node)
        self.schedule_count = 0                   # packets sent to this peer
        self.report_fail_count = 0                # failed piece reports
        self.blocked_parents: dict[str, float] = {}   # parent id -> expiry
        self.last_offer_ids: set[str] = set()     # parents last pushed to peer
        # newest decision-ledger ruling that named parents for this child;
        # stamped by Scheduling._emit_decision, carried onto every
        # kind=piece record row as the outcome->decision join key
        self.last_decision_id = ""
        self.packet_sink = None                   # set by the report stream
        # resolved download priority (idl.Priority numeric: 0 = highest).
        # Set at register: explicit request value, else the manager-fed
        # application table, else LEVEL0 (reference Peer.CalculatePriority)
        self.priority = 0
        # QoS service class and tenant (set at register from UrlMeta)
        self.qos_class = "standard"
        self.tenant = ""
        # report stream broke while the peer was mid-download: very likely
        # a dead process. Not a removal — completion can land via a late
        # unary report, and a live peer re-opens a stream (both clear it) —
        # but offers and coverage must stop counting the peer meanwhile.
        self.stream_gone = False
        # sharded register: the shards this peer requested, its current
        # shard-affinity ruling, and whether a changed ruling still waits
        # for the report stream to open (SchedulerService._rerule_partners)
        self.shard_request: list[str] | None = None
        self.assigned_shards: list[str] | None = None
        self.shard_push_pending = False
        self.created_at = time.time()
        self.updated_at = self.created_at

    def transit(self, to: PeerState) -> None:
        if to == self.state:
            return
        if to not in _PEER_TRANSITIONS[self.state]:
            raise DFError(Code.SCHED_TASK_STATUS_ERROR,
                          f"peer {self.id[-12:]}: illegal {self.state.value}"
                          f" -> {to.value}")
        log.debug("peer %s: %s -> %s", self.id[-12:], self.state.value, to.value)
        self.state = to
        self.updated_at = time.time()

    def touch(self) -> None:
        self.updated_at = time.time()

    def block_parent(self, parent_id: str, ttl_s: float = 10.0) -> None:
        """Exclude a parent after a failed fetch. Time-bounded: a transient
        wobble (restart, brief overload) must not sever the pair for the
        rest of the task — permanent ejection is the Z-score bad-node
        check's job, not the blocklist's."""
        self.blocked_parents[parent_id] = time.time() + ttl_s

    def is_blocked(self, parent_id: str) -> bool:
        expiry = self.blocked_parents.get(parent_id)
        if expiry is None:
            return False
        if time.time() >= expiry:
            del self.blocked_parents[parent_id]
            return False
        return True

    def observe_piece_cost(self, cost_ms: int) -> None:
        self.piece_costs_ms.append(cost_ms)
        if len(self.piece_costs_ms) > 20:
            self.piece_costs_ms = self.piece_costs_ms[-20:]

    def is_done(self) -> bool:
        return self.state in (PeerState.SUCCEEDED, PeerState.FAILED,
                              PeerState.LEAVING)

    def has_content(self) -> bool:
        """Usable as a parent: finished, running with pieces to share, or
        back-sourcing (its origin pull will announce pieces over the sync
        stream moments from now — children attach early so the pipeline
        preforms instead of polling for the seed's first piece; reference
        ``scheduling.go:538-541`` similarly admits back-source parents)."""
        if self.state in (PeerState.SUCCEEDED, PeerState.BACK_SOURCE):
            return True
        return self.state == PeerState.RUNNING and bool(self.finished_pieces)


class Task:
    def __init__(self, task_id: str, url: str, *,
                 task_type: TaskType = TaskType.STANDARD):
        self.id = task_id
        self.url = url
        self.task_type = task_type
        self.state = TaskState.PENDING
        self.content_length = -1
        self.piece_size = 0
        self.total_piece_count = -1
        self.pieces: dict[int, PieceInfo] = {}   # canonical piece metadata
        self.peers: dict[str, Peer] = {}
        self.dag: DAG[str] = DAG()               # edges parent -> child
        self.back_source_peers: set[str] = set()  # peers holding an origin slot
        self.seed_triggered = False
        self.seed_job = None                     # asyncio.Task of the trigger
        self.seed_retries = 0                    # re-triggers after failure
        self.seed_next_retry_at = 0.0            # monotonic backoff gate
        self.url_meta = None                     # first register's UrlMeta:
        # kept so a seed RE-trigger (seed daemon died mid-injection) can
        # replay the original request headers/tag against the origin
        self.created_at = time.time()
        self.updated_at = self.created_at

    def transit(self, to: TaskState) -> None:
        if to == self.state:
            return
        if to not in _TASK_TRANSITIONS[self.state]:
            raise DFError(Code.SCHED_TASK_STATUS_ERROR,
                          f"task {self.id[:12]}: illegal {self.state.value}"
                          f" -> {to.value}")
        self.state = to
        self.updated_at = time.time()

    # -- geometry ------------------------------------------------------

    def set_content_info(self, content_length: int, piece_size: int,
                         total_piece_count: int) -> None:
        if content_length >= 0:
            self.content_length = content_length
        if piece_size > 0:
            self.piece_size = piece_size
        if total_piece_count >= 0:
            self.total_piece_count = total_piece_count
        self.updated_at = time.time()

    def size_scope(self) -> SizeScope:
        if self.content_length < 0:
            return SizeScope.NORMAL
        if self.content_length == 0:
            return SizeScope.EMPTY
        if self.total_piece_count == 1:
            return SizeScope.SMALL
        return SizeScope.NORMAL

    def record_piece(self, info: PieceInfo) -> None:
        known = self.pieces.get(info.piece_num)
        if known is None or (not known.digest and info.digest):
            self.pieces[info.piece_num] = info

    # -- peer/DAG management ------------------------------------------

    def add_peer(self, peer: Peer) -> None:
        self.peers[peer.id] = peer
        self.dag.add_vertex(peer.id, peer.id)
        self.touch()

    def remove_peer(self, peer_id: str) -> None:
        peer = self.peers.pop(peer_id, None)
        if peer_id in self.dag:
            # release upload slots: this peer's parents each lose one child
            # (their slot), and this peer's host frees one slot per child
            for pid in self.dag.parents(peer_id):
                parent = self.peers.get(pid)
                if parent is not None:
                    parent.host.release_upload_slot()
            if peer is not None:
                for _ in self.dag.children(peer_id):
                    peer.host.release_upload_slot()
            try:
                self.dag.delete_vertex(peer_id)
            except DAGError:
                pass
        self.back_source_peers.discard(peer_id)
        self.touch()

    def set_parents(self, child_id: str, parent_ids: list[str]) -> None:
        """Re-point the child's in-edges at the new parent set (re-parenting
        on reschedule must drop stale edges or the DAG fills with cycles).
        Upload-slot accounting rides the edge changes: one in-flight upload
        per parent→child edge (reference ``resource/host.go`` accounting)."""
        old = self.dag.parents(child_id)
        self.dag.delete_in_edges(child_id)
        new: set[str] = set()
        for pid in parent_ids:
            if pid == child_id or pid not in self.dag:
                continue
            try:
                self.dag.add_edge(pid, child_id)
                new.add(pid)
            except DAGError:
                log.debug("edge %s->%s would cycle; skipped", pid[-12:],
                          child_id[-12:])
        for pid in old - new:
            parent = self.peers.get(pid)
            if parent is not None:
                parent.host.release_upload_slot()
        for pid in new - old:
            parent = self.peers.get(pid)
            if parent is not None:
                parent.host.acquire_upload_slot()

    def detach_children(self, parent_id: str) -> None:
        """Drop every out-edge of ``parent_id``, and the upload slots the
        edges held."""
        parent = self.peers.get(parent_id)
        for cid in self.dag.children(parent_id):
            self.dag.delete_edge(parent_id, cid)
            if parent is not None:
                parent.host.release_upload_slot()

    def has_available_peer(self) -> bool:
        return any(p.has_content() for p in self.peers.values())

    def has_live_available_peer(self) -> bool:
        """has_available_peer minus peers whose report stream died
        mid-download (their content is unreachable until they return)."""
        return any(p.has_content()
                   and not (p.stream_gone and not p.is_done())
                   for p in self.peers.values())

    def swarm_can_complete(self) -> bool:
        """Whether the union of live peers' finished pieces covers every
        piece of the task. False means some content exists NOWHERE in the
        swarm (e.g. the seed died mid-injection and took the tail pieces
        with it) — no amount of peer-to-peer scheduling can finish, and
        the scheduler must re-source (seed re-trigger / back-source).
        Unknown totals count as coverable: there is nothing to prove yet.
        """
        if self.total_piece_count <= 0:
            return True
        covered: set[int] = set()
        for p in self.peers.values():
            if p.state in (PeerState.FAILED, PeerState.LEAVING) \
                    or (p.stream_gone and not p.is_done()):
                continue
            covered |= p.finished_pieces
            if len(covered) >= self.total_piece_count:
                return True
        return False

    def touch(self) -> None:
        self.updated_at = time.time()


# ---------------------------------------------------------------- managers

class Resource:
    """The cluster state of record for one scheduler."""

    def __init__(self, *, peer_upload_limit: int = 0,
                 seed_upload_limit: int = 0, peer_ttl_s: float = PEER_TTL_S,
                 task_ttl_s: float = TASK_TTL_S,
                 host_ttl_s: float = HOST_TTL_S):
        self.peer_ttl_s = peer_ttl_s
        self.task_ttl_s = task_ttl_s
        self.host_ttl_s = host_ttl_s
        self.tasks: dict[str, Task] = {}
        self.hosts: dict[str, Host] = {}
        self.peer_upload_limit = peer_upload_limit
        self.seed_upload_limit = seed_upload_limit
        # eviction hooks: a host or task leaving the resource model must
        # also leave the views that remember it (shard affinity)
        self.on_host_evict = None      # callable(host_id)
        self.on_task_evict = None      # callable(task_id)

    # -- lookups -------------------------------------------------------

    def get_or_create_task(self, task_id: str, url: str, *,
                           task_type: TaskType = TaskType.STANDARD) -> Task:
        task = self.tasks.get(task_id)
        if task is None:
            task = Task(task_id, url, task_type=task_type)
            self.tasks[task_id] = task
        return task

    def store_host(self, msg: HostMsg) -> Host:
        host = self.hosts.get(msg.id)
        if host is None:
            host = Host(msg, peer_upload_limit=self.peer_upload_limit,
                        seed_upload_limit=self.seed_upload_limit)
            self.hosts[msg.id] = host
        else:
            host.touch(msg)
        return host

    def get_or_create_peer(self, peer_id: str, task: Task, host: Host) -> Peer:
        peer = task.peers.get(peer_id)
        if peer is None:
            peer = Peer(peer_id, task, host)
            task.add_peer(peer)
        return peer

    def find_peer(self, task_id: str, peer_id: str) -> Peer | None:
        task = self.tasks.get(task_id)
        return task.peers.get(peer_id) if task else None

    # -- departures ----------------------------------------------------

    def leave_peer(self, task_id: str, peer_id: str) -> None:
        task = self.tasks.get(task_id)
        if task is None:
            return
        peer = task.peers.get(peer_id)
        if peer is not None and peer.state != PeerState.LEAVING:
            try:
                peer.transit(PeerState.LEAVING)
            except DFError:
                pass
        task.remove_peer(peer_id)

    def leave_host(self, host_id: str) -> list[Peer]:
        """Remove the host and every peer on it; returns orphaned children's
        peers so the service can reschedule them."""
        self.hosts.pop(host_id, None)
        if self.on_host_evict is not None:
            self.on_host_evict(host_id)
        orphaned: list[Peer] = []
        for task in self.tasks.values():
            gone = [p for p in task.peers.values() if p.host.id == host_id]
            for peer in gone:
                children = task.dag.children(peer.id)
                task.remove_peer(peer.id)
                for cid in children:
                    child = task.peers.get(cid)
                    if child is not None and not child.is_done():
                        orphaned.append(child)
        return orphaned

    # -- GC ------------------------------------------------------------

    def state_bytes(self) -> int:
        """Bytes of cluster state of record (tasks, peers, hosts, DAGs) for
        ``/debug/ctrl``; a deep sizeof walk over the object graph (the
        visited set charges the peer, task and host cross-references
        once), at snapshot cadence only."""
        from ..common.sizeof import deep_sizeof
        seen: set = set()
        return sum(deep_sizeof(o, seen) for o in (self.tasks, self.hosts))

    def gc(self) -> int:
        """Evict idle peers, empty/expired tasks, and silent hosts."""
        now = time.time()
        evicted = 0
        for task in list(self.tasks.values()):
            for peer in list(task.peers.values()):
                idle = now - peer.updated_at
                if (peer.is_done() and idle > 300.0) or idle > self.peer_ttl_s:
                    task.remove_peer(peer.id)
                    evicted += 1
            if not task.peers and now - task.updated_at > self.task_ttl_s:
                del self.tasks[task.id]
                if self.on_task_evict is not None:
                    self.on_task_evict(task.id)
                evicted += 1
        for host in list(self.hosts.values()):
            if now - host.updated_at > self.host_ttl_s:
                del self.hosts[host.id]
                if self.on_host_evict is not None:
                    self.on_host_evict(host.id)
                evicted += 1
        return evicted
