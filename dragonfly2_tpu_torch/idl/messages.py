"""The wire messages this slice uses.

Counterpart of ``dragonfly2_tpu/idl/messages.py``: same class names, same
field names in the same order, same defaults, so one field dict builds
either package's message and ``dumps`` gives both the same bytes. The
slice carries the daemon's download messages, the scheduler's register /
report / announce / leave / stat messages, the peer piece-sync messages,
the seed trigger, the trainer's ``Train`` / ``ModelInfer`` messages, and
the manager's registration, discovery, keepalive, model-registry and
application-list messages, and the probers' ``SyncProbes`` messages. ``TopologyInfo`` carries the host's position
for link classification; ``DeviceSink`` describes a device-memory
placement target; ``ShardManifest`` names the tensors of a sharded
checkpoint.
"""

from __future__ import annotations

import enum

from .base import message


class SizeScope(enum.IntEnum):
    NORMAL = 0   # many pieces, full P2P
    SMALL = 1    # exactly one piece: skip piece sync, single parent
    TINY = 2     # <=128 KiB: content returned inline in register result
    EMPTY = 3    # zero bytes


class TaskType(enum.IntEnum):
    STANDARD = 0       # downloaded file, GC-able
    PERSISTENT = 1     # dfcache import: pinned until deleted
    PERSISTENT_CACHE = 2


class Priority(enum.IntEnum):
    LEVEL0 = 0  # highest
    LEVEL1 = 1
    LEVEL2 = 2
    LEVEL3 = 3
    LEVEL4 = 4
    LEVEL5 = 5
    LEVEL6 = 6  # lowest


# The QoS service-class vocabulary a register resolves against.
PRIORITY_CLASSES = ("critical", "standard", "bulk")
DEFAULT_PRIORITY_CLASS = "standard"

# numeric Priority a class resolves to when the request carries none
CLASS_DEFAULT_PRIORITY = {"critical": 0, "standard": 0, "bulk": 6}


def resolve_class(qos_class: str) -> str:
    """Clamp a wire-supplied class onto the vocabulary ("" and unknown
    strings resolve to the default class, never an error)."""
    return qos_class if qos_class in PRIORITY_CLASSES \
        else DEFAULT_PRIORITY_CLASS

# The typed piece-failure vocabulary (``PieceResult.fail_code``, flight
# failure events, ``kind=piece`` record rows, the verdict ledger's
# counters): ``corrupt`` is hard evidence of a lying parent, which the
# quarantine registry promotes; the other three are congestion or
# liveness shapes that only deprioritize.
FAIL_CODES = ("corrupt", "stall", "timeout", "refused")


class HostType(enum.IntEnum):
    NORMAL = 0       # ordinary peer
    SUPER_SEED = 1   # seed peer, first to back-source
    STRONG_SEED = 2
    WEAK_SEED = 3


class LinkType(enum.IntEnum):
    """Locality class between two hosts, best to worst."""

    LOCAL = 0  # same host
    ICI = 1    # same TPU slice: wired inter-chip interconnect
    DCN = 2    # same zone, data-center network between slices/hosts
    WAN = 3    # cross-zone / unknown


@message
class UrlMeta:
    """Download-relevant metadata; participates in the task id."""

    digest: str = ""                 # "sha256:..." expected digest of whole file
    tag: str = ""                    # task isolation tag
    range: str = ""                  # "bytes=a-b" sub-range request
    filtered_query_params: list[str] | None = None
    header: dict | None = None       # extra origin request headers
    application: str = ""
    priority: Priority = Priority.LEVEL0
    tenant: str = ""
    qos_class: str = ""
    # comma-joined names of the manifest shards this host needs ("" = the
    # whole task); not part of the task id
    shards: str = ""


@message
class TopologyInfo:
    """Where a host sits: slice, chip coordinates, zone, pod."""

    slice_name: str = ""             # "" = not on an accelerator slice
    worker_index: int = -1
    ici_coords: tuple | None = None  # chip-mesh coords of this host's chips
    num_chips: int = 0
    zone: str = ""                   # cloud zone (DCN domain)
    cluster_id: int = 0
    pod: str = ""                    # explicit pod identity; "" = slice


@message
class CPUStat:
    logical_count: int = 0
    percent: float = 0.0


@message
class MemoryStat:
    total: int = 0
    available: int = 0
    used_percent: float = 0.0


@message
class NetworkStat:
    download_rate: int = 0       # bytes/s current
    download_rate_limit: int = 0
    upload_rate: int = 0
    upload_rate_limit: int = 0


@message
class DiskStat:
    total: int = 0
    free: int = 0
    used_percent: float = 0.0


@message
class Host:
    """A daemon instance's identity + address, carried in every register."""

    id: str = ""
    ip: str = ""
    hostname: str = ""
    port: int = 0                  # peer RPC port
    download_port: int = 0         # piece upload (HTTP) port
    type: HostType = HostType.NORMAL
    os: str = ""
    platform: str = ""
    topology: TopologyInfo | None = None
    cpu: CPUStat | None = None
    memory: MemoryStat | None = None
    network: NetworkStat | None = None
    disk: DiskStat | None = None
    # 0 = "auto": the scheduler applies its per-host-type default
    concurrent_upload_limit: int = 0
    build_version: str = ""
    quarantined: bool = False      # the daemon flagged its own bit-rot


@message
class PieceInfo:
    piece_num: int = 0
    range_start: int = 0
    range_size: int = 0
    digest: str = ""               # per-piece "crc32:..." / "md5:..."
    download_cost_ms: int = 0      # filled by downloader when reporting


@message
class PiecePacket:
    """Answer to "which pieces does peer X have"; carries the address to
    fetch them from."""

    task_id: str = ""
    dst_peer_id: str = ""
    dst_addr: str = ""             # "ip:download_port" to fetch pieces from
    piece_infos: list[PieceInfo] | None = None
    total_piece_count: int = -1    # -1: unknown yet
    content_length: int = -1
    piece_size: int = 0
    extend_attribute: dict | None = None
    progress: int = -1             # pieces landed at the holder
    relay_nums: list[int] | None = None


@message
class ShardInfo:
    """One named array shard of a sharded task: a contiguous byte range of
    the content plus the array geometry it is viewed with on the device.
    ``digest`` is an OPTIONAL whole-shard digest checked at task finalize."""

    name: str = ""                   # e.g. "layers.17.mlp.w1"
    range_start: int = 0             # byte offset within the content
    range_size: int = 0
    dtype: str = "uint8"             # dtype string for the tensor view
    shape: list[int] | None = None   # tensor shape; None = flat bytes
    digest: str = ""                 # optional "sha256:..." of the shard


@message
class ShardManifest:
    """A sharded task's shard table. Shards are disjoint contiguous ranges;
    gaps are legal (unnamed bytes still ride the task, they just never
    become named tensors)."""

    shards: list[ShardInfo] | None = None


@message
class DeviceSink:
    """Optional terminal sink describing how verified bytes land in device
    memory."""

    enabled: bool = False
    dtype: str = "uint8"
    shard_index: int = 0
    shard_count: int = 1
    donate: bool = True
    pipeline_shards: int = 0       # copy units per device; 0 = auto (~32MiB each)


# ---------------------------------------------------------------- scheduler

@message
class RegisterPeerTaskRequest:
    url: str = ""
    url_meta: UrlMeta | None = None
    task_id: str = ""
    peer_id: str = ""
    peer_host: Host | None = None
    is_migrating: bool = False


@message
class SinglePiece:
    dst_peer_id: str = ""
    dst_addr: str = ""
    piece_info: PieceInfo | None = None


@message
class RegisterResult:
    task_id: str = ""
    size_scope: SizeScope = SizeScope.NORMAL
    direct_content: bytes = b""           # TINY: whole file inline
    single_piece: SinglePiece | None = None  # SMALL
    content_length: int = -1
    piece_size: int = 0
    resolved_priority: Priority = Priority.LEVEL0
    assigned_shards: list[str] | None = None
    scheduler_epoch: int = 0


@message
class HostLoad:
    cpu_ratio: float = 0.0
    mem_ratio: float = 0.0
    disk_ratio: float = 0.0


@message
class PieceResult:
    """Peer -> scheduler, one per finished/failed piece (the report stream)."""

    task_id: str = ""
    src_peer_id: str = ""           # downloader
    dst_peer_id: str = ""           # parent it fetched from ("" = back-source)
    piece_info: PieceInfo | None = None
    begin_ms: int = 0
    end_ms: int = 0
    success: bool = False
    code: int = 0                   # errors.Code
    fail_code: str = ""             # corrupt | stall | timeout | refused
    relayed: bool = False
    host_load: HostLoad | None = None
    finished_count: int = 0         # pieces this peer now holds


@message
class PeerAddr:
    peer_id: str = ""
    ip: str = ""
    rpc_port: int = 0
    download_port: int = 0
    link: LinkType = LinkType.DCN   # scheduler-computed locality to the child
    is_seed: bool = False           # seed host: the dispatcher ranks it last


@message
class PeerPacket:
    """Scheduler -> peer: current parent assignment set."""

    task_id: str = ""
    src_peer_id: str = ""
    parallel_count: int = 4
    main_peer: PeerAddr | None = None
    candidate_peers: list[PeerAddr] | None = None
    code: int = 0                   # e.g. SCHED_NEED_BACK_SOURCE
    advisory: bool = False          # adds parents without pruning
    # port-only: a changed shard-affinity ruling for a sharded peer whose
    # group grew after it registered (the reference rules only at
    # register). None = no ruling; older decoders ignore the key
    assigned_shards: list[str] | None = None


@message
class PeerResult:
    """Final report when a peer's task ends."""

    task_id: str = ""
    peer_id: str = ""
    src_ip: str = ""
    url: str = ""
    success: bool = False
    traffic: int = 0                # bytes downloaded P2P
    cost_ms: int = 0
    code: int = 0
    total_piece_count: int = 0
    content_length: int = -1
    flight_summary: dict | None = None


PULSE_VERSION = 1


@message
class PulseDigest:
    """A daemon's health counters piggybacked on ``AnnounceHost``."""

    v: int = PULSE_VERSION
    seq: int = 0
    flight_tasks: int = 0
    flight_evicted: int = 0
    served_rungs: dict | None = None
    loop_lag_max_ms: float = 0.0
    loop_stalls: int = 0
    slo_breaches: int = 0
    corrupt_verdicts: int = 0
    shunned_parents: int = 0
    self_quarantined: bool = False
    qos_state: str = "normal"
    qos_shed: int = 0
    storage_tasks: int = 0


@message
class AnnounceHostRequest:
    host: Host | None = None
    interval_s: float = 30.0
    pulse: PulseDigest | None = None


@message
class AnnounceHostResponse:
    scheduler_epoch: int = 0


@message
class HeldContentEntry:
    """One task's holdings in a daemon's recovery re-announce: the PEX
    digest entry shape (``daemon/pex.py`` ``build_digest``)."""

    task_id: str = ""
    url: str = ""
    total_piece_count: int = -1
    content_length: int = -1
    piece_size: int = 0
    done: bool = False
    pieces: list[int] | None = None     # partial holdings (done=False)


@message
class AnnounceContentRequest:
    """Daemon -> scheduler after an epoch change or a register failover:
    what this daemon holds. ``digest`` is the sealed PEX envelope
    (``daemon/pex.py`` ``seal``) over the same entries; the scheduler
    refuses a torn or version-skewed one whole."""

    host: Host | None = None
    entries: list[HeldContentEntry] | None = None
    digest: bytes = b""
    pulse: PulseDigest | None = None


@message
class AnnounceContentResponse:
    scheduler_epoch: int = 0
    tasks_adopted: int = 0


@message
class LeaveHostRequest:
    host_id: str = ""


@message
class LeavePeerRequest:
    task_id: str = ""
    peer_id: str = ""


@message
class StatTaskRequest:
    task_id: str = ""


@message
class TaskStat:
    id: str = ""
    type: TaskType = TaskType.STANDARD
    content_length: int = -1
    total_piece_count: int = -1
    state: str = ""
    peer_count: int = 0
    has_available_peer: bool = False


@message
class ProbeTarget:
    host_id: str = ""
    ip: str = ""
    port: int = 0


@message
class SyncProbesRequest:
    """Daemon -> scheduler: either asking for targets or reporting results."""

    host: Host | None = None
    probes: list[Probe] | None = None
    failed_host_ids: list[str] | None = None


@message
class Probe:
    target_host_id: str = ""
    rtt_us: int = 0
    created_at_ms: int = 0


@message
class SyncProbesResponse:
    targets: list[ProbeTarget] | None = None
    probe_interval_s: float = 20.0


# ---------------------------------------------------------------- daemon

@message
class DownloadRequest:
    url: str = ""
    output: str = ""                # abs path; "" = stream/cache only
    url_meta: UrlMeta | None = None
    timeout_s: float = 0.0
    rate_limit_bps: int = 0
    disable_back_source: bool = False
    recursive: bool = False
    recursive_concurrency: int = 8
    keep_original_offset: bool = False
    device_sink: DeviceSink | None = None
    task_type: TaskType = TaskType.STANDARD
    # sharded tasks: the checkpoint's shard table. With a manifest the
    # daemon maps pieces -> shards as they verify and hands each complete
    # shard to the device sink incrementally.
    shard_manifest: ShardManifest | None = None


@message
class DownloadResponse:
    task_id: str = ""
    peer_id: str = ""
    completed_length: int = 0
    content_length: int = -1
    done: bool = False
    output: str = ""                # echo of where this entry landed (recursive)
    code: int = 0
    message: str = ""
    # sharded tasks: a ``shard_ready`` progress frame — this named shard's
    # bytes all verified and (with a device sink) its copy is enqueued
    shard: str = ""
    shard_src: str = ""
    shards_ready: int = 0
    shards_total: int = 0


@message
class PieceTaskRequest:
    task_id: str = ""
    src_peer_id: str = ""           # requester
    dst_peer_id: str = ""           # owner being asked
    start_num: int = 0
    limit: int = 32
    src_slice: str = ""             # requester's slice


@message
class StatTaskDaemonRequest:
    url: str = ""
    url_meta: UrlMeta | None = None
    task_id: str = ""
    local_only: bool = False


@message
class DeleteTaskRequest:
    url: str = ""
    url_meta: UrlMeta | None = None
    task_id: str = ""


@message
class ObtainSeedsRequest:
    url: str = ""
    url_meta: UrlMeta | None = None
    task_id: str = ""


@message
class PieceSeed:
    peer_id: str = ""
    host_id: str = ""
    piece_info: PieceInfo | None = None
    done: bool = False
    content_length: int = -1
    total_piece_count: int = -1


@message
class Empty:
    pass


# ---------------------------------------------------------------- manager service

@message
class SchedulerEntity:
    id: int = 0
    hostname: str = ""
    ip: str = ""
    port: int = 0
    state: str = "inactive"         # active | inactive
    scheduler_cluster_id: int = 0
    features: list[str] | None = None
    topology: TopologyInfo | None = None


@message
class SeedPeerEntity:
    id: int = 0
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    object_storage_port: int = 0
    type: str = "super"
    state: str = "inactive"
    seed_peer_cluster_id: int = 0
    topology: TopologyInfo | None = None


@message
class ClusterConfig:
    """Scheduler-cluster tunables served via dynconfig."""

    candidate_parent_limit: int = 4
    filter_parent_limit: int = 15
    job_rate_limit: int = 10
    seed_peer_load_limit: int = 300
    peer_load_limit: int = 50
    piece_parallel_count: int = 4


@message
class GetSchedulersRequest:
    hostname: str = ""
    ip: str = ""
    topology: TopologyInfo | None = None
    version: str = ""


@message
class GetSchedulersResponse:
    schedulers: list[SchedulerEntity] | None = None
    cluster_config: ClusterConfig | None = None


@message
class GetSeedPeersRequest:
    cluster_id: int = 0


@message
class GetSeedPeersResponse:
    seed_peers: list[SeedPeerEntity] | None = None


@message
class KeepAliveRequest:
    source_type: str = ""           # "scheduler" | "seed_peer"
    hostname: str = ""
    ip: str = ""
    port: int = 0                   # instance identity is (hostname, ip, port)
    cluster_id: int = 0


@message
class RegisterSchedulerRequest:
    hostname: str = ""
    ip: str = ""
    port: int = 0
    scheduler_cluster_id: int = 0
    topology: TopologyInfo | None = None


@message
class RegisterSeedPeerRequest:
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    object_storage_port: int = 0
    type: str = "super"
    seed_peer_cluster_id: int = 0
    topology: TopologyInfo | None = None


# ---------------------------------------------------------------- trainer service

@message
class TrainRequest:
    """Client-stream chunk: schedulers upload gzip'd JSONL datasets for
    model fitting."""

    hostname: str = ""
    ip: str = ""
    cluster_id: int = 0
    dataset: str = ""               # "download" | "networktopology"
    chunk: bytes = b""
    done: bool = False


@message
class TrainResponse:
    ok: bool = True
    message: str = ""
    model_version: str = ""


@message
class ModelInferRequest:
    model_name: str = "bandwidth_mlp"
    features: list[list] | None = None   # batch of feature rows


@message
class ModelInferResponse:
    outputs: list[float] | None = None
    model_version: str = ""


# ---------------------------------------------------------------- model registry

@message
class ModelEntity:
    """A versioned trained model (reference ``manager/models/model.go:36``)."""

    id: int = 0
    name: str = ""                  # bandwidth_mlp | topology_gnn
    version: str = ""               # content hash of the blob
    state: str = "active"
    scheduler_cluster_id: int = 0
    metrics: dict | None = None     # loss curve, rows, train time...
    data: bytes = b""               # npz param archive ("" in listings)
    created_at: float = 0.0


@message
class CreateModelRequest:
    name: str = ""
    version: str = ""
    scheduler_cluster_id: int = 0
    metrics: dict | None = None
    data: bytes = b""


@message
class GetModelRequest:
    name: str = ""
    version: str = ""               # "" = latest active version
    scheduler_cluster_id: int = 0
    if_none_match: str = ""         # client's current version: matching
                                    # reply omits the blob (poll cheaply)


@message
class GetModelResponse:
    model: ModelEntity | None = None


@message
class ApplicationEntry:
    """One manager-registered application with its download priority
    (reference ``manager/models/application.go:24`` Priority JSONMap —
    the scheduler's CalculatePriority consults this when a request
    carries no explicit priority)."""

    name: str = ""
    url: str = ""
    priority: Priority = Priority.LEVEL0


@message
class ListApplicationsResponse:
    applications: list[ApplicationEntry] | None = None


@message
class TenantEntry:
    """One manager-registered tenant with its quota and default service
    class. Schedulers pull the table (``ListTenants``, on the
    applications' cadence) and enforce ``max_running`` at register with
    RESOURCE_EXHAUSTED and a retry-after hint."""

    name: str = ""
    qos_class: str = ""              # default class of the tenant's
                                     # requests that carry none
    max_running: int = 0             # concurrent running downloads
                                     # cluster-wide (0 = unlimited)
    shed_retry_after_ms: int = 0     # hint stamped on quota sheds
                                     # (0 = the scheduler's default)


@message
class ListTenantsResponse:
    tenants: list[TenantEntry] | None = None


@message
class SetSchedulerStateRequest:
    """Stopping scheduler -> manager: park this member's last exported
    quarantine/affinity summary, so the failover successor can import
    it. ``signature`` is an HMAC over ``blob`` with the cluster's
    issuance token when security is on ("" = unsigned)."""

    scheduler_id: str = ""           # exporter identity (host:port)
    cluster_id: int = 0
    blob: bytes = b""                # sealed summary (pex.seal envelope)
    signature: str = ""


@message
class GetSchedulerStateRequest:
    cluster_id: int = 0
    exclude: str = ""                # don't hand a member its own blob


@message
class GetSchedulerStateResponse:
    scheduler_id: str = ""           # "" = nothing parked
    blob: bytes = b""
    signature: str = ""
