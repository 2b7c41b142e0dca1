"""Daemon configuration.

Counterpart of ``dragonfly2_tpu/daemon/config.py``: every key of the
reference, with the reference's default, so a reference daemon's file
loads, plus ``device``: where the device sink lands bytes. ``KEY_CLASSES``
below puts each key in one class (``common/config.py``): wired, inert as
in the reference, or unported. ``DaemonConfig.unported()`` names the
unported keys a file sets; the daemon refuses to start with any.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.config import INERT, WIRED, unported, unported_set
from ..common.unit import MiB
from .qos import QosSection


@dataclass
class SchedulerConfig:
    addresses: list[str] = field(default_factory=list)  # empty: back-source only
    register_timeout_s: float = 10.0
    schedule_timeout_s: float = 30.0       # max wait for a usable peer packet
    # inert, as in the reference: declared there and read nowhere
    max_reschedule: int = 5
    # register failover: a dead hashed scheduler fails over to the next
    # ring members before the task goes to origin, and is demoted for
    # demote_s so later tasks skip it
    failover_n: int = 3                    # ring members tried per register
    demote_s: float = 30.0                 # sticky demotion window
    # cadence of the manager-discovered scheduler set's refresh; 0
    # disables. A scheduler replaced, or one that registers after this
    # daemon booted, reaches the daemon without a restart.
    refresh_interval_s: float = 30.0


@dataclass
class DownloadConfig:
    piece_parallelism: int = 4             # piece download workers per task
    back_source_parallelism: int = 4       # concurrent origin range streams
    back_source_group_min_bytes: int = 32 * MiB  # below this, one stream
    # the daemon's download budget (0 = unlimited): the traffic shaper
    # splits it by QoS class and task, and each task's bucket paces its
    # P2P fetches and its back-source reads
    total_rate_limit_bps: int = 0
    # inert, as in the reference: declared there and read nowhere
    per_peer_rate_limit_bps: int = 0
    traffic_shaper_kind: str = "sampling"  # sampling | plain
    prefetch_whole_file: bool = False      # ranged requests warm the whole task
    # inert, as in the reference: declared there and read nowhere
    first_piece_timeout_s: float = 30.0
    piece_timeout_s: float = 60.0          # per-piece deadline of a P2P fetch
    # TLS trust for https origins (private registries, custom CAs)
    source_ca: str = ""                    # extra CA bundle path
    source_insecure: bool = False          # disable verification (tests)
    # cut-through relay (daemon/relay.py): serve a piece while it is still
    # arriving. Off restores strict store-and-forward: the upload server
    # then answers 416 for incomplete ranges
    relay_enabled: bool = True
    # how long a streaming serve waits for the landing watermark to move
    # before giving up (per wait, reset on every advance)
    relay_stall_s: float = 10.0


@dataclass
class FlightConfig:
    """Download flight recorder (daemon/flight_recorder.py): the per-task
    piece-lifecycle journal behind GET /debug/flight on the upload port."""

    enabled: bool = True
    max_tasks: int = 64               # flights kept (drop-oldest)
    max_events: int = 4096            # events per flight (ring)
    max_serves: int = 1024            # serve-side edge rows per flight


@dataclass
class PexConfig:
    """Peer-exchange gossip plane (daemon/pex.py): piece discovery that
    backs the ``pex`` rung when every scheduler is unreachable. On by
    default; with no known peers a round is a no-op."""

    enabled: bool = True
    interval_s: float = 5.0           # gossip cadence (x0.6-1.4 jitter)
    fanout: int = 3                   # peers pushed to per round
    ttl_s: float = 60.0               # swarm-index entry lifetime
    bootstrap: list[str] = field(default_factory=list)  # ip:upload_port
    max_digest_tasks: int = 256       # tasks advertised per digest
    # full piece-set digests stay within the host's pod (pod_scope); a
    # pod seed also exchanges the compact completeness summary with the
    # other pods' seeds in federation_peers (ip:upload_port)
    pod_scope: bool = True
    pod_seed: bool = False
    federation_peers: list[str] = field(default_factory=list)


@dataclass
class UploadConfig:
    port: int = 0                          # 0 = ephemeral
    rate_limit_bps: int = 0                # serve rate; 0 = unlimited
    # concurrent transfers served; 0 = the upload server's default. It is
    # also announced as the host's upload slots at the scheduler
    concurrent_limit: int = 0
    debug_endpoints: bool = False          # /debug/{stacks,profile,faults}
    # upload slots bulk-class children may hold at once; 0 = the upload
    # server's default (concurrent_limit - 2, at least 1)
    bulk_concurrent_limit: int = 0


@dataclass
class TracingConfig:
    enabled: bool = False
    jsonl_path: str = ""              # "" -> <workdir>/logs/traces.jsonl
    otlp_endpoint: str = ""           # e.g. http://collector:4318
    sample_ratio: float = 1.0


@dataclass
class HealthSection:
    """Runtime health plane (common/health.py): the event-loop lag
    sampler, the coroutine watchdog and per-stage SLO budgets behind
    ``GET /debug/health``. On by default: one monitor coroutine ticking
    at ``sample_interval_s``, and a dict insert per piece group."""

    enabled: bool = True
    sample_interval_s: float = 0.1     # lag sample / watchdog sweep period
    stall_threshold_s: float = 1.0     # loop lag past this = stall event
    dump_min_interval_s: float = 10.0  # stack-dump rate limit
    # SLO budgets (ms) per download stage; <= 0 disables that budget
    slo_schedule_ms: float = 1000.0
    slo_first_byte_ms: float = 2000.0
    slo_wire_ms: float = 5000.0
    slo_hbm_ms: float = 1000.0

    def to_plane(self):
        from ..common.health import HealthConfig
        return HealthConfig(
            enabled=self.enabled,
            sample_interval_s=self.sample_interval_s,
            stall_threshold_s=self.stall_threshold_s,
            dump_min_interval_s=self.dump_min_interval_s,
            slo_schedule_ms=self.slo_schedule_ms,
            slo_first_byte_ms=self.slo_first_byte_ms,
            slo_wire_ms=self.slo_wire_ms,
            slo_hbm_ms=self.slo_hbm_ms)


@dataclass
class StorageSection:
    task_ttl_s: float = 6 * 3600.0
    disk_gc_high_ratio: float = 0.90
    disk_gc_low_ratio: float = 0.80
    capacity_bytes: int = 0
    gc_interval_s: float = 60.0
    # content-addressed store (storage/castore.py): a piece already held
    # under any task is placed, not transferred, and identical completed
    # content hardlinks to one inode. Off: storage keyed by task id only
    dedupe_enabled: bool = True
    # crc32c re-verification of reloaded pieces at boot, before the warm
    # state is served
    reload_verify: bool = True
    # serve-popularity decay half-life feeding the GC's eviction order
    popularity_halflife_s: float = 600.0


@dataclass
class SecurityConfig:
    """Fleet mTLS with manager-issued certificates: unported (item 6)."""

    enabled: bool = False
    issue_token: str = ""
    issue_token_path: str = ""
    ca_cert: str = ""
    cert_validity_s: int = 7 * 24 * 3600
    tls_policy: str = "force"

    def validate(self) -> None:
        if self.tls_policy not in ("default", "prefer", "force"):
            raise ValueError(
                f"security.tls_policy must be default|prefer|force, "
                f"got {self.tls_policy!r}")


@dataclass
class ProxyConfig:
    """The registry mirror proxy: unported (item 6)."""

    enabled: bool = False
    port: int = 0
    registry_mirror: str = ""
    rules: list[str] = field(default_factory=list)
    direct_rules: list[str] = field(default_factory=list)
    hijack: bool = False
    hijack_hosts: list[str] = field(default_factory=list)
    ca_cert: str = ""
    ca_key: str = ""
    sni_port: int = 0
    verify_upstream: bool = True


@dataclass
class ObjectStorageConfig:
    """The object-storage gateway: unported (item 6)."""

    enabled: bool = False
    port: int = 0
    buckets: dict[str, str] = field(default_factory=dict)
    backends: dict[str, dict] = field(default_factory=dict)


@dataclass
class DaemonConfig:
    workdir: str = ""
    host_ip: str = ""                      # advertised to peers; "" = detect
    listen_ip: str = "0.0.0.0"             # servers bind here
    hostname: str = ""
    is_seed: bool = False
    rpc_port: int = 0                      # peer RPC (0 = ephemeral)
    unix_sock: str = ""                    # local API socket; "" = workdir
    manager_addresses: list[str] = field(default_factory=list)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    download: DownloadConfig = field(default_factory=DownloadConfig)
    upload: UploadConfig = field(default_factory=UploadConfig)
    storage: StorageSection = field(default_factory=StorageSection)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    flight: FlightConfig = field(default_factory=FlightConfig)
    health: HealthSection = field(default_factory=HealthSection)
    pex: PexConfig = field(default_factory=PexConfig)
    security: SecurityConfig = field(default_factory=SecurityConfig)
    proxy: ProxyConfig = field(default_factory=ProxyConfig)
    object_storage: ObjectStorageConfig = field(
        default_factory=ObjectStorageConfig)
    qos: QosSection = field(default_factory=QosSection)
    # host stats to the scheduler, and the recovery re-announce's cadence
    announce_interval_s: float = 30.0
    probe_enabled: bool = True             # RTT probing via SyncProbes
    # inert, as in the reference: declared there and read nowhere
    metrics_port: int = 0
    plugin_dir: str = ""                   # unported (item 5d)
    # "cuda": every CUDA device of the host (an error when there is none);
    # "cpu": one CPU device, only when named
    device: str = "cuda"

    def unported(self) -> list[str]:
        """The set keys whose subsystems this package lacks."""
        return [key for key, _item in unported_set(self, KEY_CLASSES)]


# The class of every key (common/config.py). Inert: a grep of
# dragonfly2_tpu/ finds no reader of scheduler.max_reschedule,
# download.per_peer_rate_limit_bps, download.first_piece_timeout_s or
# metrics_port outside its config module. Unported, by ROADMAP Queue 1
# item: fleet mTLS, the proxy and the object gateway (6), source plugins
# (5d). ``device`` is the port's own.
KEY_CLASSES: dict[str, str] = {
    "workdir": WIRED,
    "host_ip": WIRED,
    "listen_ip": WIRED,
    "hostname": WIRED,
    "is_seed": WIRED,
    "rpc_port": WIRED,
    "unix_sock": WIRED,
    "manager_addresses": WIRED,
    "scheduler.addresses": WIRED,
    "scheduler.register_timeout_s": WIRED,
    "scheduler.schedule_timeout_s": WIRED,
    "scheduler.max_reschedule": INERT,
    "scheduler.failover_n": WIRED,
    "scheduler.demote_s": WIRED,
    "scheduler.refresh_interval_s": WIRED,
    "download.piece_parallelism": WIRED,
    "download.back_source_parallelism": WIRED,
    "download.back_source_group_min_bytes": WIRED,
    "download.total_rate_limit_bps": WIRED,
    "download.per_peer_rate_limit_bps": INERT,
    "download.traffic_shaper_kind": WIRED,
    "download.prefetch_whole_file": WIRED,
    "download.first_piece_timeout_s": INERT,
    "download.piece_timeout_s": WIRED,
    "download.source_ca": WIRED,
    "download.source_insecure": WIRED,
    "download.relay_enabled": WIRED,
    "download.relay_stall_s": WIRED,
    "upload.port": WIRED,
    "upload.rate_limit_bps": WIRED,
    "upload.concurrent_limit": WIRED,
    "upload.debug_endpoints": WIRED,
    "upload.bulk_concurrent_limit": WIRED,
    "storage.task_ttl_s": WIRED,
    "storage.disk_gc_high_ratio": WIRED,
    "storage.disk_gc_low_ratio": WIRED,
    "storage.capacity_bytes": WIRED,
    "storage.gc_interval_s": WIRED,
    "storage.dedupe_enabled": WIRED,
    "storage.reload_verify": WIRED,
    "storage.popularity_halflife_s": WIRED,
    "tracing.enabled": WIRED,
    "tracing.jsonl_path": WIRED,
    "tracing.otlp_endpoint": WIRED,
    "tracing.sample_ratio": WIRED,
    "flight.enabled": WIRED,
    "flight.max_tasks": WIRED,
    "flight.max_events": WIRED,
    "flight.max_serves": WIRED,
    "health.enabled": WIRED,
    "health.sample_interval_s": WIRED,
    "health.stall_threshold_s": WIRED,
    "health.dump_min_interval_s": WIRED,
    "health.slo_schedule_ms": WIRED,
    "health.slo_first_byte_ms": WIRED,
    "health.slo_wire_ms": WIRED,
    "health.slo_hbm_ms": WIRED,
    "pex.enabled": WIRED,
    "pex.interval_s": WIRED,
    "pex.fanout": WIRED,
    "pex.ttl_s": WIRED,
    "pex.bootstrap": WIRED,
    "pex.max_digest_tasks": WIRED,
    "pex.pod_scope": WIRED,
    "pex.pod_seed": WIRED,
    "pex.federation_peers": WIRED,
    "security.enabled": unported("6"),
    "security.issue_token": unported("6"),
    "security.issue_token_path": unported("6"),
    "security.ca_cert": unported("6"),
    "security.cert_validity_s": unported("6"),
    "security.tls_policy": unported("6"),
    "proxy.enabled": unported("6"),
    "proxy.port": unported("6"),
    "proxy.registry_mirror": unported("6"),
    "proxy.rules": unported("6"),
    "proxy.direct_rules": unported("6"),
    "proxy.hijack": unported("6"),
    "proxy.hijack_hosts": unported("6"),
    "proxy.ca_cert": unported("6"),
    "proxy.ca_key": unported("6"),
    "proxy.sni_port": unported("6"),
    "proxy.verify_upstream": unported("6"),
    "object_storage.enabled": unported("6"),
    "object_storage.port": unported("6"),
    "object_storage.buckets": unported("6"),
    "object_storage.backends": unported("6"),
    "qos.enabled": WIRED,
    "qos.bulk_active_limit": WIRED,
    "qos.brownout_critical_threshold": WIRED,
    "qos.queue_wait_s": WIRED,
    "qos.queue_limit": WIRED,
    "qos.shed_retry_after_ms": WIRED,
    "announce_interval_s": WIRED,
    "probe_enabled": WIRED,
    "metrics_port": INERT,
    "plugin_dir": unported("5d"),
    "device": WIRED,
}
