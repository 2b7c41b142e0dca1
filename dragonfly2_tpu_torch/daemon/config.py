"""Daemon configuration.

Counterpart of ``dragonfly2_tpu/daemon/config.py`` cut to the deployment
settings the port honors (manager and scheduler addresses, the register
timeout and ring failover, the schedule timeout, the scheduler-set
refresh, ports, listeners, workdir, the storage section's GC, dedupe and
reload settings, RTT probing, the announce cadence, the PEX gossip
plane, the flight recorder's limits, the cut-through relay switch, the
https origins' trust, the upload port's debug endpoints, tracing and the
health plane), plus ``device``: where the device sink lands bytes. The
reference's tuning knobs that no caller of the port sets yet
are module constants where they are used.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.unit import MiB


@dataclass
class SchedulerConfig:
    addresses: list[str] = field(default_factory=list)  # empty: back-source only
    register_timeout_s: float = 10.0
    schedule_timeout_s: float = 30.0       # max wait for a usable peer packet
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
    back_source_parallelism: int = 4       # concurrent origin range streams
    back_source_group_min_bytes: int = 32 * MiB  # below this, one stream
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
    debug_endpoints: bool = False          # /debug/{stacks,profile,faults}


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
    # host stats to the scheduler, and the recovery re-announce's cadence
    announce_interval_s: float = 30.0
    probe_enabled: bool = True             # RTT probing via SyncProbes
    # "cuda": every CUDA device of the host (an error when there is none);
    # "cpu": one CPU device, only when named
    device: str = "cuda"
