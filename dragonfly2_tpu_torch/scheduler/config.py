"""Scheduler configuration + cluster constants.

Counterpart of ``dragonfly2_tpu/scheduler/config.py`` (reference
``scheduler/config/config.go`` + ``constants.go``): every key of the
reference, with the reference's default, so a reference scheduler's file
loads. ``KEY_CLASSES`` below puts each key in one class
(``common/config.py``): wired, inert as in the reference, or unported;
``SchedulerConfig.unported()`` names the unported keys a file sets, and
the scheduler refuses to start with any. Since the fleet TLS keys were
wired, no scheduler key is unported. The relay-tree shaping is off by
default (``relay_fanout`` 0, the reference's exact path); shard affinity
and the quarantine registry are on by default, federation and the state
store off, as in the reference. ``tracing_jsonl`` and ``tracing_otlp`` turn tracing on
(``common/tracing.py``), as the reference's keys do. The constants below
are the limits' defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.config import INERT, WIRED, unported_set

# the candidate set doubles the reference's 4: piece availability flows
# only along parent->child sync streams, so the candidate limit is the
# mesh's information fan-in
CANDIDATE_PARENT_LIMIT = 8
FILTER_PARENT_LIMIT = 15

# reference scheduler/config/constants.go:63-71
DEFAULT_BACK_SOURCE_CONCURRENT = 200
RETRY_LIMIT = 5                  # declared by the reference, read nowhere
RETRY_BACK_SOURCE_LIMIT = 4      # failed reports before NeedBackSource
# scheduler-wide cap on concurrent back-source peers across all tasks,
# counted per priority class
BACK_SOURCE_TOTAL = 200

PEER_TTL_S = 24 * 3600.0
TASK_TTL_S = 24 * 3600.0
HOST_TTL_S = 6 * 3600.0
PEER_GC_INTERVAL_S = 60.0


@dataclass
class SeedPeerAddr:
    """A seed daemon the scheduler may trigger."""

    host_id: str = ""
    ip: str = "127.0.0.1"
    rpc_port: int = 0
    download_port: int = 0


@dataclass
class SchedulerConfig:
    listen_ip: str = "0.0.0.0"
    advertise_ip: str = "127.0.0.1"
    port: int = 0                          # 0 = ephemeral
    # the scheduler cluster: manager registration and keepalive, trainer
    # uploads, model lookups
    cluster_id: int = 1
    algorithm: str = "default"             # default | ml | nt
    seed_peers: list[SeedPeerAddr] = field(default_factory=list)
    candidate_parent_limit: int = CANDIDATE_PARENT_LIMIT
    filter_parent_limit: int = FILTER_PARENT_LIMIT
    manager_addresses: list[str] = field(default_factory=list)
    trainer_address: str = ""              # records upload target
    keepalive_interval_s: float = 30.0
    records_dir: str = ""                  # download-record JSONL ("" = memory-only)
    tracing_jsonl: str = ""                # span export path ("" = disabled)
    tracing_otlp: str = ""                 # OTLP/HTTP collector endpoint
    train_upload_interval_s: float = 60.0  # records -> trainer cadence
    model_refresh_interval_s: float = 60.0  # manager -> ml evaluator cadence
    # sharded-checkpoint shard affinity (scheduler/shard_affinity.py): at
    # register, a request carrying UrlMeta.shards gets the disjoint
    # tree-fetch subset of its shards (RegisterResult.assigned_shards,
    # decision_kind=shard); disabled, every daemon tree-fetches its whole
    # requested set. Parent scoring is untouched either way.
    shard_affinity_enabled: bool = True
    # upload slots per host, counted on DAG edges (each parent -> child
    # edge holds one): a parent with every slot taken is offered to no new
    # child. A host's announced ``concurrent_upload_limit`` overrides
    peer_upload_limit: int = 0             # 0 -> Host.DEFAULT_PEER_UPLOAD_LIMIT
    seed_upload_limit: int = 0             # 0 -> Host.DEFAULT_SEED_UPLOAD_LIMIT
    # relay-tree shaping (0 = off, the exact pre-relay scoring path). When
    # > 0, a parent already feeding this many direct children in the task
    # DAG is demoted behind under-cap candidates, so a cold fan-out forms
    # relay chains instead of a star on the seed (Scheduling._relay_shape;
    # cut-through serving overlaps the chain's hops, daemon/relay.py)
    relay_fanout: int = 0
    # per-class relay fan-out caps ({"bulk": 2, ...}); empty caps a bulk
    # child at half of relay_fanout (Scheduling._relay_shape)
    class_fanout_caps: dict = field(default_factory=dict)
    # a waiting critical child may evict one bulk child's edge from a
    # slot-full holder (Scheduling.preempt_for)
    qos_preemption: bool = True
    # the pod-wide peer quarantine (quarantine.py): decayed corrupt-verdict
    # mass walks a host healthy -> suspect -> quarantined -> probation;
    # quarantined -> probation after probation_delay_s without evidence,
    # probe_successes clean pieces off probe_children children climb it
    # back; min_reporters distinct reporters before a quarantine
    quarantine_enabled: bool = True
    quarantine_corrupt_threshold: float = 3.0
    quarantine_halflife_s: float = 600.0
    quarantine_probation_delay_s: float = 30.0
    quarantine_probe_successes: int = 2
    quarantine_probe_children: int = 1
    quarantine_min_reporters: int = 2
    # cross-pod federation (federation.py): per-pod seed elections, and
    # cross-pod parents only for a pod's elected seeds
    federation_enabled: bool = False
    federation_seeds_per_pod: int = 1
    # inert, as in the reference: declared there and read nowhere
    retry_limit: int = RETRY_LIMIT
    # failed piece reports before a back-source verdict
    retry_back_source_limit: int = RETRY_BACK_SOURCE_LIMIT
    # back-source peers per task, and per priority class across tasks
    back_source_concurrent: int = DEFAULT_BACK_SOURCE_CONCURRENT
    back_source_total: int = BACK_SOURCE_TOTAL
    peer_ttl_s: float = PEER_TTL_S
    task_ttl_s: float = TASK_TTL_S
    host_ttl_s: float = HOST_TTL_S
    gc_interval_s: float = PEER_GC_INTERVAL_S   # the resource GC's cadence
    # df_plugin_evaluator_<name>.py for algorithm "plugin:<name>"
    plugin_dir: str = ""
    # fleet mTLS toward security-enabled seed daemons: enroll with the
    # manager's issuer (the token also signs the state handoff)
    security_issue_token: str = ""
    security_ca_cert: str = ""             # the pinned fleet CA
    # the enrollment's certificate directory (<workdir>/scheduler-tls)
    workdir: str = ""
    # the crash-survivable control-plane state (statestore.py): one
    # snapshot under statestore_dir, persisted when dirty or every
    # interval; statestore_handoff parks a summary with the manager at a
    # graceful stop and imports the parked one at attach
    statestore_dir: str = ""
    statestore_interval_s: float = 30.0
    statestore_handoff: bool = True
    # announce-borne pulses, anomaly detection, GET /debug/fleet
    fleetpulse_enabled: bool = True

    def unported(self) -> list[str]:
        """The set keys whose subsystems this package lacks."""
        return [key for key, _item in unported_set(self, KEY_CLASSES)]


# The class of every key (common/config.py). Inert: a grep of
# dragonfly2_tpu/ finds no reader of retry_limit outside its config
# module. No key is unported: the class and its refusal stay for keys a
# later reference change adds.
KEY_CLASSES: dict[str, str] = {
    "listen_ip": WIRED,
    "advertise_ip": WIRED,
    "port": WIRED,
    "cluster_id": WIRED,
    "algorithm": WIRED,
    "seed_peers": WIRED,
    "candidate_parent_limit": WIRED,
    "filter_parent_limit": WIRED,
    "manager_addresses": WIRED,
    "trainer_address": WIRED,
    "keepalive_interval_s": WIRED,
    "records_dir": WIRED,
    "tracing_jsonl": WIRED,
    "tracing_otlp": WIRED,
    "train_upload_interval_s": WIRED,
    "model_refresh_interval_s": WIRED,
    "shard_affinity_enabled": WIRED,
    "peer_upload_limit": WIRED,
    "seed_upload_limit": WIRED,
    "relay_fanout": WIRED,
    "class_fanout_caps": WIRED,
    "qos_preemption": WIRED,
    "quarantine_enabled": WIRED,
    "quarantine_corrupt_threshold": WIRED,
    "quarantine_halflife_s": WIRED,
    "quarantine_probation_delay_s": WIRED,
    "quarantine_probe_successes": WIRED,
    "quarantine_probe_children": WIRED,
    "quarantine_min_reporters": WIRED,
    "federation_enabled": WIRED,
    "federation_seeds_per_pod": WIRED,
    "retry_limit": INERT,
    "retry_back_source_limit": WIRED,
    "back_source_concurrent": WIRED,
    "back_source_total": WIRED,
    "peer_ttl_s": WIRED,
    "task_ttl_s": WIRED,
    "host_ttl_s": WIRED,
    "gc_interval_s": WIRED,
    "plugin_dir": WIRED,
    "security_issue_token": WIRED,
    "security_ca_cert": WIRED,
    "workdir": WIRED,
    "statestore_dir": WIRED,
    "statestore_interval_s": WIRED,
    "statestore_handoff": WIRED,
    "fleetpulse_enabled": WIRED,
}
