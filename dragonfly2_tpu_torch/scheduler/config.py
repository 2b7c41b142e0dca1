"""Scheduler configuration + cluster constants.

Counterpart of ``dragonfly2_tpu/scheduler/config.py`` cut to the
deployment settings (listeners, the static seed-peer list,
the evaluator algorithm, the manager and trainer addresses, the records
directory), the learned loop's cadences and the per-host upload-slot
limits; the other limits the register -> schedule -> report path honours
are the reference's defaults, as constants (reference
``scheduler/config/config.go`` + ``constants.go``).
The relay-tree shaping is off by default (``relay_fanout`` 0, the
reference's exact path); shard affinity is on by default, as in the
reference; the control plane's other extras (quarantine, federation,
fleet pulse, state store) wait for later slices. ``tracing_jsonl`` and
``tracing_otlp`` turn tracing on (``common/tracing.py``), as the
reference's keys do.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# the candidate set doubles the reference's 4: piece availability flows
# only along parent->child sync streams, so the candidate limit is the
# mesh's information fan-in
CANDIDATE_PARENT_LIMIT = 8
FILTER_PARENT_LIMIT = 15

# reference scheduler/config/constants.go:63-71
DEFAULT_BACK_SOURCE_CONCURRENT = 200
RETRY_BACK_SOURCE_LIMIT = 4      # failed reports before NeedBackSource
# scheduler-wide cap on concurrent back-source peers across all tasks,
# counted per priority class
BACK_SOURCE_TOTAL = 200

PEER_TTL_S = 24 * 3600.0
TASK_TTL_S = 24 * 3600.0
HOST_TTL_S = 6 * 3600.0
PEER_GC_INTERVAL_S = 60.0

CLUSTER_ID = 1                   # scheduler cluster: registration, uploads


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
    algorithm: str = "default"             # default | ml | nt
    seed_peers: list[SeedPeerAddr] = field(default_factory=list)
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
