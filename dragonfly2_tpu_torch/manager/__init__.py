"""Manager: the control plane of record.

Counterpart of ``dragonfly2_tpu/manager/`` (reference ``manager/``):
scheduler clusters, scheduler and seed-peer instances, applications,
keepalive liveness, cluster-config serving, the searcher that assigns
peers to scheduler clusters, and the model registry the trainer publishes
to and schedulers pull from, over sqlite, the port's RPC frames and an
HTTP/1.1 REST surface.
"""

from .server import Manager, ManagerConfig  # noqa: F401
