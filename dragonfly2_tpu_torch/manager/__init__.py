"""Manager: the control plane of record.

Counterpart of ``dragonfly2_tpu/manager/`` (reference ``manager/``):
scheduler clusters, scheduler and seed-peer instances, applications,
keepalive liveness, cluster-config serving and its REST patch, the
searcher that assigns peers to scheduler clusters, the model registry the
trainer publishes to and schedulers pull from, the preheat and
sync-peers jobs, kept in the database and resumed after a crash, and the
REST surface's auth (sessions, RBAC, personal access tokens, OAuth
sign-in, the per-identity quota), over sqlite, the port's RPC frames and
an HTTP/1.1 REST surface.
"""

from .server import Manager, ManagerConfig  # noqa: F401
