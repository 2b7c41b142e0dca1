"""Manager RPC service.

Counterpart of ``dragonfly2_tpu/manager/service.py`` (reference
``manager/rpcserver/``): GetSchedulers (searcher-driven cluster pick plus
the cluster's config), GetSeedPeers, ListApplications, the
self-registration RPCs schedulers and seed peers call on boot, the
KeepAlive client stream (``manager_server_v2.go:737``) and the model
registry (CreateModel, GetModel) and the schedulers' handoff relay
(SetSchedulerState, GetSchedulerState: an opaque blob parked per
scheduler, the freshest other member's handed back). ListTenants and
IssueCertificate wait for later slices.
"""

from __future__ import annotations

import asyncio
import json
import logging

from ..common.errors import Code, DFError
from ..idl.messages import (ApplicationEntry, CreateModelRequest, Empty,
                            GetModelRequest, GetModelResponse,
                            GetSchedulersRequest, GetSchedulersResponse,
                            GetSchedulerStateRequest,
                            GetSchedulerStateResponse,
                            GetSeedPeersRequest, GetSeedPeersResponse,
                            ListApplicationsResponse, ModelEntity, Priority,
                            RegisterSchedulerRequest,
                            RegisterSeedPeerRequest,
                            SetSchedulerStateRequest)
from ..rpc.server import ServiceDef
from .searcher import find_scheduler_cluster
from .store import Store

log = logging.getLogger("df.mgr.service")

MANAGER_SERVICE = "df.manager.Manager"


class ManagerService:
    def __init__(self, store: Store):
        self.store = store

    async def get_schedulers(self, req: GetSchedulersRequest,
                             context) -> GetSchedulersResponse:
        clusters = await asyncio.to_thread(self.store.scheduler_clusters)
        cluster_id = find_scheduler_cluster(clusters, req)
        if cluster_id is None:
            raise DFError(Code.NOT_FOUND, "no scheduler clusters")
        schedulers = await asyncio.to_thread(
            lambda: self.store.schedulers(cluster_id=cluster_id,
                                          only_active=True))
        return GetSchedulersResponse(
            schedulers=schedulers,
            cluster_config=await asyncio.to_thread(
                self.store.cluster_config, cluster_id))

    async def get_seed_peers(self, req: GetSeedPeersRequest,
                             context) -> GetSeedPeersResponse:
        peers = await asyncio.to_thread(
            lambda: self.store.seed_peers(
                cluster_id=req.cluster_id or None, only_active=True))
        return GetSeedPeersResponse(seed_peers=peers)

    async def list_applications(self, req, context
                                ) -> ListApplicationsResponse:
        """Applications and their priorities for the schedulers (reference
        ListApplications consumed by ``Peer.CalculatePriority``). The
        priority persists as a JSON map (``{"value": N}``)."""
        rows = await asyncio.to_thread(self.store.applications)
        out = []
        for r in rows:
            # one malformed row must not fail the whole table: parse and
            # clamp per entry, default LEVEL0
            try:
                prio = int(json.loads(r.get("priority") or "{}")
                           .get("value", 0))
            except (ValueError, TypeError, AttributeError):
                prio = 0
            prio = min(max(prio, int(Priority.LEVEL0)), int(Priority.LEVEL6))
            out.append(ApplicationEntry(
                name=r["name"], url=r.get("url", "") or "",
                priority=Priority(prio)))
        return ListApplicationsResponse(applications=out)

    async def register_scheduler(self, req: RegisterSchedulerRequest,
                                 context) -> Empty:
        cluster_id = req.scheduler_cluster_id or \
            await asyncio.to_thread(self.store.default_scheduler_cluster)
        await asyncio.to_thread(
            lambda: self.store.upsert_scheduler(
                hostname=req.hostname, ip=req.ip, port=req.port,
                cluster_id=cluster_id, topology=req.topology))
        return Empty()

    async def register_seed_peer(self, req: RegisterSeedPeerRequest,
                                 context) -> Empty:
        cluster_id = req.seed_peer_cluster_id or 1
        await asyncio.to_thread(
            lambda: self.store.upsert_seed_peer(
                hostname=req.hostname, ip=req.ip, port=req.port,
                download_port=req.download_port,
                object_storage_port=req.object_storage_port,
                type_=req.type or "super", cluster_id=cluster_id,
                topology=req.topology))
        return Empty()

    # -- scheduler handoff relay (control-plane failover) --------------

    async def set_scheduler_state(self, req: SetSchedulerStateRequest,
                                  context) -> Empty:
        """Park a stopping scheduler's state summary. The blob is opaque
        and its signature is verified by the importer: a relay can drop a
        handoff but cannot forge one."""
        if not req.scheduler_id or not req.blob:
            raise DFError(Code.INVALID_ARGUMENT,
                          "scheduler_id and blob required")
        await asyncio.to_thread(
            lambda: self.store.park_scheduler_state(
                cluster_id=req.cluster_id, scheduler_id=req.scheduler_id,
                blob=req.blob, signature=req.signature))
        return Empty()

    async def get_scheduler_state(self, req: GetSchedulerStateRequest,
                                  context) -> GetSchedulerStateResponse:
        row = await asyncio.to_thread(
            lambda: self.store.latest_scheduler_state(
                cluster_id=req.cluster_id, exclude=req.exclude))
        if row is None:
            return GetSchedulerStateResponse()
        return GetSchedulerStateResponse(
            scheduler_id=row["scheduler_id"], blob=row["blob"],
            signature=row["signature"])

    # -- model registry (reference manager/models/model.go:36) ---------

    async def create_model(self, req: CreateModelRequest, context) -> Empty:
        if not req.name or not req.version or not req.data:
            raise DFError(Code.INVALID_ARGUMENT,
                          "name, version, data required")
        await asyncio.to_thread(
            lambda: self.store.create_model(
                name=req.name, version=req.version, data=req.data,
                metrics=req.metrics,
                scheduler_cluster_id=req.scheduler_cluster_id))
        log.info("model registered: %s@%s (%d bytes)", req.name, req.version,
                 len(req.data))
        return Empty()

    async def get_model(self, req: GetModelRequest,
                        context) -> GetModelResponse:
        row = await asyncio.to_thread(
            lambda: self.store.get_model(
                req.name, version=req.version,
                scheduler_cluster_id=req.scheduler_cluster_id))
        if row is None:
            return GetModelResponse(model=None)
        # the caller already holds this version: answer without the blob
        unchanged = bool(req.if_none_match
                         and row["version"] == req.if_none_match)
        return GetModelResponse(model=ModelEntity(
            id=row["id"], name=row["name"], version=row["version"],
            state=row["state"],
            scheduler_cluster_id=row["scheduler_cluster_id"],
            metrics=row["metrics"],
            data=b"" if unchanged else row["data"],
            created_at=row["created_at"]))

    async def keep_alive(self, request_iter, context) -> Empty:
        """Client stream: one message per interval; the instance goes
        inactive when the stream dies and the TTL sweep catches it."""
        ident = None
        async for req in request_iter:
            ident = (req.source_type, req.hostname, req.ip)
            ok = await asyncio.to_thread(
                self.store.keepalive, req.source_type, req.hostname, req.ip,
                req.port)
            if not ok:
                log.warning("keepalive from unregistered %s %s@%s",
                            req.source_type, req.hostname, req.ip)
        if ident:
            log.info("keepalive stream ended: %s %s@%s", *ident)
        return Empty()


def build_service(svc: ManagerService) -> ServiceDef:
    d = ServiceDef(MANAGER_SERVICE)
    d.unary_unary("GetSchedulers", svc.get_schedulers)
    d.unary_unary("GetSeedPeers", svc.get_seed_peers)
    d.unary_unary("ListApplications", svc.list_applications)
    d.unary_unary("RegisterScheduler", svc.register_scheduler)
    d.unary_unary("RegisterSeedPeer", svc.register_seed_peer)
    d.stream_unary("KeepAlive", svc.keep_alive)
    d.unary_unary("SetSchedulerState", svc.set_scheduler_state)
    d.unary_unary("GetSchedulerState", svc.get_scheduler_state)
    d.unary_unary("CreateModel", svc.create_model)
    d.unary_unary("GetModel", svc.get_model)
    return d
