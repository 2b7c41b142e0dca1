"""Client link to the manager: registration, discovery, keepalive, models
and the schedulers' handoff state.

Counterpart of ``dragonfly2_tpu/rpc/manager_link.py`` (reference
``pkg/rpc/manager/client`` + the keepalive goroutines of the scheduler's
and seed peer's announcers). Shared by the scheduler (register itself,
find seed peers, pull models), the daemon (find schedulers; a seed daemon
registers as a seed peer) and the trainer (publish models). Every call
tries each configured manager address before giving up.
"""

from __future__ import annotations

import asyncio
import logging

from ..idl.messages import (CreateModelRequest, Empty, GetModelRequest,
                            GetModelResponse, GetSchedulersRequest,
                            GetSchedulersResponse, GetSchedulerStateRequest,
                            GetSchedulerStateResponse, GetSeedPeersRequest,
                            GetSeedPeersResponse, KeepAliveRequest,
                            ListApplicationsResponse,
                            SetSchedulerStateRequest)
from .client import Channel, ServiceClient

log = logging.getLogger("df.rpc.mgrlink")

MANAGER_SERVICE = "df.manager.Manager"


class ManagerLink:
    def __init__(self, addresses: list[str], *,
                 keepalive_interval_s: float = 15.0):
        self.addresses = list(addresses)
        self.keepalive_interval_s = keepalive_interval_s
        self._channel: Channel | None = None
        self._addr_idx = 0
        self._keepalive_task: asyncio.Task | None = None

    def _client(self) -> ServiceClient:
        if self._channel is None:
            addr = self.addresses[self._addr_idx % len(self.addresses)]
            self._channel = Channel(addr)
        return ServiceClient(self._channel, MANAGER_SERVICE)

    async def _failover(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None
        self._addr_idx += 1

    async def _unary(self, method: str, req, *, timeout: float = 10.0):
        """Try every configured manager address before giving up — an HA
        pair with a dead first address must not look globally down."""
        last: Exception | None = None
        for _ in range(max(1, len(self.addresses))):
            try:
                return await self._client().unary(method, req,
                                                  timeout=timeout)
            except Exception as exc:  # noqa: BLE001 - rotate and retry
                last = exc
                await self._failover()
        raise last  # type: ignore[misc]

    # -- calls ---------------------------------------------------------

    async def register_scheduler(self, req) -> None:
        await self._unary("RegisterScheduler", req)

    async def register_seed_peer(self, req) -> None:
        await self._unary("RegisterSeedPeer", req)

    async def get_schedulers(self, req: GetSchedulersRequest
                             ) -> GetSchedulersResponse:
        return await self._unary("GetSchedulers", req)

    async def get_seed_peers(self, cluster_id: int = 0) -> GetSeedPeersResponse:
        return await self._unary(
            "GetSeedPeers", GetSeedPeersRequest(cluster_id=cluster_id))

    async def list_applications(self) -> ListApplicationsResponse:
        return await self._unary("ListApplications", Empty())

    async def set_scheduler_state(self, req: SetSchedulerStateRequest
                                  ) -> None:
        """Park this scheduler's quarantine/affinity summary (handoff)."""
        await self._unary("SetSchedulerState", req)

    async def get_scheduler_state(self, req: GetSchedulerStateRequest
                                  ) -> GetSchedulerStateResponse:
        return await self._unary("GetSchedulerState", req)

    async def create_model(self, req: CreateModelRequest) -> None:
        await self._unary("CreateModel", req, timeout=60.0)

    async def get_model(self, req: GetModelRequest) -> GetModelResponse:
        return await self._unary("GetModel", req, timeout=60.0)

    # -- keepalive -----------------------------------------------------

    def start_keepalive(self, *, source_type: str, hostname: str, ip: str,
                        cluster_id: int = 0, port: int = 0) -> None:
        if self._keepalive_task is None:
            self._keepalive_task = asyncio.get_running_loop().create_task(
                self._keepalive_loop(source_type, hostname, ip, cluster_id,
                                     port))

    async def _keepalive_loop(self, source_type: str, hostname: str, ip: str,
                              cluster_id: int, port: int) -> None:
        while True:
            try:
                stream_started = asyncio.get_running_loop().time()

                async def beats():
                    while True:
                        yield KeepAliveRequest(source_type=source_type,
                                               hostname=hostname, ip=ip,
                                               cluster_id=cluster_id,
                                               port=port)
                        await asyncio.sleep(self.keepalive_interval_s)

                await self._client().stream_unary("KeepAlive", beats())
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - manager away; retry
                log.debug("keepalive stream error: %s", exc)
                # fast failure right after connect: rotate to the next address
                if (asyncio.get_running_loop().time() - stream_started
                        < self.keepalive_interval_s):
                    await self._failover()
            await asyncio.sleep(min(5.0, self.keepalive_interval_s))

    async def close(self) -> None:
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
            try:
                await self._keepalive_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        if self._channel is not None:
            await self._channel.close()
