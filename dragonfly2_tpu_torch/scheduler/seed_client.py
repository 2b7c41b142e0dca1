"""Seed-peer control: trigger the root of the piece tree to back-source.

Counterpart of ``dragonfly2_tpu/scheduler/seed_client.py`` (reference
``scheduler/resource/seed_peer.go`` ``TriggerTask`` :101): the scheduler
opens ``ObtainSeeds`` on a seed daemon chosen by hashing the task id and
folds the piece announcements into its resource state, so the seed is a
schedulable parent while it is still downloading.
"""

from __future__ import annotations

import asyncio
import logging

from ..idl.messages import Host as HostMsg
from ..idl.messages import HostType, ObtainSeedsRequest, UrlMeta
from ..rpc.balancer import HashRing
from ..rpc.client import ChannelPool, ServiceClient
from .config import SeedPeerAddr
from .resource import Peer, PeerState, Resource, Task

log = logging.getLogger("df.sched.seed")

SEEDER_SERVICE = "df.daemon.Seeder"


class SeedPeerClient:
    def __init__(self, resource: Resource, seed_peers: list[SeedPeerAddr]):
        self.resource = resource
        self.seed_peers = {self._host_id(s): s for s in seed_peers}
        self._ring = HashRing(list(self.seed_peers))
        self._channels = ChannelPool(limit=32)

    @staticmethod
    def _host_id(s: SeedPeerAddr) -> str:
        return s.host_id or f"seed-{s.ip}:{s.rpc_port}"

    def available(self) -> bool:
        return bool(self.seed_peers)

    async def trigger(self, task: Task, url_meta: UrlMeta | None) -> None:
        """Run one seed download to completion, folding piece announcements
        into the task as they arrive. Exceptions are contained: a failed
        seed leaves the task unseeded and peers fall back to origin."""
        hid = self._ring.pick(task.id)
        if hid is None:
            return
        seed = self.seed_peers[hid]
        host = self.resource.store_host(HostMsg(
            id=hid, ip=seed.ip, hostname=hid, port=seed.rpc_port,
            download_port=seed.download_port, type=HostType.SUPER_SEED,
            concurrent_upload_limit=0))  # 0 = auto -> the seed default
        client = ServiceClient(
            self._channels.get(f"{seed.ip}:{seed.rpc_port}"), SEEDER_SERVICE)
        seed_peer: Peer | None = None
        try:
            stream = client.unary_stream("ObtainSeeds", ObtainSeedsRequest(
                url=task.url, url_meta=url_meta, task_id=task.id))
            async for piece_seed in stream:
                if seed_peer is None:
                    peer_id = piece_seed.peer_id or f"{hid}-seedpeer"
                    seed_peer = self.resource.get_or_create_peer(
                        peer_id, task, host)
                    if seed_peer.state == PeerState.PENDING:
                        seed_peer.transit(PeerState.RUNNING)
                task.set_content_info(piece_seed.content_length, 0,
                                      piece_seed.total_piece_count)
                if piece_seed.piece_info is not None:
                    task.record_piece(piece_seed.piece_info)
                    seed_peer.finished_pieces.add(
                        piece_seed.piece_info.piece_num)
                    seed_peer.touch()
                if piece_seed.done:
                    seed_peer.transit(PeerState.SUCCEEDED)
                    log.info("seed %s complete for task %s (%d pieces)",
                             hid, task.id[:12], len(seed_peer.finished_pieces))
                    return
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - seed failure is survivable
            log.warning("seed trigger for task %s failed: %s", task.id[:12],
                        exc)
            if seed_peer is not None and not seed_peer.is_done():
                try:
                    seed_peer.transit(PeerState.FAILED)
                except Exception:  # noqa: BLE001
                    pass

    async def close(self) -> None:
        await self._channels.close()
