"""Daemon RPC services.

Counterpart of ``dragonfly2_tpu/daemon/rpcserver.py`` (reference
``client/daemon/rpcserver/rpcserver.go``): the local API (``Download``
server stream, ``StatTask``, ``DeleteTask``), the peer API
(``GetPieceTasks`` and the ``SyncPieceTasks`` bidi stream) and the
seeder's ``ObtainSeeds``. A seed announces every piece to every child, as
the reference's seeds do; its super-seed rationing, ``ImportTask`` and
``ExportTask`` wait for a later slice.

Announce-ahead (the control-plane half of cut-through relay,
``relay.py``): pieces in flight on this daemon ride ``piece_infos`` with
their numbers in ``relay_nums``, and every packet carries the holder's
``progress`` (pieces landed). A child that pulls one is served to the
landing watermark by the upload server's streaming path. Unlike the
reference, whose seeds ration announcements through the super-seed path
and announce nothing ahead, a seed here announces ahead like any holder,
so it is the first hop of a chain.
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator

from ..common.errors import Code, DFError
from ..idl.messages import (DeleteTaskRequest, DownloadRequest, Empty,
                            ObtainSeedsRequest, PiecePacket, PieceSeed,
                            PieceTaskRequest, StatTaskDaemonRequest, TaskStat,
                            UrlMeta)
from ..rpc.server import ServiceDef
from .config import SchedulerConfig
from .peertask_manager import PeerTaskManager

log = logging.getLogger("df.rpc.daemon")

# a geometry-less task's piece sync waits at most a register's time
REGISTER_TIMEOUT_S = SchedulerConfig.register_timeout_s

DAEMON_SERVICE = "df.daemon.Daemon"
SEEDER_SERVICE = "df.daemon.Seeder"


class DaemonService:
    """Wire handlers; delegation to PeerTaskManager + storage."""

    def __init__(self, ptm: PeerTaskManager, *, upload_addr: str = ""):
        self.ptm = ptm
        self.upload_addr = upload_addr

    # -- local API -----------------------------------------------------

    async def download(self, request: DownloadRequest,
                       context) -> AsyncIterator:
        if request.recursive:
            raise DFError(Code.INVALID_ARGUMENT,
                          "recursive downloads are not supported")
        async for resp in self.ptm.start_file_task(request):
            yield resp

    async def stat_task(self, request: StatTaskDaemonRequest,
                        context) -> TaskStat:
        task_id = request.task_id or self.ptm._task_id(
            request.url, request.url_meta or UrlMeta())
        return await self.ptm.stat_task(task_id)

    async def delete_task(self, request: DeleteTaskRequest, context) -> Empty:
        task_id = request.task_id or self.ptm._task_id(
            request.url, request.url_meta or UrlMeta())
        await self.ptm.delete_task(task_id)
        return Empty()

    # -- peer API ------------------------------------------------------

    def _storage_for(self, task_id: str):
        ts = self.ptm.storage_mgr.get(task_id)
        if ts is None:
            conductor = self.ptm.conductor(task_id)
            if conductor is not None:
                ts = conductor.storage
        return ts

    def _relay_ahead(self, task_id: str, known: set[int],
                     start_num: int = 0) -> list:
        """Announce-ahead infos: pieces in flight on this daemon now."""
        relay = getattr(self.ptm, "relay", None)
        if relay is None:
            return []
        return [i for i in relay.inflight_infos(task_id)
                if i.piece_num not in known and i.piece_num >= start_num]

    def _packet(self, request: PieceTaskRequest, ts, infos: list,
                ahead: list | None = None) -> PiecePacket:
        md = ts.md
        ahead = ahead or []
        return PiecePacket(task_id=request.task_id,
                           dst_peer_id=request.dst_peer_id,
                           dst_addr=self.upload_addr,
                           piece_infos=infos + ahead,
                           total_piece_count=md.total_piece_count,
                           content_length=md.content_length,
                           piece_size=md.piece_size,
                           progress=len(md.pieces),
                           relay_nums=([i.piece_num for i in ahead]
                                       or None))

    async def get_piece_tasks(self, request: PieceTaskRequest,
                              context) -> PiecePacket:
        ts = self._storage_for(request.task_id)
        if ts is None:
            raise DFError(Code.NOT_FOUND,
                          f"task {request.task_id[:12]} unknown")
        infos = [p.to_info() for p in ts.piece_infos(request.start_num,
                                                      request.limit)]
        ahead = self._relay_ahead(
            request.task_id, {p.piece_num for p in infos} | set(ts.md.pieces),
            request.start_num)
        return self._packet(request, ts, infos, ahead)

    def _packet_for_nums(self, request: PieceTaskRequest, ts,
                         nums: list[int], relay_nums: list[int]
                         ) -> PiecePacket:
        """Announcement packet carrying exactly ``nums`` plus the
        ``relay_nums`` still in flight (announce-ahead); a relay piece
        that landed while queued goes out as landed."""
        infos = [ts.md.pieces[n].to_info() for n in nums
                 if n in ts.md.pieces]
        ahead = []
        if relay_nums:
            live = {i.piece_num: i for i in self._relay_ahead(
                request.task_id, set(ts.md.pieces))}
            for n in relay_nums:
                p = ts.md.pieces.get(n)
                if p is not None:
                    infos.append(p.to_info())
                elif n in live:
                    ahead.append(live[n])
                # else: the span died between the event and this packet
                # (failed transfer, corrupt landing); the caller un-marks
                # it as sent so its eventual landing announces it
        return self._packet(request, ts, infos, ahead)

    @staticmethod
    def _drain(q: asyncio.Queue, first) -> list:
        """One awaited event plus everything already queued behind it:
        under load, announcements batch into one packet per wakeup."""
        events = [first]
        while True:
            try:
                events.append(q.get_nowait())
            except asyncio.QueueEmpty:
                return events

    async def sync_piece_tasks(self, request_iter,
                               context) -> AsyncIterator:
        """Bidi: each request asks for piece metadata; responses stream as
        pieces land (pushed on arrival for running tasks, batched per
        wakeup). ``sent`` lives across requests on one stream: follow-up
        requests are starvation pings, and answering each with the full
        list again would flood a starving swarm."""
        sent: set[int] = set()
        first_packet = True
        async for request in request_iter:
            conductor = self.ptm.conductor(request.task_id)
            if conductor is not None and conductor.storage is None:
                # a running task that does not know its geometry yet (a
                # replica registered together with this child): answer once
                # it does. NOT_FOUND would make the child drop a parent
                # that is about to hold the pieces it swaps for. A task
                # that learns nothing in a register's time (torn down
                # before it knew) is answered NOT_FOUND below
                try:
                    await asyncio.wait_for(conductor.storage_ready.wait(),
                                           REGISTER_TIMEOUT_S)
                except asyncio.TimeoutError:
                    pass
            # subscribe before the snapshot: a piece landing while the
            # snapshot is on the wire is then announced by its event
            q = (conductor.subscribe() if conductor is not None
                 and not conductor.done_event.is_set() else None)
            try:
                packet = await self.get_piece_tasks(request, context)
                packet.piece_infos = [p for p in packet.piece_infos or []
                                      if p.piece_num not in sent]
                kept = {p.piece_num for p in packet.piece_infos}
                packet.relay_nums = [n for n in packet.relay_nums or []
                                     if n in kept] or None
                sent.update(kept)
                if packet.piece_infos or first_packet:
                    first_packet = False
                    yield packet
                if q is None:
                    continue
                # live task: push updates until done
                done = False
                while not done:
                    nums: list[int] = []
                    relay_nums: list[int] = []
                    for event in self._drain(q, await q.get()):
                        if (event["type"] == "piece"
                                and event["num"] not in sent):
                            sent.add(event["num"])
                            nums.append(event["num"])
                        elif event["type"] == "relay":
                            # announce-ahead: arriving on this daemon now
                            for n in event["nums"]:
                                if n not in sent:
                                    sent.add(n)
                                    relay_nums.append(n)
                        elif event["type"] == "done":
                            done = True
                    ts = self._storage_for(request.task_id)
                    if ts is None:
                        break
                    if done:
                        # the final geometry and every piece not sent yet
                        # (a relay piece announced ahead is sent; its
                        # landed info carries the same range)
                        infos = [p.to_info() for p in ts.piece_infos()
                                 if p.num not in sent]
                        sent.update(p.piece_num for p in infos)
                        yield self._packet(request, ts, infos)
                    elif nums or relay_nums:
                        packet = self._packet_for_nums(request, ts, nums,
                                                       relay_nums)
                        announced = {p.piece_num
                                     for p in packet.piece_infos or []}
                        for n in relay_nums:
                            if n not in announced:
                                sent.discard(n)
                        if packet.piece_infos:
                            yield packet
            finally:
                if q is not None:
                    conductor.unsubscribe(q)

    # -- seeder API ----------------------------------------------------

    async def obtain_seeds(self, request: ObtainSeedsRequest,
                           context) -> AsyncIterator:
        """Trigger a seed download and stream its piece announcements
        (the scheduler's seed-peer client consumes them). The download
        does not register with the scheduler, which already tracks it
        through this stream: registered, a seed that knows its scheduler
        was offered its first leecher as a parent while that leecher
        waited on it, in both packages."""
        conductor = await self.ptm.get_or_create_conductor(
            request.url, request.url_meta or UrlMeta(), register=False)
        q = conductor.subscribe()
        try:
            if conductor.storage is not None:      # pieces already landed
                for p in conductor.storage.piece_infos():
                    yield PieceSeed(peer_id=conductor.peer_id,
                                    piece_info=p.to_info(),
                                    content_length=conductor.content_length,
                                    total_piece_count=conductor.total_pieces)
            while True:
                event = await q.get()
                if event["type"] == "piece":
                    meta = conductor.storage.md.pieces.get(event["num"])
                    if meta is not None:
                        yield PieceSeed(
                            peer_id=conductor.peer_id,
                            piece_info=meta.to_info(),
                            content_length=conductor.content_length,
                            total_piece_count=conductor.total_pieces)
                elif event["type"] == "done":
                    if not event.get("success"):
                        raise DFError(Code(event.get("code") or Code.UNKNOWN),
                                      event.get("message", "seed failed"))
                    yield PieceSeed(peer_id=conductor.peer_id, done=True,
                                    content_length=conductor.content_length,
                                    total_piece_count=conductor.total_pieces)
                    return
        finally:
            conductor.unsubscribe(q)


def build_service(svc: DaemonService) -> list[ServiceDef]:
    d = ServiceDef(DAEMON_SERVICE)
    d.unary_stream("Download", svc.download)
    d.unary_unary("StatTask", svc.stat_task)
    d.unary_unary("DeleteTask", svc.delete_task)
    d.unary_unary("GetPieceTasks", svc.get_piece_tasks)
    d.stream_stream("SyncPieceTasks", svc.sync_piece_tasks)
    s = ServiceDef(SEEDER_SERVICE)
    s.unary_stream("ObtainSeeds", svc.obtain_seeds)
    return [d, s]
