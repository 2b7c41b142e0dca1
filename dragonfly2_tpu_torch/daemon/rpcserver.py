"""Daemon RPC services.

Counterpart of ``dragonfly2_tpu/daemon/rpcserver.py`` (reference
``client/daemon/rpcserver/rpcserver.go``): the local API (``Download``
server stream, ``StatTask``, ``ImportTask``, ``ExportTask``,
``DeleteTask``), the peer API (``GetPieceTasks`` and the
``SyncPieceTasks`` bidi stream) and the seeder's ``ObtainSeeds``.

A recursive ``Download`` walks the origin's listing from this daemon
(``source.walk``; listings come from here even with back-source
disabled, as in the reference) and runs one file task per leaf, its
output mirrored under the request's ``output``, with at most
``recursive_concurrency`` leaves in flight; the leaves' frames interleave
on the one stream, each leaf ending with its own done frame.

A seed daemon rations its announcements through super-seeding
(``_SuperSeed``), as the reference's seeds do: each landed piece is
announced to a few children, a rotation widens it over time, and a
starving child's pings reveal more within a per-child budget. A seed's
stream opens with a geometry-only packet and then carries landed pieces
only, never ``relay_nums``.

Every other holder announces ahead (the control-plane half of
cut-through relay, ``relay.py``): pieces in flight on this daemon ride
``piece_infos`` with their numbers in ``relay_nums``, and every packet
carries the holder's ``progress`` (pieces landed). A child that pulls
one is served to the landing watermark by the upload server's streaming
path, so a chain's first relaying hop is the seed's first child.
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import replace
from typing import AsyncIterator

from ..common.errors import Code, DFError
from ..common.rate import TokenBucket
from ..idl.messages import (DeleteTaskRequest, DownloadRequest, Empty,
                            ExportTaskRequest, ImportTaskRequest,
                            ObtainSeedsRequest, PiecePacket, PieceSeed,
                            PieceTaskRequest, StatTaskDaemonRequest, TaskStat,
                            UrlMeta)
from ..source import walk
from ..rpc.server import ServiceDef
from .config import SchedulerConfig
from .peertask_manager import PeerTaskManager

log = logging.getLogger("df.rpc.daemon")

# a geometry-less task's piece sync waits at most a register's time
REGISTER_TIMEOUT_S = SchedulerConfig.register_timeout_s

DAEMON_SERVICE = "df.daemon.Daemon"
SEEDER_SERVICE = "df.daemon.Seeder"


class _SuperSeed:
    """Per-task super-seed announcement policy (seed daemons only).

    A seed that reveals every piece to every child turns a fan-out into a
    star: every child pulls each fresh piece off the seed, so the seed's
    uplink bounds the swarm. Here each piece is announced to at most
    ``fanout`` children (least loaded first, one per slice first), so
    replication goes on through the mesh. A rotation widens every piece by
    one more child per tick, capped at twice the fanout, so a slow child
    never strands a piece; a departing child's assignments return to the
    pool; and a child whose mesh parents have nothing for it pulls more
    through starvation pings (``reveal_to``), within a per-child budget.
    Children's dispatchers rank seed parents last, so a revealed piece the
    mesh also holds is still pulled from the mesh.
    """

    # starvation-ping reveals are budgeted per child: a child running
    # ahead of the mesh pings constantly, and unbudgeted reveals would
    # make it the seed's dedicated first tier
    REVEAL_RATE_PER_S = 0.6
    REVEAL_BURST = 2.0

    def __init__(self, *, fanout: int = 2, rotate_interval_s: float = 0.5):
        self.fanout = fanout
        self.rotate_interval_s = rotate_interval_s
        self.known: set[int] = set()
        self.assigned: dict[int, set[str]] = {}   # piece -> peer ids told
        self.subs: dict[str, asyncio.Queue] = {}  # peer id -> allowed nums
        self.slices: dict[str, str] = {}          # peer id -> slice
        self._reveal_budget: dict[str, TokenBucket] = {}
        self._rotor: asyncio.Task | None = None

    def _load(self, peer_id: str) -> int:
        return sum(1 for owners in self.assigned.values() if peer_id in owners)

    def _offer(self, num: int, target: int | None = None) -> None:
        """Reveal ``num`` to up to ``target`` (default ``fanout``)
        children: one per slice first (each slice then has a local first
        copy), least loaded within a slice."""
        owners = self.assigned.setdefault(num, set())
        want = (self.fanout if target is None else target) - len(owners)
        if want <= 0:
            return
        covered = {self.slices.get(pid, "") for pid in owners}
        cands = sorted((s for s in self.subs if s not in owners),
                       key=self._load)
        picked: list[str] = []
        for pid in cands:               # pass 1: uncovered slices
            if len(picked) >= want:
                break
            sl = self.slices.get(pid, "")
            if sl not in covered:
                picked.append(pid)
                covered.add(sl)
        for pid in cands:               # pass 2: fill the remaining fanout
            if len(picked) >= want:
                break
            if pid not in picked:
                picked.append(pid)
        for pid in picked:
            owners.add(pid)
            self.subs[pid].put_nowait(num)

    def on_piece(self, num: int) -> None:
        self.known.add(num)
        self._offer(num)

    def reveal_to(self, peer_id: str, n: int = 2) -> None:
        """Starvation pull: a child with idle workers and nothing
        dispatchable asked for more. Reveal up to ``n`` of the least
        revealed pieces it does not know yet, within its budget."""
        q = self.subs.get(peer_id)
        if q is None:
            return
        budget = self._reveal_budget.get(peer_id)
        if budget is None:
            budget = self._reveal_budget[peer_id] = TokenBucket(
                self.REVEAL_RATE_PER_S, burst=self.REVEAL_BURST)
        cands = sorted(
            (num for num in self.known
             if peer_id not in self.assigned.get(num, ())),
            key=lambda num: len(self.assigned.get(num, ())))
        for num in cands[:n]:
            if not budget.try_acquire(1):
                return
            self.assigned.setdefault(num, set()).add(peer_id)
            q.put_nowait(num)

    def subscribe(self, peer_id: str, *, slice_name: str = "") -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self.subs[peer_id] = q
        if slice_name:
            self.slices[peer_id] = slice_name
        for num in self.known:   # fill any under-assigned pieces
            self._offer(num)
        if self._rotor is None:
            self._rotor = asyncio.get_running_loop().create_task(self._rotate())
        return q

    def unsubscribe(self, peer_id: str, q: asyncio.Queue | None = None) -> None:
        """``q`` guards reconnects: a child that re-subscribed on a new
        stream keeps that subscription when the old stream's cleanup runs
        (only the owner of the registered queue removes it)."""
        if q is not None and self.subs.get(peer_id) is not q:
            return
        self.subs.pop(peer_id, None)
        self.slices.pop(peer_id, None)
        self._reveal_budget.pop(peer_id, None)
        for owners in self.assigned.values():
            owners.discard(peer_id)
        if not self.subs and self._rotor is not None:
            self._rotor.cancel()
            self._rotor = None

    async def _rotate(self) -> None:
        # a liveness net for slow assignees, capped at twice the fanout:
        # uncapped, it converges to broadcast whenever the swarm runs
        # slower than the timer. Dead assignees are handled by
        # unsubscribe(), stuck children by starvation pings
        while True:
            await asyncio.sleep(self.rotate_interval_s)
            for num in list(self.known):
                have = len(self.assigned.get(num, ()))
                if have < 2 * self.fanout:
                    self._offer(num, target=have + 1)


class DaemonService:
    """Wire handlers; delegation to PeerTaskManager + storage."""

    def __init__(self, ptm: PeerTaskManager, *, upload_addr: str = ""):
        self.ptm = ptm
        self.upload_addr = upload_addr
        self._superseed: dict[str, _SuperSeed] = {}
        self._superseed_feeders: dict[str, asyncio.Task] = {}

    # -- local API -----------------------------------------------------

    async def download(self, request: DownloadRequest,
                       context) -> AsyncIterator:
        if request.recursive:
            async for resp in self._download_recursive(request):
                yield resp
            return
        async for resp in self.ptm.start_file_task(request):
            yield resp

    async def _download_recursive(self, request: DownloadRequest
                                  ) -> AsyncIterator:
        """One file task per leaf of the walk, mirrored under
        ``request.output``, at most ``recursive_concurrency`` in flight.
        The first leaf error is raised on the stream once the walk and
        the leaves have ended; a client that goes cancels the producer
        and its leaves."""
        meta = request.url_meta
        if meta is not None and (meta.digest or meta.range):
            # a whole-tree digest or range cannot apply to each file
            meta = replace(meta, digest="", range="")
        header = dict(meta.header) if meta is not None and meta.header \
            else None
        sem = asyncio.Semaphore(max(1, request.recursive_concurrency))
        out_q: asyncio.Queue = asyncio.Queue()      # unbounded: put never waits
        done = object()

        async def fetch(entry, rel: str) -> None:
            async with sem:         # held for the whole leaf: the fan-out cap
                sub = DownloadRequest(
                    url=entry.url, output=os.path.join(request.output, rel),
                    url_meta=meta, timeout_s=request.timeout_s,
                    disable_back_source=request.disable_back_source,
                    device_sink=request.device_sink,
                    task_type=request.task_type,
                    rate_limit_bps=request.rate_limit_bps,
                    keep_original_offset=request.keep_original_offset)
                async for resp in self.ptm.start_file_task(sub):
                    out_q.put_nowait(resp)

        async def produce() -> None:
            loop = asyncio.get_running_loop()
            tasks: list[asyncio.Task] = []
            try:
                async for entry, rel in walk(request.url,
                                             timeout_s=request.timeout_s,
                                             header=header):
                    tasks.append(loop.create_task(fetch(entry, rel)))
                results = await asyncio.gather(*tasks,
                                               return_exceptions=True)
                errs = [r for r in results if isinstance(r, BaseException)]
                if errs:
                    raise errs[0]
            finally:
                for t in tasks:
                    if not t.done():
                        t.cancel()
                out_q.put_nowait(done)

        producer = asyncio.get_running_loop().create_task(produce())
        try:
            while True:
                item = await out_q.get()
                if item is done:
                    break
                yield item
            await producer          # the walk's or a leaf's error
        finally:
            if not producer.done():     # the client went
                producer.cancel()
                await asyncio.gather(producer, return_exceptions=True)

    async def stat_task(self, request: StatTaskDaemonRequest,
                        context) -> TaskStat:
        task_id = request.task_id or self.ptm._task_id(
            request.url, request.url_meta or UrlMeta())
        return await self.ptm.stat_task(task_id)

    async def import_task(self, request: ImportTaskRequest,
                          context) -> TaskStat:
        task_id = await self.ptm.import_file(
            request.path, request.url, request.url_meta,
            task_type=request.task_type)
        return await self.ptm.stat_task(task_id)

    async def export_task(self, request: ExportTaskRequest,
                          context) -> Empty:
        await self.ptm.export_file(request.url, request.output,
                                   request.url_meta,
                                   local_only=request.local_only,
                                   timeout_s=request.timeout_s)
        return Empty()

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
            if getattr(self.ptm, "is_seed", False):
                async for packet in self._sync_superseed(
                        request, request_iter, conductor, context):
                    yield packet
                continue
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

    def _superseed_for(self, task_id: str, conductor) -> _SuperSeed:
        policy = self._superseed.get(task_id)
        if policy is None:
            policy = self._superseed[task_id] = _SuperSeed()
            live = (conductor is not None
                    and not conductor.done_event.is_set())
            # subscribed before the storage snapshot, in one step: a piece
            # landing in between is then known either way
            q = conductor.subscribe() if live else None
            ts = self._storage_for(task_id)
            if ts is not None:
                for p in ts.piece_infos():
                    policy.known.add(p.num)
            if live:
                feeder = asyncio.get_running_loop().create_task(
                    self._feed_superseed(policy, q))
                # released however the feeder ends, cancelled before its
                # first step included
                feeder.add_done_callback(lambda _: conductor.unsubscribe(q))
                self._superseed_feeders[task_id] = feeder
        return policy

    @staticmethod
    async def _feed_superseed(policy: _SuperSeed, q: asyncio.Queue) -> None:
        """Landed pieces into the policy (relay events, pieces still in
        flight, are not announced by a seed)."""
        while True:
            event = await q.get()
            if event["type"] == "piece":
                policy.on_piece(event["num"])
            elif event["type"] == "done":
                return

    async def _sync_superseed(self, request: PieceTaskRequest, request_iter,
                              conductor, context) -> AsyncIterator:
        policy = self._superseed_for(request.task_id, conductor)
        sq = policy.subscribe(request.src_peer_id,
                              slice_name=request.src_slice)

        async def read_pings() -> None:
            # a follow-up request on the stream: "my workers are idle and
            # nothing is dispatchable", so reveal this child more pieces
            async for _ in request_iter:
                policy.reveal_to(request.src_peer_id)

        pings = asyncio.get_running_loop().create_task(read_pings())
        try:
            # geometry-only opener: the child needs the sizes to set up
            # its store before any piece is revealed to it
            base = await self.get_piece_tasks(PieceTaskRequest(
                task_id=request.task_id, src_peer_id=request.src_peer_id,
                dst_peer_id=request.dst_peer_id, start_num=0, limit=1),
                context)
            base.piece_infos = []
            base.relay_nums = None
            yield base
            while True:
                nums = self._drain(sq, await sq.get())
                ts = self._storage_for(request.task_id)
                if ts is not None:
                    yield self._packet_for_nums(request, ts, nums, [])
        finally:
            pings.cancel()
            policy.unsubscribe(request.src_peer_id, sq)
            # last subscriber gone: evict the policy and its feeder, or a
            # long-lived seed keeps one per task it ever served. A later
            # subscriber rebuilds both from storage
            if not policy.subs:
                self._superseed.pop(request.task_id, None)
                feeder = self._superseed_feeders.pop(request.task_id, None)
                if feeder is not None:
                    feeder.cancel()

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
    d.unary_unary("ImportTask", svc.import_task)
    d.unary_unary("ExportTask", svc.export_task)
    d.unary_unary("DeleteTask", svc.delete_task)
    d.unary_unary("GetPieceTasks", svc.get_piece_tasks)
    d.stream_stream("SyncPieceTasks", svc.sync_piece_tasks)
    s = ServiceDef(SEEDER_SERVICE)
    s.unary_stream("ObtainSeeds", svc.obtain_seeds)
    return [d, s]
