"""P2P piece engine: pulls a task's pieces from parent peers.

Counterpart of ``dragonfly2_tpu/daemon/piece_engine.py`` (reference
``client/daemon/peer/peertask_conductor.go`` P2P half —
``pullPiecesWithP2P`` :544, ``receivePeerPacket`` :659, the piece workers
:976-1010 — plus ``peertask_piecetask_synchronizer.go``: one
``SyncPieceTasks`` bidi stream per parent feeding the dispatcher), with
the sharded-task piece classes (``apply_shard_state``: the needed subset
and the swap-class pieces held off the seed; a scheduler packet that
carries ``assigned_shards`` re-rules them mid-pull). Announced pieces this
task's storage already holds are placed from disk before dispatch.

Each piece's lifecycle is journaled on the conductor's flight
(``flight_recorder.py``: scheduled, dispatched, first_byte, wire_done, and
the typed failures), and each dispatch's landing buffer is a cut-through
relay span (``relay.py``) while its bytes arrive, retired after landing
and before the buffer returns to the pool. A piece that rode a parent's
relay path is reported with ``PieceResult.relayed``, on success as well
as on failure (the reference marks failed transfers only).

With a verdict ledger (``verdicts``, ``verdicts.py``) every landed piece
is a ``record_ok`` on its parent's address and every typed failure a
``record``; the corrupt verdict that flips an address to shunned
journals a ``quarantine`` flight event and severs the parent for this
task, and the admission gate (``_admissible``) keeps a shunned address
out of the dispatcher whoever offers it (scheduler packet, sync stream,
PEX rung, resurrection).

Every parent a packet admits is handed to ``peer_observer`` (the PEX
plane's membership hook). An ``advisory`` packet (the PEX plane's swarm
holders, ``pex.prime``) adds parents without pruning the scheduler's
assignment. A session with ``rescuable = False`` (the pex rung's, which
has no scheduler behind it) returns to the ladder when no piece lands
for ``schedule_timeout_s``.

``pull`` returns:
  * True  — every NEEDED piece landed (the conductor verifies and
    finalizes);
  * False — fall back to origin: NeedBackSource from the scheduler, no
    parents within the schedule timeout, or all parents gone without
    replacement;
and raises DFError for hard failures.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import TYPE_CHECKING

from ..common import health, tracing
from ..common.bufpool import POOL
from ..common.errors import Code, DFError
from ..common.metrics import REGISTRY
from ..idl.messages import (PeerAddr, PeerPacket, PieceInfo, PieceResult,
                            PieceTaskRequest, SizeScope)
from ..rpc.client import ChannelPool, ServiceClient
from . import flight_recorder as fr
from .piece_dispatcher import ENDGAME_PIECES, Dispatch, PieceDispatcher
from .piece_downloader import PieceDownloader

if TYPE_CHECKING:  # pragma: no cover
    from .conductor import PeerTaskConductor
    from .scheduler_session import PeerSession

log = logging.getLogger("df.flow.engine")

DAEMON_SERVICE = "df.daemon.Daemon"

# the defaults of the daemon config's download.piece_parallelism,
# scheduler.schedule_timeout_s and download.piece_timeout_s
PIECE_PARALLELISM = 4       # piece download workers per task
SCHEDULE_TIMEOUT_S = 30.0   # max wait for a usable peer packet
PIECE_TIMEOUT_S = 60.0      # per-piece deadline

_p2p_pieces = REGISTRY.counter("df_p2p_piece_total",
                               "pieces fetched from peers", ("result",))


class _Synchronizer:
    """One SyncPieceTasks stream against one parent daemon."""

    def __init__(self, engine: "PieceEngine", conductor: "PeerTaskConductor",
                 parent: PeerAddr):
        self.engine = engine
        self.conductor = conductor
        self.parent = parent
        self.task: asyncio.Task | None = None
        self.stream = None              # live SyncPieceTasks stream
        self._seen: set[int] = set()    # piece nums this parent announced

    def start(self) -> None:
        self.task = asyncio.get_running_loop().create_task(self._run())

    def _request(self) -> PieceTaskRequest:
        return PieceTaskRequest(
            task_id=self.conductor.task_id,
            src_peer_id=self.conductor.peer_id,
            dst_peer_id=self.parent.peer_id, start_num=0, limit=1 << 20,
            src_slice=self.engine.slice_name)

    def exhausted(self) -> bool:
        """The parent announced every piece: pinging reveals nothing."""
        total = self.conductor.total_pieces
        return total >= 0 and len(self._seen) >= total

    async def ping(self) -> None:
        """Starvation signal: ask the parent for more work."""
        stream = self.stream
        if self.exhausted() or stream is None:
            return
        try:
            await stream.write(self._request())
        except Exception:  # noqa: BLE001 - stream may be closing
            pass

    async def _run(self) -> None:
        addr = f"{self.parent.ip}:{self.parent.rpc_port}"
        try:
            stream = self.engine.peer_client(addr).stream_stream(
                "SyncPieceTasks")
            self.stream = stream
            await stream.write(self._request())
            try:
                while True:
                    packet = await stream.read()
                    if packet is None:
                        break
                    await self._on_packet(packet)
            finally:
                self.stream = None
                stream.cancel()
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - parent went away
            log.debug("sync with %s ended: %s", self.parent.peer_id, exc)
            await self.engine.dispatcher.remove_parent(self.parent.peer_id)

    async def _on_packet(self, packet) -> None:
        if packet.content_length >= 0 and self.conductor.piece_size == 0:
            self.conductor.set_content_info(packet.content_length,
                                            packet.piece_size)
            self.engine.apply_shard_state(self.conductor)
        if self.conductor.piece_size == 0:
            return    # the parent does not know the geometry yet
        dst_addr = (packet.dst_addr
                    or f"{self.parent.ip}:{self.parent.download_port}")
        if not self.engine._admissible(self.parent.peer_id, dst_addr):
            # a locally shunned address grows no dispatcher slot, however
            # it got a sync stream
            return
        await self.engine.dispatcher.add_parent(
            self.parent.peer_id, dst_addr, is_seed=self.parent.is_seed,
            link=self.parent.link)
        for p in packet.piece_infos or []:
            self._seen.add(p.piece_num)
        infos = [p for p in (packet.piece_infos or [])
                 if p.piece_num not in self.conductor.ready]
        if infos:
            # pieces already on this task's disk (a warm partial) are
            # placed locally: the dispatcher never queues a pull for them
            placed = await self.conductor.place_from_store(infos)
            if placed:
                infos = [p for p in infos if p.piece_num not in placed]
        if infos:
            await self.engine.dispatcher.announce(self.parent.peer_id, infos)

    def stop(self) -> None:
        if self.task is not None:
            self.task.cancel()


class _SpanHandle:
    """Engine-side relay-span lifecycle: called by the downloader with the
    pooled buffer once acquired (registers the in-flight span), retired by
    the engine once the span's pieces have landed, always before the
    buffer returns to the pool. A no-op while the relay plane is off."""

    __slots__ = ("relay", "task_id", "pieces", "span")

    def __init__(self, relay, task_id: str, pieces: list[PieceInfo]):
        self.relay = relay
        self.task_id = task_id
        self.pieces = pieces
        self.span = None

    def __call__(self, buf):
        if self.relay is None:
            return None
        base = self.pieces[0].range_start
        size = sum(p.range_size for p in self.pieces)
        self.span = self.relay.open_span(self.task_id, base, size, buf,
                                         self.pieces)
        return self.span

    def retire(self) -> None:
        if self.span is not None and self.relay is not None:
            self.relay.retire(self.span)
            self.span = None


class PieceEngine:
    def __init__(self, *, parallelism: int = PIECE_PARALLELISM,
                 schedule_timeout_s: float = SCHEDULE_TIMEOUT_S,
                 piece_timeout_s: float = PIECE_TIMEOUT_S,
                 downloader: PieceDownloader | None = None,
                 channel_pool: ChannelPool | None = None,
                 slice_name: str = "", relay=None, peer_observer=None,
                 verdicts=None):
        self.parallelism = parallelism
        self.piece_timeout_s = piece_timeout_s
        self.slice_name = slice_name    # advertised on piece sync requests
        # PEX membership hook: every admitted parent is observed, so the
        # gossip plane knows the mesh the scheduler built
        self.peer_observer = peer_observer
        # per-parent verdict ledger (verdicts.py): typed failure verdicts
        # recorded here; parents it shuns are refused admission
        self.verdicts = verdicts
        self.schedule_timeout_s = schedule_timeout_s
        # cut-through relay hub: every span this engine downloads is
        # readable by the upload server's streaming path while it arrives
        self.relay = relay
        self.downloader = downloader or PieceDownloader(
            timeout_s=piece_timeout_s)
        self._own_downloader = downloader is None
        # the channel pool may be daemon-wide so parent connections persist
        self._channels = (channel_pool if channel_pool is not None
                          else ChannelPool())
        self._own_channels = channel_pool is None
        self.dispatcher = PieceDispatcher()
        self._synchronizers: dict[str, _Synchronizer] = {}
        self._current_parents: dict[str, PeerAddr] = {}  # latest assignment
        self._need_back_source = False
        self._first_parent = asyncio.Event()
        self._last_ping = 0.0
        # starvation-ping pacing: jittered base, exponential while pings
        # produce no new announcements, reset on progress
        self._ping_base = 0.1 * random.uniform(0.9, 1.5)
        self._ping_interval = self._ping_base
        self._announced_at_ping = -1
        self._shards_applied = False

    def peer_client(self, addr: str) -> ServiceClient:
        return ServiceClient(self._channels.get(addr), DAEMON_SERVICE)

    def apply_shard_state(self, conductor) -> None:
        """Push the conductor's sharded-task piece classes into the
        dispatcher once geometry is known: the needed subset (pieces
        outside it are never dispatched) and the swap-class set (held
        off seed parents for the swap hold). Idempotent; re-applied on
        widen."""
        if conductor.shard_tracker is None or conductor.piece_size <= 0:
            return
        if (self._shards_applied
                and self.dispatcher.needed == conductor.needed_pieces
                and self.dispatcher.swap_nums == conductor.swap_piece_nums):
            return
        self._shards_applied = True
        self.dispatcher.set_shard_state(conductor.needed_pieces,
                                        conductor.swap_piece_nums)

    # ------------------------------------------------------------------

    async def pull(self, conductor: "PeerTaskConductor",
                   session: "PeerSession") -> bool:
        result = session.result
        try:
            if result.size_scope == SizeScope.EMPTY:
                conductor.set_content_info(0)
                return True
            if (result.size_scope == SizeScope.SMALL
                    and result.single_piece is not None
                    and result.single_piece.piece_info is not None):
                if await self._pull_single(conductor, session,
                                           result.single_piece):
                    return True
                # fall through to the normal path: the scheduler may help
            return await self._pull_normal(conductor, session)
        finally:
            await self._teardown()

    async def _pull_single(self, conductor, session, single) -> bool:
        info: PieceInfo = single.piece_info
        if session.result.content_length >= 0:
            conductor.set_content_info(session.result.content_length,
                                       session.result.piece_size)
        else:
            conductor.set_content_info(info.range_size)
        parent = self.dispatcher.parents.get(single.dst_peer_id) or \
            await self.dispatcher.add_parent(single.dst_peer_id,
                                             single.dst_addr)
        return await self._download_one(conductor, session,
                                        Dispatch([info], parent),
                                        track=False)

    async def _pull_normal(self, conductor, session) -> bool:
        if session.result.content_length >= 0:
            conductor.set_content_info(session.result.content_length,
                                       session.result.piece_size)
        self.apply_shard_state(conductor)
        if conductor.storage is not None and conductor.storage.md.pieces:
            # a warm partial (reloaded at a restart, or an earlier
            # attempt's) places what it holds now; one that holds every
            # needed piece finishes without waiting for a parent
            await conductor.place_from_store(
                [p.to_info() for p in conductor.storage.piece_infos()])
            if conductor.pieces_remaining() == 0:
                conductor._finishing = True
                return True
        loop = asyncio.get_running_loop()
        packet_task = loop.create_task(
            self._consume_packets(conductor, session))
        workers = [loop.create_task(self._worker(conductor, session))
                   for _ in range(self.parallelism)]
        try:
            # a parent must show up within the schedule timeout
            try:
                await asyncio.wait_for(self._first_parent.wait(),
                                       self.schedule_timeout_s)
            except asyncio.TimeoutError:
                log.info("no parents within %.1fs; back-source",
                         self.schedule_timeout_s)
                return False
            # a session with no scheduler behind it (the pex rung's) must
            # give up on a stall: no packet or re-assignment will come
            rescuable = getattr(session, "rescuable", True)
            last_ready = len(conductor.ready)
            last_progress = time.monotonic()
            while True:
                if self._need_back_source:
                    return False
                remaining = conductor.pieces_remaining()
                if not rescuable:
                    if len(conductor.ready) != last_ready:
                        last_ready = len(conductor.ready)
                        last_progress = time.monotonic()
                    elif (time.monotonic() - last_progress
                            > self.schedule_timeout_s):
                        log.info("scheduler-less pull stalled %.1fs at "
                                 "%d/%d pieces; returning to the ladder",
                                 self.schedule_timeout_s, last_ready,
                                 conductor.total_pieces)
                        return False
                if remaining == 0:
                    # done = every NEEDED piece landed. The commit flag is
                    # set in the same synchronous block as the coverage
                    # check: a widen either ran before it (and this check
                    # saw the widened set) or is refused after it
                    conductor._finishing = True
                    return True
                # endgame: duplicate-request racing for the task's tail
                self.dispatcher.endgame = 0 <= remaining <= ENDGAME_PIECES
                if not self.dispatcher.has_live_parent():
                    # parents gone: give the scheduler a grace period to
                    # re-assign, then fall back to origin; the reschedule
                    # rung journals that the task rides out an outage
                    if conductor.flight is not None:
                        conductor.flight.rung(fr.RUNG_RESCHEDULE)
                    try:
                        await asyncio.wait_for(self._wait_parent_change(),
                                               self.schedule_timeout_s)
                    except asyncio.TimeoutError:
                        log.info("parents exhausted; back-source for the "
                                 "rest")
                        return False
                    if conductor.flight is not None:
                        conductor.flight.rung(fr.RUNG_P2P)
                    continue
                # progress tick: piece arrivals notify the conductor's cond
                try:
                    await asyncio.wait_for(self._piece_tick(conductor), 0.25)
                except asyncio.TimeoutError:
                    pass
        finally:
            # close the dispatcher before cancelling the workers: a worker
            # parked in get() then leaves through the closed path, and no
            # cancelled waiter can hold the condition lock close() needs
            await self.dispatcher.close()
            packet_task.cancel()
            for w in workers:
                w.cancel()
            await asyncio.gather(packet_task, *workers,
                                 return_exceptions=True)

    @staticmethod
    async def _piece_tick(conductor) -> None:
        async with conductor._piece_cond:
            await conductor._piece_cond.wait()

    async def _wait_parent_change(self) -> None:
        cond = self.dispatcher._cond
        async with cond:
            while (not self.dispatcher.has_live_parent()
                   and not self._need_back_source):
                await cond.wait()

    # ------------------------------------------------------------------

    async def _consume_packets(self, conductor, session) -> None:
        """Apply scheduler parent assignments as they arrive."""
        while True:
            packet: PeerPacket = await session.packets.get()
            code = Code(packet.code or 0)
            if code == Code.SCHED_NEED_BACK_SOURCE:
                self._need_back_source = True
                self._first_parent.set()
                async with self.dispatcher._cond:
                    self.dispatcher._cond.notify_all()
                return
            if code in (Code.SCHED_PEER_GONE, Code.SCHED_REREGISTER,
                        Code.SCHED_TASK_STATUS_ERROR, Code.UNAVAILABLE):
                # the stream ended or the scheduler lost us: workers drain
                # what they have, the main loop decides on fallback
                self._first_parent.set()
                continue
            if packet.assigned_shards is not None:
                # a shard re-ruling: the group grew after this peer
                # registered, so its tree share shrank
                conductor.set_affinity(list(packet.assigned_shards))
                self.apply_shard_state(conductor)
            parents = list(packet.candidate_peers or [])
            if packet.main_peer is not None:
                parents.insert(0, packet.main_peer)
            for parent in parents:
                if parent.peer_id == conductor.peer_id:
                    continue
                dl_addr = f"{parent.ip}:{parent.download_port}"
                if not self._admissible(parent.peer_id, dl_addr):
                    continue
                await self.dispatcher.add_parent(
                    parent.peer_id, dl_addr,
                    resurrect=True, is_seed=parent.is_seed, link=parent.link)
                self._current_parents[parent.peer_id] = parent
                if self.peer_observer is not None:
                    self.peer_observer(parent)
                sync = self._synchronizers.get(parent.peer_id)
                if sync is None or (sync.task is not None
                                    and sync.task.done()):
                    sync = _Synchronizer(self, conductor, parent)
                    self._synchronizers[parent.peer_id] = sync
                    sync.start()
            if parents and not packet.advisory:
                # the packet is the scheduler's current assignment: parents
                # it dropped release their upload slot server-side, so stop
                # pulling from them. An advisory packet (swarm holders from
                # the PEX plane) only adds parents
                assigned = {p.peer_id for p in parents}
                for peer_id in list(self._synchronizers):
                    if peer_id not in assigned:
                        self._synchronizers.pop(peer_id).stop()
                        self._current_parents.pop(peer_id, None)
                        await self.dispatcher.remove_parent(peer_id)
            if parents:
                self._first_parent.set()

    async def _worker(self, conductor, session) -> None:
        while True:
            d = await self.dispatcher.get(timeout=0.1)
            if d is None:
                if self.dispatcher.closed:
                    return
                await self._maybe_ping()
                continue
            await self._download_one(conductor, session, d)

    async def _maybe_ping(self) -> None:
        if not self.dispatcher.starving():
            return
        now = time.monotonic()
        if now - self._last_ping < self._ping_interval:
            return
        self._last_ping = now
        announced = sum(p.announced
                        for p in self.dispatcher.parents.values())
        if announced > self._announced_at_ping:
            self._ping_interval = self._ping_base      # progress: re-arm
        else:
            self._ping_interval = min(self._ping_interval * 1.7, 1.2)
        self._announced_at_ping = announced
        for sync in list(self._synchronizers.values()):
            await sync.ping()
        # resurrect dead sync streams of parents the scheduler still
        # assigns: a stream that failed at setup otherwise stays dead until
        # the scheduler pushes a new packet
        for peer_id, parent in list(self._current_parents.items()):
            sync = self._synchronizers.get(peer_id)
            if (sync is None or sync.task is None or not sync.task.done()
                    or self.dispatcher.hard_removed(peer_id)
                    or not self._admissible(
                        peer_id, f"{parent.ip}:{parent.download_port}")):
                continue
            await self.dispatcher.add_parent(
                peer_id, f"{parent.ip}:{parent.download_port}",
                resurrect=True, is_seed=parent.is_seed, link=parent.link)
            fresh = _Synchronizer(self, sync.conductor, parent)
            self._synchronizers[peer_id] = fresh
            fresh.start()

    _FAIL_EVENTS = {"stall": fr.STALL, "timeout": fr.TIMEOUT,
                    "refused": fr.REFUSED}

    def _note_fail(self, conductor, info: PieceInfo, parent_id: str,
                   addr: str, code: str) -> None:
        """Journal and ledger one non-corrupt typed failure: soft
        evidence, decayed for ordering, never shunned on."""
        if conductor.flight is not None:
            kind = self._FAIL_EVENTS.get(code)
            if kind is not None:
                conductor.flight.event(kind, info.piece_num, parent_id)
        if self.verdicts is not None and addr and code != "corrupt":
            self.verdicts.record(addr, code, peer_id=parent_id)

    def _note_corrupt(self, conductor, info: PieceInfo, parent_id: str,
                      addr: str = "", relayed: bool = False) -> bool:
        """A transfer failed digest verification at landing: count it,
        journal it, and record the hard verdict in the daemon-wide
        ledger. Returns True when this verdict flipped the address to
        shunned (journaled as a ``quarantine`` flight event)."""
        _p2p_pieces.labels("corrupt").inc()
        log.warning("piece %d from %s: digest mismatch (requeued)",
                    info.piece_num, parent_id[-12:])
        if conductor.flight is not None:
            conductor.flight.event(fr.CORRUPT, info.piece_num, parent_id,
                                   info.range_size)
        if self.verdicts is not None and addr:
            flipped = self.verdicts.record(addr, "corrupt",
                                           peer_id=parent_id,
                                           relayed=relayed)
            if flipped and conductor.flight is not None:
                conductor.flight.event(fr.QUARANTINE, info.piece_num, addr)
            return flipped
        return False

    def _admissible(self, parent_id: str, addr: str) -> bool:
        """Parent admission gate: a locally shunned address is refused a
        dispatcher slot whoever offers it; pulling, verifying and
        requeuing a poisoned piece is the waste the ledger stops."""
        if self.verdicts is None or not self.verdicts.shunned(addr):
            return True
        log.info("refusing shunned parent %s (%s): local corrupt "
                 "verdicts", parent_id[-12:], addr)
        return False

    async def _download_one(self, conductor, session, d: Dispatch, *,
                            track: bool = True) -> bool:
        """Fetch one dispatch, land it, report each piece. ``track``:
        report the outcome to the dispatcher (False for the single-piece
        path, which bypasses it). Returns whether every piece landed."""
        if conductor.swap_piece_nums and d.parent.is_seed:
            # a swap-class piece riding the SEED: its swap hold expired
            # (the partner died or stalled) and the tree covers the hole
            for info in d.pieces:
                if info.piece_num in conductor.swap_piece_nums:
                    conductor.note_shard_fallback(info.piece_num,
                                                  d.parent.peer_id)
        flight = conductor.flight
        on_first = None
        if flight is not None:
            # worker pickup: queue_ms then measures the shaper's wait; the
            # parent's own queueing lands in ttfb_ms
            for info in d.pieces:
                flight.event(fr.SCHEDULED, info.piece_num, d.parent.peer_id)
        limiter = getattr(conductor, "rate_limiter", None)
        if limiter is not None:
            # the task's bucket from the traffic shaper: P2P fetches are
            # paced by class and task, as back-source reads are
            await limiter.acquire(d.size())
        if flight is not None:
            for info in d.pieces:
                flight.event(fr.DISPATCHED, info.piece_num, d.parent.peer_id)

            def on_first(_num=d.pieces[0].piece_num, _pid=d.parent.peer_id):
                flight.event(fr.FIRST_BYTE, _num, _pid)
        t0 = int(time.time() * 1000)
        span = _SpanHandle(self.relay, conductor.task_id, d.pieces)
        wire_meta: dict = {}
        try:
            # a span of the task's trace per transfer, and a watchdog
            # section: a parent that wedges mid-transfer self-reports (an
            # await-chain dump and a wire breach) before the per-piece
            # deadline cancels the read; the deadline scales with the
            # group, so healthy spans do not trip it
            with tracing.span("piece.download", piece=d.pieces[0].piece_num,
                              n_pieces=len(d.pieces)) as psp, \
                    health.PLANE.watchdog.section(
                        "piece.wire",
                        health.PLANE.slo.section_deadline_s(len(d.pieces)),
                        stage="wire"):
                psp.set(dst=d.parent.peer_id[-16:], link=int(d.parent.link))
                buf, cost = await self.downloader.download_span(
                    dst_addr=d.parent.addr, task_id=conductor.task_id,
                    src_peer_id=conductor.peer_id, pieces=d.pieces,
                    on_first_byte=on_first, relay_open=span,
                    qos_class=getattr(conductor, "qos_class", ""),
                    meta=wire_meta)
        except DFError as exc:
            if exc.code == Code.CLIENT_PEER_BUSY:
                # backpressure, not failure: requeue without a report (a
                # busy seed must not land on the blocklist)
                _p2p_pieces.labels("busy").inc()
                if track:
                    await self.dispatcher.report_busy(
                        d, retry_after_ms=getattr(exc, "retry_after_ms", 0))
                return False
            _p2p_pieces.labels("fail").inc()
            log.debug("pieces %s from %s failed: %s",
                      [p.piece_num for p in d.pieces],
                      d.parent.peer_id[-12:], exc)
            fcode = getattr(exc, "fail_code", "") or "stall"
            # one transfer, one typed event, however many pieces rode it
            self._note_fail(conductor, d.pieces[0], d.parent.peer_id,
                            d.parent.addr, fcode)
            if track:
                await self.dispatcher.report(d, ok=False)
                if d.parent.removed:
                    # permanently removed: its sync stream dies too
                    sync = self._synchronizers.get(d.parent.peer_id)
                    if sync is not None:
                        sync.stop()
            for info in d.pieces:
                await session.report_piece(self._piece_result(
                    conductor, info, d.parent.peer_id, t0, ok=False,
                    code=exc.code, fail_code=fcode))
            return False
        per_piece_cost = max(1, cost // len(d.pieces))
        relayed = wire_meta.get("relayed", False)
        # taken before the landing await, journaled only for pieces that
        # land: an endgame duplicate must not take the deliverer's row
        t_wire = flight.now_ms() if flight is not None else 0.0
        try:
            # one landing hop for the whole span: storage write + verify
            # off the loop, the device sink's staging copy inline
            placed, corrupt, raced = await conductor.on_span_from_peer(
                d.parent.peer_id, d.pieces, buf, per_piece_cost)
        finally:
            # landing, the sink's staging copy included, has completed.
            # The relay span retires FIRST: its bytes now serve from disk
            # (or, for a corrupt piece, stop being servable at all)
            span.retire()
            POOL.release(buf)
        placed_set = set(placed)
        corrupt_set, raced_set = set(corrupt), set(raced)
        shun_flipped = False
        for info in d.pieces:
            if info.piece_num in corrupt_set:
                shun_flipped |= self._note_corrupt(
                    conductor, info, d.parent.peer_id, addr=d.parent.addr,
                    relayed=relayed)
                await session.report_piece(self._piece_result(
                    conductor, info, d.parent.peer_id, t0, ok=False,
                    code=Code.CLIENT_DIGEST_MISMATCH, fail_code="corrupt",
                    relayed=relayed))
                continue
            if info.piece_num in raced_set:
                # an endgame racer is mid-landing: its own report settles
                # the piece
                continue
            if flight is not None and info.piece_num in placed_set:
                flight.event(fr.WIRE_DONE, info.piece_num, d.parent.peer_id,
                             info.range_size, dur_ms=per_piece_cost,
                             t_ms=t_wire)
            _p2p_pieces.labels("ok").inc()
            if self.verdicts is not None:
                self.verdicts.record_ok(d.parent.addr)
            await session.report_piece(self._piece_result(
                conductor, info, d.parent.peer_id, t0, ok=True,
                cost_ms=per_piece_cost, finished=len(conductor.ready),
                relayed=relayed))
        if shun_flipped:
            # shunned on local corrupt evidence: sever it for this task now
            # (the admission gate keeps it out of later tasks, and the
            # scheduler's pod-wide quarantine follows from the reports)
            await self.dispatcher.remove_parent(d.parent.peer_id)
            sync = self._synchronizers.get(d.parent.peer_id)
            if sync is not None:
                sync.stop()
        if track:
            await self.dispatcher.report(
                d, ok=True, cost_ms=cost,
                # a raced piece must not be marked done (the racer may yet
                # fail verification): leaving it out requeues it
                completed=[info.piece_num for info in d.pieces
                           if info.piece_num not in corrupt_set
                           and info.piece_num not in raced_set])
        return not corrupt_set

    @staticmethod
    def _piece_result(conductor, info: PieceInfo, parent_id: str, t0: int, *,
                      ok: bool, cost_ms: int = 0, code: Code = Code.OK,
                      finished: int = 0, fail_code: str = "",
                      relayed: bool = False) -> PieceResult:
        reported = PieceInfo(piece_num=info.piece_num,
                             range_start=info.range_start,
                             range_size=info.range_size, digest=info.digest,
                             download_cost_ms=cost_ms)
        return PieceResult(
            task_id=conductor.task_id, src_peer_id=conductor.peer_id,
            dst_peer_id=parent_id, piece_info=reported, begin_ms=t0,
            end_ms=t0 + cost_ms, success=ok, code=int(code),
            fail_code=fail_code, relayed=relayed, finished_count=finished)

    # ------------------------------------------------------------------

    async def _teardown(self) -> None:
        for sync in self._synchronizers.values():
            sync.stop()
        await asyncio.gather(
            *(s.task for s in self._synchronizers.values() if s.task),
            return_exceptions=True)
        await self.dispatcher.close()
        if self._own_channels:
            await self._channels.close()
        if self._own_downloader:
            await self.downloader.close()
