"""Scheduler connector: the daemon's client side of the scheduler service.

Counterpart of ``dragonfly2_tpu/daemon/scheduler_session.py`` (reference
``client/daemon/peer/peertask_conductor.go`` register :249 and the
``ReportPieceResult`` stream :340, :659): one connector per daemon, one
``PeerSession`` per running task. The session owns the bidi report
stream: piece results go up, ``PeerPacket`` parent assignments come down
into a queue the P2P engine consumes. Registration walks the scheduler
hash ring: a dead member is demoted for ``demote_s`` and the next one
tried before the conductor is sent to origin; a register that a later
member answers journals ``ring_failover`` on the task's flight and asks
the announcer to replay held content.

The connector also carries the announce plane: ``announce_host`` and
``announce_content`` (one retry each), the scheduler's boot epoch from
every answer (``note_epoch``: a change sets ``reconcile_event``, which
wakes the announcer), a TCP probe of demoted members (``probe_demoted``,
run by the PEX ticker) and the demotions' export and restore across a
daemon restart.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING

from ..common import faultgate
from ..common.errors import Code, DFError
from ..common.metrics import REGISTRY
from ..common.retry import Retrier, RetryPolicy
from ..idl.messages import (Host, LeaveHostRequest, PeerPacket, PeerResult,
                            PieceResult, RegisterPeerTaskRequest,
                            RegisterResult)
from ..rpc.balancer import HashRing
from ..rpc.client import Channel, RPCError, ServiceClient
from . import flight_recorder as fr

if TYPE_CHECKING:  # pragma: no cover
    from .conductor import PeerTaskConductor

log = logging.getLogger("df.flow.schedsess")

SCHEDULER_SERVICE = "df.scheduler.Scheduler"

_report_dropped = REGISTRY.counter(
    "df_sched_report_dropped_total",
    "piece results dropped because the scheduler report stream died")

# terminal PeerResult, AnnounceHost, AnnounceContent: one retry with
# backoff before giving up
_REPORT_RETRY = RetryPolicy(max_attempts=2, base_s=0.3, max_s=1.0,
                            budget_s=8.0)

# register failures that mean "this scheduler, not this task": the ladder
# moves to the next ring member instead of going to origin
_FAILOVER_CODES = (Code.UNAVAILABLE, Code.DEADLINE_EXCEEDED)


class PeerSession:
    """A registered (task, peer) against one scheduler."""

    _EOF = object()

    def __init__(self, client: ServiceClient, result: RegisterResult,
                 conductor: "PeerTaskConductor"):
        self.client = client
        self.result = result
        self.conductor = conductor
        self.task_id = conductor.task_id
        self.peer_id = conductor.peer_id
        self.packets: asyncio.Queue[PeerPacket] = asyncio.Queue()
        self._stream = None
        self._out: asyncio.Queue = asyncio.Queue()
        self._writer: asyncio.Task | None = None
        self._reader: asyncio.Task | None = None
        self._closed = False
        self._peer_result_sent = False

    async def open_report_stream(self) -> None:
        """Open the bidi piece-result stream; an empty first report asks
        the scheduler for the initial parent assignment."""
        self._stream = self.client.stream_stream("ReportPieceResult")
        await self._stream.write(PieceResult(
            task_id=self.task_id, src_peer_id=self.peer_id, success=True,
            code=int(Code.OK)))
        loop = asyncio.get_running_loop()
        self._reader = loop.create_task(self._read_loop())
        self._writer = loop.create_task(self._write_loop())

    async def _write_loop(self) -> None:
        """Sole owner of the stream's write half: piece workers enqueue."""
        try:
            while True:
                item = await self._out.get()
                if item is self._EOF:
                    await self._stream.done_writing()
                    return
                await self._stream.write(item)
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - stream went away
            log.debug("report write loop ended: %s", exc)

    async def _read_loop(self) -> None:
        try:
            while True:
                packet = await self._stream.read()
                if packet is None:
                    break
                self.packets.put_nowait(packet)
        except DFError as exc:
            # scheduler-side verdicts reach the engine as a synthetic
            # packet, so its one consume loop sees them
            self.packets.put_nowait(PeerPacket(
                task_id=self.task_id, src_peer_id=self.peer_id,
                code=int(exc.code)))
        except Exception as exc:  # noqa: BLE001 - stream teardown races
            if not self._closed:
                log.debug("report stream reader ended: %s", exc)
        finally:
            self.packets.put_nowait(PeerPacket(
                task_id=self.task_id, src_peer_id=self.peer_id,
                code=int(Code.UNAVAILABLE)))

    async def report_piece(self, result: PieceResult) -> None:
        if self._stream is None or self._closed:
            return
        if self._writer is not None and self._writer.done():
            # the scheduler went away: count the drop instead of queueing
            # into the void; the count rides the flight summary
            _report_dropped.inc()
            flight = getattr(self.conductor, "flight", None)
            if flight is not None:
                flight.report_drops += 1
            return
        self._out.put_nowait(result)

    @staticmethod
    async def _drain_task(task: asyncio.Task | None, timeout: float) -> None:
        if task is None or task.done():
            return
        try:
            await asyncio.wait_for(asyncio.shield(task), timeout)
        except (asyncio.TimeoutError, Exception):  # noqa: BLE001
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)

    async def close(self, *, success: bool) -> None:
        """Half-close the report stream (queued results drain first), then
        send the terminal PeerResult. Called after finalize, so the result
        carries the real outcome."""
        if self._closed:
            return
        self._closed = True
        conductor = self.conductor
        if self._stream is not None:
            self._out.put_nowait(self._EOF)
            await self._drain_task(self._writer, 5.0)
            await self._drain_task(self._reader, 5.0)
            self._stream.cancel()
        if conductor is None or self._peer_result_sent:
            return
        self._peer_result_sent = True
        flight = getattr(conductor, "flight", None)
        result = PeerResult(
            task_id=self.task_id, peer_id=self.peer_id,
            url=conductor.url, success=success,
            traffic=conductor.traffic_p2p,
            cost_ms=int(time.time() * 1000) - conductor.start_ms,
            code=int(conductor.fail_code),
            total_piece_count=conductor.total_pieces,
            content_length=conductor.content_length,
            flight_summary=(flight.compact_summary()
                            if flight is not None else None))
        try:
            # the outer Retrier is the only retry layer (one-attempt client)
            once = ServiceClient(self.client.channel, SCHEDULER_SERVICE,
                                 max_attempts=1)
            await Retrier(_REPORT_RETRY).run(
                lambda: once.unary("ReportPeerResult", result, timeout=5.0),
                retryable=lambda exc: not isinstance(exc, DFError)
                or exc.code in _FAILOVER_CODES)
        except Exception as exc:  # noqa: BLE001
            log.debug("ReportPeerResult failed: %s", exc)


class SchedulerConnector:
    """Daemon-wide scheduler client; conductor-facing ``register`` entry.

    ``register`` tries the hashed scheduler, then the next ring members
    (``failover_n`` in all) before raising UNAVAILABLE; a transport-dead
    member is demoted for ``demote_s`` so later tasks skip it. Scheduler
    verdicts (NeedBackSource, Forbidden) propagate from whichever member
    answered."""

    def __init__(self, addresses: list[str], host: Host, *,
                 register_timeout_s: float = 10.0, failover_n: int = 3,
                 demote_s: float = 30.0):
        self.addresses = list(addresses)
        self.host = host
        self.register_timeout_s = register_timeout_s
        self.failover_n = max(1, failover_n)
        self.demote_s = demote_s
        self._ring = HashRing(self.addresses)
        self._channels: dict[str, Channel] = {}
        self._demoted: dict[str, float] = {}   # addr -> monotonic revive time
        self._close_tasks: set[asyncio.Task] = set()
        # the serving scheduler's boot epoch, from register results and
        # announce answers: a change means the scheduler restarted and
        # must relearn who holds what (the announcer drains the event)
        self._epoch = 0
        self.reconcile_event = asyncio.Event()

    def update_addresses(self, addresses: list[str]) -> None:
        """Adopt a refreshed scheduler set (the manager's): new addresses
        join the hash ring; removed ones leave it and their channels
        close, and sessions riding them take the conductor's reschedule
        ladder. New tasks hash onto the new ring at once."""
        want = set(addresses)
        have = set(self.addresses)
        if want == have:
            return
        for addr in want - have:
            self._ring.add(addr)
        for addr in have - want:
            self._ring.remove(addr)
            self._demoted.pop(addr, None)
            ch = self._channels.pop(addr, None)
            if ch is not None:
                t = asyncio.get_running_loop().create_task(ch.close())
                self._close_tasks.add(t)
                t.add_done_callback(self._close_tasks.discard)
        self.addresses = list(addresses)

    # -- scheduler epoch ----------------------------------------------

    def note_epoch(self, epoch: int) -> bool:
        """Record the serving scheduler's boot epoch. True (and the
        announcer woken) when a previously seen epoch changed; the first
        epoch seen is no change, since the announcer's first content
        announce covers a daemon restart."""
        if not epoch or epoch == self._epoch:
            return False
        first = self._epoch == 0
        self._epoch = epoch
        if first:
            return False
        self.reconcile_event.set()
        return True

    def mark_reconcile(self) -> None:
        """Force a content re-announce (a register failed over: the next
        ring member may know nothing of this daemon's holdings)."""
        self.reconcile_event.set()

    # -- demotion ------------------------------------------------------

    def _alive(self, addr: str) -> bool:
        until = self._demoted.get(addr)
        if until is None:
            return True
        if time.monotonic() >= until:
            self._demoted.pop(addr, None)     # probe window: eligible again
            return True
        return False

    def demote(self, addr: str) -> None:
        self._demoted[addr] = time.monotonic() + self.demote_s
        log.info("scheduler %s demoted for %.1fs", addr, self.demote_s)

    def revive(self, addr: str) -> None:
        if self._demoted.pop(addr, None) is not None:
            log.info("scheduler %s revived", addr)

    def demoted(self) -> set[str]:
        return {a for a in list(self._demoted) if not self._alive(a)}

    async def probe_demoted(self, *, timeout_s: float = 2.0) -> list[str]:
        """TCP-connect every demoted member at once and revive those that
        answer; returns the revived. Without it a demoted member comes
        back only when some register consults it after its window, so a
        quiet daemon would stay on the pex or back-source rungs after the
        scheduler healed. A revived member that is still sick is demoted
        again by the next register that uses it."""
        async def probe(addr: str) -> str | None:
            host, _, port = addr.rpartition(":")
            if not host or not port.isdigit():
                return None
            try:
                _r, w = await asyncio.wait_for(
                    asyncio.open_connection(host, int(port)), timeout_s)
            except (OSError, asyncio.TimeoutError):
                return None
            w.close()
            try:
                await w.wait_closed()
            except OSError:
                pass
            return addr

        # concurrent: with the whole ring down, serial probes would stall
        # the gossip round by timeout_s per member
        results = await asyncio.gather(*(probe(a)
                                         for a in list(self._demoted)))
        revived = [a for a in results if a is not None]
        for addr in revived:
            self.revive(addr)
        return revived

    def export_demotions(self) -> dict:
        """The demotions as remaining seconds per member (monotonic
        stamps do not outlive the process), for the daemon to persist."""
        now = time.monotonic()
        return {"v": 1,
                "demoted": {a: round(t - now, 3)
                            for a, t in self._demoted.items() if t > now}}

    def restore_demotions(self, state: dict | None) -> int:
        """Re-arm demotions from a prior process. A blob of another schema
        is refused whole; each window is clamped to ``demote_s`` (a skewed
        or hand-edited blob must not demote a member for hours), and
        members no longer in the address set are dropped."""
        if not isinstance(state, dict) or state.get("v") != 1:
            return 0
        now = time.monotonic()
        known = set(self.addresses)
        n = 0
        for addr, remaining in (state.get("demoted") or {}).items():
            try:
                rem = min(float(remaining), self.demote_s)
            except (TypeError, ValueError):
                continue
            if rem <= 0 or addr not in known:
                continue
            self._demoted[addr] = now + rem
            n += 1
        if n:
            log.info("restored %d demoted scheduler(s) from prior run", n)
        return n

    def _candidates(self, key: str) -> list[str]:
        """Failover order for ``key``: live ring members first, demoted
        ones last (a dead scheduler still beats silently going to
        origin)."""
        cands = self._ring.pick_n(key, self.failover_n)
        live = [a for a in cands if self._alive(a)]
        return live + [a for a in cands if a not in live]

    def _client_at(self, addr: str, *, max_attempts: int = 3) -> ServiceClient:
        ch = self._channels.get(addr)
        if ch is None:
            ch = self._channels[addr] = Channel(addr)
        return ServiceClient(ch, SCHEDULER_SERVICE, max_attempts=max_attempts)

    async def register(self, conductor: "PeerTaskConductor") -> PeerSession:
        cands = self._candidates(conductor.task_id)
        if not cands:
            raise DFError(Code.UNAVAILABLE, "no scheduler addresses")
        flight = getattr(conductor, "flight", None)
        request = RegisterPeerTaskRequest(
            url=conductor.url, url_meta=conductor.url_meta,
            task_id=conductor.task_id, peer_id=conductor.peer_id,
            peer_host=self.host)
        last_exc: BaseException | None = None
        for i, addr in enumerate(cands):
            # one attempt per member: retrying a dead address in place
            # only delays the healthy one clockwise of it
            client = self._client_at(addr, max_attempts=1)
            try:
                if faultgate.ARMED:
                    # bounded by the register timeout, so a 'hang' walks
                    # the deadline-then-failover path a wedged member would
                    await asyncio.wait_for(
                        faultgate.fire("sched.register", key=addr),
                        self.register_timeout_s)
                result: RegisterResult = await client.unary(
                    "RegisterPeerTask", request,
                    timeout=self.register_timeout_s)
            except DFError as exc:
                if exc.code not in _FAILOVER_CODES:
                    raise          # a verdict, not a dead scheduler
                last_exc = exc
            except (RPCError, OSError, asyncio.TimeoutError) as exc:
                last_exc = exc
            else:
                self.revive(addr)
                self.note_epoch(int(result.scheduler_epoch))
                if i > 0:
                    if flight is not None:
                        flight.rung(fr.RUNG_RING_FAILOVER)
                    # the member clockwise of a dead one may know nothing
                    # of this daemon's holdings: replay them at it
                    self.mark_reconcile()
                if int(result.resolved_priority) != 0:
                    conductor.resolved_priority = int(
                        result.resolved_priority)
                session = PeerSession(self._client_at(addr), result,
                                      conductor)
                await session.open_report_stream()
                return session
            self.demote(addr)
            log.warning("register on %s failed (%s); trying next ring "
                        "member", addr, last_exc)
        raise DFError(
            Code.UNAVAILABLE,
            f"all {len(cands)} scheduler ring members unreachable "
            f"(last: {last_exc})")

    async def _announce(self, method: str, request, timeout: float):
        """One announce unary at the scheduler this host hashes to, with
        the single-retry envelope; the answer's epoch is noted."""
        if not self.addresses:
            return None
        cands = self._candidates(self.host.id)
        if not cands:
            raise DFError(Code.UNAVAILABLE, "no scheduler addresses")
        # the outer Retrier is the only retry layer (one-attempt client)
        client = self._client_at(cands[0], max_attempts=1)
        resp = await Retrier(_REPORT_RETRY).run(
            lambda: client.unary(method, request, timeout=timeout),
            retryable=lambda exc: not isinstance(exc, DFError)
            or exc.code in _FAILOVER_CODES)
        self.note_epoch(int(getattr(resp, "scheduler_epoch", 0)))
        return resp

    async def announce_host(self, request):
        """Host stats to the scheduler (the announcer's heartbeat)."""
        return await self._announce("AnnounceHost", request, 5.0)

    async def announce_content(self, request):
        """Replay held content at the scheduler (recovery). A scheduler
        that stays away gets the replay on a later interval."""
        return await self._announce("AnnounceContent", request, 10.0)

    async def sync_probes(self):
        """Open the probe bidi stream (``networktopology`` drives it) on
        the scheduler this host hashes to."""
        cands = self._candidates(self.host.id)
        if not cands:
            raise DFError(Code.UNAVAILABLE, "no scheduler addresses")
        return self._client_at(cands[0]).stream_stream("SyncProbes")

    async def leave_host(self) -> None:
        cands = self._candidates(self.host.id)
        if not cands:
            return
        try:
            await self._client_at(cands[0], max_attempts=1).unary(
                "LeaveHost", LeaveHostRequest(host_id=self.host.id),
                timeout=3.0)
        except Exception as exc:  # noqa: BLE001 - best effort on shutdown
            log.debug("LeaveHost failed: %s", exc)

    async def close(self) -> None:
        if self._close_tasks:
            await asyncio.gather(*list(self._close_tasks),
                                 return_exceptions=True)
            self._close_tasks.clear()
        for ch in self._channels.values():
            await ch.close()
        self._channels.clear()
