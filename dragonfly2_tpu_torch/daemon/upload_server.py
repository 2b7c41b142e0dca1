"""Upload server: the HTTP surface other peers fetch pieces from.

Counterpart of ``dragonfly2_tpu/daemon/upload_server.py`` (reference
``client/daemon/upload/upload_manager.go``): ``GET /download/{prefix}/
{task_id}?peerId=`` with a ``Range`` header, served from the piece store,
rate-limited, plus ``GET /healthy``. The reference serves with
``aiohttp.web``; the card's machine has no aiohttp, so this module speaks
HTTP/1.1 on ``asyncio.start_server`` with the same routes, status codes
and headers: 404 for an unknown task, 400 without ``Range``, 416 for a
range that cannot be parsed or is not stored yet, 503 with
``X-Retry-After-Ms`` when the concurrency gate stays full, 206 otherwise.

A gate slot is held for the whole transmit (the reference's ``_Slot``):
the scheduler's upload-slot accounting assumes a busy parent answers 503.
A whole-file task's range goes out with ``loop.sendfile`` (the bytes
never enter Python); the disk-read branch serves the rest.

Cut-through relay (``relay.py``): a range that is not stored yet, of a
task the relay hub tracks, is streamed against the landing frontier
(``_serve_relay``) in writes of at most 1 MiB, with ``Content-Length``
known up front and ``X-DF-Relay: 1`` set; without a hub (or for an
untracked task) it stays 416. Each served range is journaled on the
task's flight (``TaskFlight.serve``), and ``GET /debug/flight`` and
``/debug/flight/<task_id>`` read the daemon's flight recorder
(``flight_recorder.add_flight_routes``).

With a PEX gossiper (``pex.py``), ``GET``/``POST /pex/digest``,
``GET``/``POST /pex/summary`` and ``GET /debug/pex`` are routed too
(``pex.add_pex_routes``); with a verdict ledger (``verdicts.py``),
``GET /debug/verdicts``; ``GET /debug/health`` always, and with
``debug_endpoints`` ``/debug/stacks``, ``/debug/profile`` and
``GET``/``POST``/``DELETE /debug/faults``. The routes, the parser and the
connection loop are ``common/httpd.py``'s. Routed requests take no slot
of the piece gate, so a gossip exchange never waits behind piece serves.
A piece request carrying a ``traceparent`` header is served inside an
``upload.serve`` span of that trace.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import Counter, deque
from urllib.parse import parse_qs, urlsplit

from ..common import faultgate, httpd, tracing
from ..common.errors import DFError
from ..common.httpd import HTTPError as _HTTPError
from ..common.httpd import head as _head
from ..common.metrics import REGISTRY
from ..common.piece import parse_http_range
from ..common.rate import TokenBucket
from ..storage.io_executor import run_io
from ..storage.manager import StorageManager

log = logging.getLogger("df.http.upload")

_upload_bytes = REGISTRY.counter("df_upload_bytes_total",
                                 "bytes served to other peers")
_upload_reqs = REGISTRY.counter("df_upload_requests_total",
                                "piece requests served", ("status",))
_upload_active = REGISTRY.gauge("df_upload_active_transfers",
                                "concurrency-gate slots currently held")
# cut-through relay serving: ranges streamed against the landing watermark
# instead of refused as incomplete
_relay_serves = REGISTRY.counter(
    "df_relay_serves_total",
    "streaming relay range serves", ("result",))
_relay_bytes = REGISTRY.counter(
    "df_relay_bytes_total",
    "bytes served by the streaming relay path", ("src",))
_relay_stalls = REGISTRY.counter(
    "df_relay_stalls_total",
    "relay serves aborted because the landing watermark stopped advancing")
_relay_wait_secs = REGISTRY.histogram(
    "df_relay_wait_seconds",
    "time a streaming relay serve spent awaiting landing progress")

class _Slot:
    """One concurrency-gate slot, held until the response body is fully
    written (or the connection dies)."""

    __slots__ = ("server", "released", "t0")

    def __init__(self, server: "UploadServer", *, adopted: bool = False):
        """``adopted``: the capacity was handed over by a releasing
        transfer; ``_active`` already counts it."""
        self.server = server
        self.released = False
        self.t0 = time.monotonic()
        if not adopted:
            server._active += 1
            _upload_active.set(server._active)

    def release(self) -> None:
        if self.released:
            return
        self.released = True
        srv = self.server
        # feed the busy-hint EWMA with the observed hold time
        held_ms = (time.monotonic() - self.t0) * 1000.0
        srv._transfer_ms = (0.8 * srv._transfer_ms + 0.2 * held_ms
                            if srv._transfer_ms > 0 else held_ms)
        srv._transfer_ms_at = time.monotonic()
        # hand the slot straight to the longest-queued request, so a fresh
        # arrival cannot win the race against the woken waiter
        srv._pass_on_slot()


class UploadServer:
    # concurrent transfers served at once when the config says "auto" (0);
    # beyond this the server answers 503 and the child reroutes
    DEFAULT_CONCURRENT_LIMIT = 6
    # how long a request may queue for a slot before 503ing
    SLOT_WAIT_S = 0.2
    # most bytes moved per streaming-relay write: bounds the on-loop copy
    # from a live span's buffer and keeps the limiter granular
    RELAY_CHUNK = 1 << 20

    def __init__(self, storage_mgr: StorageManager, *, port: int = 0,
                 rate_limit_bps: int = 0, concurrent_limit: int = 0,
                 host: str = "0.0.0.0", flight_recorder=None, relay=None,
                 relay_stall_s: float = 10.0, pex=None,
                 debug_endpoints: bool = False, verdicts=None):
        self.storage_mgr = storage_mgr
        self.flight_recorder = flight_recorder
        self.relay = relay                  # RelayHub (None = store-and-forward)
        self.relay_stall_s = relay_stall_s  # per-wait watermark deadline
        # this daemon's host id (set by the bootstrap): scopes the
        # ``upload.serve`` faultgate key to one daemon
        self.host_id = ""
        # this server's own relay tallies (the df_relay_* metrics are
        # process-wide; several daemons may share a process)
        self.relay_serves: Counter = Counter()
        self.relay_bytes: Counter = Counter()
        self.router = httpd.Router()
        if flight_recorder is not None:
            from .flight_recorder import add_flight_routes
            add_flight_routes(self.router, flight_recorder)
        if pex is not None:
            from .pex import add_pex_routes
            add_pex_routes(self.router, pex)
        self.verdicts = verdicts            # VerdictLedger (/debug/verdicts)
        if verdicts is not None:
            # per-parent verdict readout: always on, a poisoned pod must
            # be diagnosable (``dfdiag --pod`` sweeps it)
            from .verdicts import add_verdict_routes
            add_verdict_routes(self.router, verdicts)
        # the health snapshot is read-only and cheap: always on, so a
        # wedged daemon is diagnosable without a restart
        from ..common.health import add_health_routes
        add_health_routes(self.router)
        if debug_endpoints:
            # the pprof-analog surface and the fault-injection control
            # plane: off by default (profiling slows every call on the
            # loop's thread, arming faults mutates live behaviour, and any
            # mesh peer reaches this port)
            from ..common.debug_http import add_debug_routes
            add_debug_routes(self.router)
            faultgate.add_fault_routes(self.router)
        self.host = host
        self.port = port
        self.limiter = TokenBucket(rate_limit_bps or 0)
        self.concurrent_limit = (concurrent_limit
                                 or self.DEFAULT_CONCURRENT_LIMIT)
        self._active = 0
        self._transfer_ms = 0.0     # EWMA slot-hold time -> 503 retry hint
        self._transfer_ms_at = 0.0
        self._slot_waiters: deque = deque()
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()

    def _pass_on_slot(self) -> None:
        """Give a freed slot to the next live waiter, else return it to
        capacity. Cancelled waiters are skipped: setting a result on one
        would strand the slot."""
        while self._slot_waiters:
            fut = self._slot_waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return
        self._active -= 1
        _upload_active.set(self._active)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port, limit=httpd.HEAD_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("upload server on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    # ------------------------------------------------------------------

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await httpd.serve_connection(reader, writer, self._route)
        finally:
            self._conns.discard(task)

    async def _route(self, method: str, target: str, headers: dict,
                     writer, body: bytes = b"") -> None:
        url = urlsplit(target)
        parts = url.path.split("/")
        if url.path == "/healthy":
            if method != "GET":
                raise _HTTPError(405, "405: Method Not Allowed")
            writer.write(_head(200, {
                "Content-Type": "text/plain; charset=utf-8",
                "Content-Length": "2"}) + b"ok")
            await writer.drain()
            return
        query = {k: v[0] for k, v in parse_qs(url.query).items()}
        if len(parts) == 4 and parts[1] == "download" and all(parts[2:]):
            if method != "GET":
                raise _HTTPError(405, "405: Method Not Allowed")
            await self._traced(parts[3], headers, writer, query)
            return
        if await self.router.dispatch(method, target, writer, body):
            return
        raise _HTTPError(404, "404: Not Found")

    async def _traced(self, task_id: str, headers: dict, writer,
                      query: dict) -> None:
        """The server half of a piece request's trace: the child's
        traceparent rides the GET (``piece_downloader``) and this span
        joins its trace, so one trace id follows a transfer across both
        daemons."""
        parent = tracing.from_traceparent(headers.get("traceparent", ""))
        if parent is None and not tracing.TRACER.enabled:
            await self._serve(task_id, headers, writer, query)
            return
        with tracing.span("upload.serve", parent=parent,
                          peer=query.get("peerId", "")[-16:],
                          range=headers.get("range", "")) as sp:
            try:
                await self._serve(task_id, headers, writer, query)
            except _HTTPError as exc:
                sp.set(status=exc.status)
                raise
            sp.set(status=206)

    @staticmethod
    def _progress_headers(ts) -> dict:
        """``X-DF-Piece-Progress``: pieces landed / total at this holder."""
        md = ts.md
        return {"X-DF-Piece-Progress":
                f"{len(md.pieces)}/{md.total_piece_count}"}

    async def _acquire_slot(self) -> _Slot:
        """A gate slot, queueing up to ``SLOT_WAIT_S`` behind earlier
        waiters; a gate still full after that answers 503 with a retry
        hint of about one measured transfer time."""
        if self._active < self.concurrent_limit and not self._slot_waiters:
            return _Slot(self)
        deadline = time.monotonic() + self.SLOT_WAIT_S
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                _upload_reqs.labels("503").inc()
                # a congested-era EWMA must not dictate backoffs after the
                # burst has passed: old hints decay to the floor
                ewma = self._transfer_ms
                age_ms = (time.monotonic() - self._transfer_ms_at) * 1e3
                if ewma > 0 and age_ms > 10 * max(ewma, 100.0):
                    ewma = 0.0
                hint_ms = int(min(max(ewma, 50.0), 2000.0))
                raise _HTTPError(503, "upload concurrency limit", {
                    "Retry-After": str(-(-hint_ms // 1000)),
                    "X-Retry-After-Ms": str(hint_ms)})
            fut = asyncio.get_running_loop().create_future()
            self._slot_waiters.append(fut)
            try:
                await asyncio.wait_for(fut, remaining)
            except asyncio.TimeoutError:
                if fut.done() and not fut.cancelled():
                    return _Slot(self, adopted=True)   # landed at the wire
                continue
            except BaseException:
                # request died while queued: re-home a slot handed to us
                if fut.done() and not fut.cancelled():
                    self._pass_on_slot()
                else:
                    fut.cancel()
                raise
            return _Slot(self, adopted=True)

    def _journal(self, task_id: str, ts, rng, query: dict, writer,
                 slot: _Slot, *, wait_ms: float,
                 relayed: bool = False) -> None:
        """One completed serve: the storage GC's popularity feed and one
        edge row (requesting peer, first piece and piece count, bytes,
        slot-hold and limiter-wait ms) on the task's flight."""
        if self.storage_mgr.castore is not None:
            # what this daemon serves is what the GC should keep
            self.storage_mgr.castore.record_serve(task_id, rng.length)
        if self.flight_recorder is None:
            return
        flight = self.flight_recorder.serving(task_id)
        if flight is None:
            return
        piece_size = ts.md.piece_size
        peer = writer.get_extra_info("peername")
        flight.serve(
            peer=query.get("peerId", ""),
            addr=f"{peer[0]}" if isinstance(peer, tuple) else "",
            piece=rng.start // piece_size if piece_size > 0 else -1,
            nbytes=rng.length,
            serve_ms=(time.monotonic() - slot.t0) * 1000.0,
            wait_ms=wait_ms,
            pieces=-(-rng.length // piece_size) if piece_size > 0 else 1,
            relayed=relayed)

    async def _serve(self, task_id: str, headers: dict, writer,
                     query: dict | None = None) -> None:
        query = query or {}
        ts = self.storage_mgr.get(task_id)
        if ts is None:
            _upload_reqs.labels("404").inc()
            raise _HTTPError(404, f"task {task_id[:12]} not found")
        total = ts.md.content_length
        rng_header = headers.get("range", "")
        if not rng_header:
            _upload_reqs.labels("400").inc()
            raise _HTTPError(400, "Range header required for piece reads")
        try:
            rng = parse_http_range(rng_header,
                                   total if total >= 0 else (1 << 62))
        except ValueError as exc:
            _upload_reqs.labels("416").inc()
            raise _HTTPError(416, str(exc)) from None
        streaming = False
        if not ts.has_range(rng.start, rng.length):
            if self.relay is not None and self.relay.active(task_id):
                # the task is mid-landing here: stream the range against
                # the landing watermark instead of refusing it
                streaming = True
            else:
                _upload_reqs.labels("416").inc()
                raise _HTTPError(
                    416, f"bytes {rng.start}+{rng.length} not stored yet")
        slot = await self._acquire_slot()
        try:
            if streaming:
                await self._serve_relay(task_id, ts, rng, slot, query,
                                        writer)
                return
            # a corrupt script armed for this daemon routes the serve off
            # sendfile (whose bytes never enter Python) so they can flip
            fkey = f"{self.host_id}|{task_id}"
            poisoned = faultgate.ARMED and faultgate.peek(
                "upload.serve", fkey, kinds=frozenset({"corrupt"}))
            wait_t0 = time.monotonic()
            await self.limiter.acquire(rng.length)
            wait_ms = (time.monotonic() - wait_t0) * 1000.0
            head = {"Content-Range":
                    f"bytes {rng.start}-{rng.end - 1}/"
                    f"{total if total >= 0 else '*'}",
                    "Content-Type": "application/octet-stream",
                    "Content-Length": str(rng.length),
                    "Accept-Ranges": "bytes",
                    **self._progress_headers(ts)}
            if total >= 0 and not poisoned:
                # whole-file task: the kernel moves the bytes (sendfile)
                loop = asyncio.get_running_loop()
                try:
                    f = open(ts.data_path(), "rb")
                except OSError as exc:
                    self.limiter.refund(rng.length)
                    _upload_reqs.labels("404").inc()
                    raise _HTTPError(404, str(exc)) from None
                try:
                    writer.write(_head(206, head))
                    await loop.sendfile(writer.transport, f, rng.start,
                                        rng.length)
                finally:
                    f.close()
            else:
                try:
                    data = await run_io(ts.read_range, rng.start, rng.length)
                except (DFError, OSError) as exc:
                    # the bytes were never moved: hand the tokens back
                    self.limiter.refund(rng.length)
                    _upload_reqs.labels("404").inc()
                    msg = exc.message if isinstance(exc, DFError) else str(exc)
                    raise _HTTPError(404, msg) from None
                if poisoned:
                    data = faultgate.corrupt("upload.serve", data, key=fkey)
                writer.write(_head(206, head) + data)
                await writer.drain()
            _upload_bytes.inc(rng.length)
            _upload_reqs.labels("206").inc()
            self._journal(task_id, ts, rng, query, writer, slot,
                          wait_ms=wait_ms)
        finally:
            slot.release()

    async def _serve_relay(self, task_id: str, ts, rng, slot: _Slot,
                           query: dict, writer) -> None:
        """Cut-through range serve: stream bytes up to the landing
        frontier (verified pieces on disk, then the live span's
        watermark), awaiting further progress with a bounded deadline.

        Outcomes: ``ok`` (the whole range went out, possibly before this
        daemon finished the piece, which is the point); a stall or an
        eviction before the first byte answers 503 with a retry hint (the
        child requeues without a strike, as from any busy parent); a stall
        or eviction mid-stream closes the connection, so the child sees a
        short read and requeues the piece against another holder. Limiter
        tokens are taken per chunk for exactly the bytes about to move and
        refunded when a write fails."""
        relay = self.relay
        total = ts.md.content_length
        landed, total_pieces = relay.progress(task_id, ts)
        head = _head(206, {
            "Content-Range": f"bytes {rng.start}-{rng.end - 1}/"
                             f"{total if total >= 0 else '*'}",
            "Content-Type": "application/octet-stream",
            "Content-Length": str(rng.length),
            "Accept-Ranges": "bytes",
            "X-DF-Piece-Progress": f"{landed}/{total_pieces}",
            "X-DF-Relay": "1"})
        pos = rng.start
        wait_s = 0.0
        limiter_ms = 0.0
        # exits that never set a verdict (the child went away) are aborts
        result = "aborted"
        # the stall deadline re-arms only when THIS reader's frontier
        # moves: task-wide pulses wake the wait, but a serve parked at an
        # offset that never advances still expires in relay_stall_s
        stall_at = time.monotonic() + self.relay_stall_s
        last_avail = pos
        fkey = f"{self.host_id}|{task_id}"
        # one corrupt attempt per serve (one flipped byte fails the piece)
        poison_pending = faultgate.ARMED and faultgate.peek(
            "upload.serve", fkey, kinds=frozenset({"corrupt"}))
        try:
            while pos < rng.end:
                if faultgate.ARMED:
                    # 'hang' models an upstream whose watermark stopped:
                    # bounded by the same deadline a real one gets
                    try:
                        await asyncio.wait_for(
                            faultgate.fire("relay.stall", key=task_id),
                            self.relay_stall_s)
                    except asyncio.TimeoutError:
                        result = "stall"
                        _relay_stalls.inc()
                        break
                avail = relay.available_end(task_id, ts, pos, rng.end)
                if avail > last_avail:
                    last_avail = avail
                    stall_at = time.monotonic() + self.relay_stall_s
                if avail <= pos:
                    if not relay.active(task_id):
                        # the task ended here without covering the rest
                        result = "abandoned"
                        break
                    remaining = stall_at - time.monotonic()
                    if remaining <= 0:
                        result = "stall"
                        _relay_stalls.inc()
                        break
                    w0 = time.monotonic()
                    await relay.wait_progress(task_id, remaining)
                    wait_s += time.monotonic() - w0
                    continue
                n = min(self.RELAY_CHUNK, avail - pos)
                try:
                    chunk = relay.read_span(task_id, pos, n)
                    src = "span"
                    if chunk is None:
                        # landed region: the verified bytes from disk,
                        # clamped to what the piece table holds at pos
                        hi = ts.covered_prefix(pos, pos + n)
                        if hi <= pos:
                            # raced: the span retired between the check
                            # and the read
                            await relay.wait_progress(task_id, 0.05)
                            continue
                        chunk = await run_io(ts.read_range, pos, hi - pos)
                        src = "storage"
                except (DFError, OSError):
                    result = "evicted"      # no tokens held yet
                    break
                if not chunk:
                    await relay.wait_progress(task_id, 0.05)
                    continue
                if poison_pending:
                    poison_pending = False
                    chunk = faultgate.corrupt("upload.serve", chunk, key=fkey)
                l0 = time.monotonic()
                await self.limiter.acquire(len(chunk))
                limiter_ms += (time.monotonic() - l0) * 1000.0
                try:
                    if head is not None:
                        writer.write(head + chunk)
                        head = None
                    else:
                        writer.write(chunk)
                    await writer.drain()
                except BaseException:
                    self.limiter.refund(len(chunk))   # never moved
                    raise
                _relay_bytes.labels(src).inc(len(chunk))
                self.relay_bytes[src] += len(chunk)
                _upload_bytes.inc(len(chunk))
                pos += len(chunk)
            if pos >= rng.end:
                result = "ok"
        finally:
            _relay_wait_secs.observe(wait_s)
            _relay_serves.labels(result).inc()
            self.relay_serves[result] += 1
            if result == "ok":
                _upload_reqs.labels("206").inc()
                self._journal(task_id, ts, rng, query, writer, slot,
                              wait_ms=limiter_ms, relayed=True)
        if result == "ok":
            return
        if head is not None:
            # nothing sent yet: a clean 503 with a retry hint
            _upload_reqs.labels("503").inc()
            raise _HTTPError(503, f"relay {result}: watermark not advancing",
                             {"Retry-After": "1",
                              "X-Retry-After-Ms": "500"})
        # mid-stream: close the connection so the child sees a short read
        # instead of a clean end
        raise ConnectionResetError(f"relay serve aborted: {result}")
