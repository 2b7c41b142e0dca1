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
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from urllib.parse import urlsplit

from ..common.errors import DFError
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

_REASONS = {200: "OK", 206: "Partial Content", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed",
            416: "Range Not Satisfiable", 431: "Request Header Fields Too "
            "Large", 503: "Service Unavailable"}
_HEAD_LIMIT = 64 << 10


class _HTTPError(Exception):
    def __init__(self, status: int, text: str, headers: dict | None = None):
        super().__init__(text)
        self.status = status
        self.text = text
        self.headers = headers or {}


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


def _head(status: int, headers: dict) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class UploadServer:
    # concurrent transfers served at once when the config says "auto" (0);
    # beyond this the server answers 503 and the child reroutes
    DEFAULT_CONCURRENT_LIMIT = 6
    # how long a request may queue for a slot before 503ing
    SLOT_WAIT_S = 0.2

    def __init__(self, storage_mgr: StorageManager, *, port: int = 0,
                 rate_limit_bps: int = 0, concurrent_limit: int = 0,
                 host: str = "0.0.0.0"):
        self.storage_mgr = storage_mgr
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
            self._on_conn, self.host, self.port, limit=_HEAD_LIMIT)
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
            while True:
                try:
                    raw = await reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError:
                    return                    # client closed between requests
                except asyncio.LimitOverrunError:
                    await self._send_error(writer, _HTTPError(
                        431, "request head too large"), keep=False)
                    return
                method, target, headers = self._parse_request(raw)
                keep = headers.get("connection", "").lower() != "close"
                length = int(headers.get("content-length") or 0)
                if length:
                    await reader.readexactly(length)   # discard a body
                try:
                    await self._route(method, target, headers, writer)
                except _HTTPError as exc:
                    await self._send_error(writer, exc, keep=keep)
                if not keep:
                    return
        except (ConnectionError, ValueError, asyncio.IncompleteReadError) \
                as exc:
            log.debug("upload connection dropped: %s", exc)
        finally:
            self._conns.discard(task)
            writer.close()

    @staticmethod
    def _parse_request(raw: bytes) -> tuple[str, str, dict]:
        lines = raw[:-4].decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise ValueError(f"bad request line {lines[0]!r}")
        headers = {}
        for line in lines[1:]:
            k, sep, v = line.partition(":")
            if not sep:
                raise ValueError(f"bad header line {line!r}")
            headers[k.strip().lower()] = v.strip()
        return parts[0], parts[1], headers

    @staticmethod
    async def _send_error(writer, exc: _HTTPError, *, keep: bool) -> None:
        body = exc.text.encode()
        headers = {"Content-Type": "text/plain; charset=utf-8",
                   "Content-Length": str(len(body)), **exc.headers}
        if not keep:
            headers["Connection"] = "close"
        writer.write(_head(exc.status, headers) + body)
        await writer.drain()

    async def _route(self, method: str, target: str, headers: dict,
                     writer) -> None:
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
        if len(parts) == 4 and parts[1] == "download" and all(parts[2:]):
            if method != "GET":
                raise _HTTPError(405, "405: Method Not Allowed")
            await self._serve(parts[3], headers, writer)
            return
        raise _HTTPError(404, "404: Not Found")

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

    async def _serve(self, task_id: str, headers: dict, writer) -> None:
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
        if not ts.has_range(rng.start, rng.length):
            _upload_reqs.labels("416").inc()
            raise _HTTPError(
                416, f"bytes {rng.start}+{rng.length} not stored yet")
        slot = await self._acquire_slot()
        try:
            await self.limiter.acquire(rng.length)
            head = {"Content-Range":
                    f"bytes {rng.start}-{rng.end - 1}/"
                    f"{total if total >= 0 else '*'}",
                    "Content-Type": "application/octet-stream",
                    "Content-Length": str(rng.length),
                    "Accept-Ranges": "bytes",
                    **self._progress_headers(ts)}
            if total >= 0:
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
                writer.write(_head(206, head) + data)
                await writer.drain()
            _upload_bytes.inc(rng.length)
            _upload_reqs.labels("206").inc()
            if self.storage_mgr.castore is not None:
                # what this daemon serves is what the GC should keep
                self.storage_mgr.castore.record_serve(task_id, rng.length)
        finally:
            slot.release()
