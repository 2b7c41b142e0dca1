"""Piece downloader: the bulk data path between peers.

Counterpart of ``dragonfly2_tpu/daemon/piece_downloader.py`` (reference
``client/daemon/peer/piece_downloader.go:165-229``): ``GET http://{dst}/
download/{task_id[:3]}/{task_id}?peerId=`` with a ``Range`` header against
the parent's upload server. The reference rides an aiohttp session; the
card's machine has no aiohttp, so this module speaks HTTP/1.1 itself over
keep-alive connections per parent (``asyncio`` protocols, at most
``max_connections`` open). The body lands straight in a pooled buffer
(``common/bufpool.py``): the socket reads into it, with no copy on the
event loop. Digests are checked later, in the storage landing pass.

Cut-through relay (``daemon/relay.py``): ``relay_open(buf)`` registers the
pooled buffer as an in-flight span once it is acquired, and every read
into it advances the span's watermark (one integer store; the body bytes
that arrive with the response head are copied in and counted too). A
failed fetch retires the span before the buffer returns to the pool. A
response carrying ``X-DF-Relay: 1`` (the parent streamed it against its
own landing watermark) sets ``meta["relayed"]``. ``on_first_byte`` fires
once, when the first body bytes land (the flight recorder's
``first_byte``).

Failures carry the reference's codes and typed verdicts: 503 is
``CLIENT_PEER_BUSY`` with the parent's retry hint; any other non-2xx is
``CLIENT_PIECE_DOWNLOAD_FAIL`` ("refused"); a short body, a wrong
``Content-Length`` or a reset mid-body is ``CLIENT_PIECE_DOWNLOAD_FAIL``
("stall"); the per-piece deadline is ``CLIENT_PIECE_DOWNLOAD_FAIL``
("timeout"); a refused connection is "refused".

Under fleet mTLS (``tls``: cert, key and the fleet CA) the GETs ride
https with the daemon's leaf as the client certificate (the reference's
``check_hostname=False`` and ``CERT_REQUIRED``: peers are dialed by IP,
and the fleet CA's signature is the authentication). asyncio's TLS
transport feeds the same buffered protocol, so the decrypted body still
lands straight in the caller's buffer.
"""

from __future__ import annotations

import asyncio
import logging
import time
from urllib.parse import quote

from ..common import faultgate, tracing
from ..common.bufpool import POOL
from ..common.errors import Code, DFError
from ..idl.messages import PieceInfo
from ..source.http_client import fleet_client_context

log = logging.getLogger("df.flow.piecedl")

_HEAD_LIMIT = 64 << 10        # response head bytes accepted
_ERROR_BODY_LIMIT = 64 << 10  # non-2xx body bytes read before closing


def _classified(code: Code, message: str, fail_code: str) -> DFError:
    """DFError carrying a typed failure verdict (corrupt, stall, timeout,
    refused)."""
    err = DFError(code, message)
    err.fail_code = fail_code
    return err


class _Stall(Exception):
    """The response ended or broke before its body was complete."""


class _Conn(asyncio.BufferedProtocol):
    """One keep-alive HTTP/1.1 client connection. The response head is
    parsed from a scratch buffer; a 2xx body of the expected size is read
    by the kernel straight into the caller's buffer."""

    def __init__(self) -> None:
        self.transport: asyncio.Transport | None = None
        self.closed = False
        self.used = False                # carried a response before
        self._scratch = bytearray(64 << 10)
        self._head = bytearray()
        self._state = "idle"             # idle | head | body | dropped
        self._fut: asyncio.Future | None = None
        self._dst: memoryview | None = None
        self._want = 0                   # expected 2xx body size
        self._body: memoryview | None = None
        self._off = 0
        self._got_bytes = False
        self._progress = None            # callable(body bytes so far)
        self.status = 0
        self.headers: dict[str, str] = {}

    # -- protocol callbacks --------------------------------------------

    def connection_made(self, transport) -> None:
        self.transport = transport

    def get_buffer(self, sizehint: int):
        if self._state == "body":
            return self._body[self._off:]
        return memoryview(self._scratch)

    def buffer_updated(self, nbytes: int) -> None:
        self._got_bytes = True
        if self._state == "dropped":
            return      # an abandoned response's bytes; the close is due
        if self._state == "body":
            self._off += nbytes
            if self._progress is not None:
                self._progress(self._off)
            if self._off == len(self._body):
                self._done()
            return
        if self._state != "head":
            self._fail(_Stall("bytes outside a response"))
            return
        self._head += self._scratch[:nbytes]
        end = self._head.find(b"\r\n\r\n")
        if end < 0:
            if len(self._head) > _HEAD_LIMIT:
                self._fail(_Stall("response head too large"))
            return
        rest = bytes(self._head[end + 4:])
        try:
            self._parse_head(bytes(self._head[:end]))
            length = int(self.headers.get("content-length", "-1"))
        except ValueError as exc:
            self._fail(_Stall(f"bad response head: {exc}"))
            return
        self._head.clear()
        if self.status in (200, 206):
            if length != self._want:
                self._fail(_Stall(f"Content-Length {length}, "
                                  f"want {self._want}"))
                return
            self._body = self._dst[:length]
        elif 0 <= length <= _ERROR_BODY_LIMIT:
            self._body = memoryview(bytearray(length))
        else:
            self._fail(_Stall(f"unbounded {self.status} body"))
            return
        if len(rest) > len(self._body):
            self._fail(_Stall("long read"))
            return
        self._body[:len(rest)] = rest
        self._off = len(rest)
        self._state = "body"
        if self.status not in (200, 206):
            self._progress = None       # an error body is not the piece
        elif self._off and self._progress is not None:
            # body bytes that came with the head count toward the
            # watermark as well
            self._progress(self._off)
        if self._off == len(self._body):
            self._done()

    def eof_received(self) -> bool:
        return False           # close our side too

    def connection_lost(self, exc) -> None:
        self.closed = True
        if self._fut is not None and not self._fut.done():
            self._fut.set_exception(_Stall(
                f"connection closed after {self._off} body bytes"
                if self._state == "body" else "connection closed"))

    # -- request lifecycle ---------------------------------------------

    def _parse_head(self, raw: bytes) -> None:
        lines = raw.decode("latin-1").split("\r\n")
        version, _, rest = lines[0].partition(" ")
        if not version.startswith("HTTP/1."):
            raise ValueError(lines[0])
        self.status = int(rest.split(" ", 1)[0])
        self.headers = {}
        for line in lines[1:]:
            k, sep, v = line.partition(":")
            if not sep:
                raise ValueError(line)
            self.headers[k.strip().lower()] = v.strip()

    def _done(self) -> None:
        self._state = "idle"
        if self._fut is not None and not self._fut.done():
            self._fut.set_result(None)

    def _fail(self, exc: Exception) -> None:
        self._state = "idle"
        if self._fut is not None and not self._fut.done():
            self._fut.set_exception(exc)
        self.close()

    def request(self, raw: bytes, dst: memoryview,
                progress=None) -> asyncio.Future:
        """Send one request; the future resolves once the whole response
        is in (``dst`` holds a 2xx body). ``progress(n)`` is called with
        the 2xx body bytes landed in ``dst`` so far, after every read."""
        self._fut = asyncio.get_running_loop().create_future()
        self._progress = progress
        self._dst = dst
        self._want = len(dst)
        self._body = None
        self._off = 0
        self._got_bytes = False
        self._state = "head"
        self.transport.write(raw)
        return self._fut

    def release_dst(self) -> None:
        """Drop every view of the caller's buffer (the pool's reuse
        check refuses a buffer that is still exported). A response cut
        short leaves its later bytes nowhere to land: a TLS transport
        closes after it has delivered what it already decrypted."""
        if self._state == "body":
            self._state = "dropped"
        self._dst = None
        self._body = None
        self._progress = None

    def keep_alive(self) -> bool:
        return (not self.closed and self._state == "idle"
                and self.headers.get("connection", "").lower() != "close")

    def close(self) -> None:
        self.closed = True
        if self.transport is not None:
            self.transport.close()


class PieceDownloader:
    def __init__(self, *, timeout_s: float = 30.0, max_connections: int = 64,
                 tls: tuple[str, str, str] | None = None):
        """``tls``: (cert, key, ca), the fleet mTLS material; piece GETs
        then ride https presenting the client leaf."""
        self.timeout_s = timeout_s
        self.max_connections = max_connections
        self.tls = tls
        self._ssl = (fleet_client_context(*tls) if tls is not None
                     else None)
        self._idle: dict[str, list[_Conn]] = {}
        self._slots = asyncio.Semaphore(max_connections)

    @property
    def scheme(self) -> str:
        return "https" if self.tls is not None else "http"

    async def close(self) -> None:
        for conns in self._idle.values():
            for c in conns:
                c.close()
        self._idle.clear()

    async def _connect(self, addr: str) -> _Conn:
        host, _, port = addr.rpartition(":")
        _, conn = await asyncio.get_running_loop().create_connection(
            _Conn, host.strip("[]"), int(port), ssl=self._ssl)
        return conn

    async def _fetch(self, addr: str, path: str, headers: dict,
                     dst: memoryview, progress=None) -> tuple[int, dict]:
        """One GET on a pooled connection (opened if none is idle);
        returns (status, headers). A reused connection that dies before
        answering is retried once on a fresh one: the parent may have
        closed it while idle."""
        head = [f"GET {path} HTTP/1.1", f"Host: {addr}"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        raw = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
        idle = self._idle.setdefault(addr, [])
        async with self._slots:
            for _attempt in range(2):
                conn = None
                while idle and conn is None:
                    c = idle.pop()
                    conn = c if not c.closed else None
                if conn is None:
                    conn = await self._connect(addr)
                reused = conn.used
                conn.used = True
                try:
                    # dflint: disable=DF005 — _slots is the connection cap (the reference's connector limit): a slot is one connection in use, so it spans the request; a slow parent holds one slot for at most the per-piece deadline
                    await conn.request(raw, dst, progress)
                except _Stall:
                    conn.release_dst()
                    if reused and not conn._got_bytes:
                        continue
                    raise
                except BaseException:
                    conn.release_dst()
                    conn.close()
                    raise
                conn.release_dst()
                status, got = conn.status, conn.headers
                if conn.keep_alive():
                    idle.append(conn)
                else:
                    conn.close()
                return status, got
        raise _Stall("connection closed")

    async def download_piece(self, *, dst_addr: str, task_id: str,
                             src_peer_id: str, piece: PieceInfo,
                             on_first_byte=None, relay_open=None,
                             qos_class: str = "", meta: dict | None = None,
                             ) -> tuple[bytearray, int]:
        """Fetch one piece from a parent: ``download_span`` of that piece
        (the reference's name for the one-piece fetch)."""
        return await self.download_span(
            dst_addr=dst_addr, task_id=task_id, src_peer_id=src_peer_id,
            pieces=[piece], on_first_byte=on_first_byte,
            relay_open=relay_open, qos_class=qos_class, meta=meta)

    async def download_span(self, *, dst_addr: str, task_id: str,
                            src_peer_id: str, pieces: list[PieceInfo],
                            on_first_byte=None, relay_open=None,
                            qos_class: str = "", meta: dict | None = None,
                            ) -> tuple[bytearray, int]:
        """Fetch contiguous pieces in one ranged GET. Returns (buf,
        cost_ms): one pooled buffer holding the pieces' bytes back to back
        from ``pieces[0].range_start``; the caller releases it to
        ``bufpool.POOL`` after landing (and retires the relay span
        ``relay_open`` opened, before that). ``qos_class`` rides the GET
        as ``?cls=``, so the parent's upload gate admits the transfer
        under the right class; a classless caller adds no parameter."""
        start = pieces[0].range_start
        size = sum(p.range_size for p in pieces)
        path = (f"/download/{task_id[:3]}/{task_id}"
                f"?peerId={quote(src_peer_id, safe='')}")
        if qos_class:
            path += f"&cls={quote(qos_class, safe='')}"
        headers = {"Range": f"bytes={start}-{start + size - 1}"}
        tp = tracing.traceparent()
        if tp:
            # the trace rides the piece request (reference
            # piece_downloader.go:227): the parent's serve joins it
            headers["traceparent"] = tp
        what = (f"parent {dst_addr} piece {pieces[0].piece_num}"
                if len(pieces) == 1
                else f"parent {dst_addr} span @{start}+{size}")
        t0 = time.monotonic()
        buf = POOL.acquire(size)
        span = relay_open(buf) if relay_open is not None else None
        first = [on_first_byte, faultgate.ARMED]

        # dflint: disable=DF007 — progress is reachable only through _Conn._progress, which release_dst() clears on every exit of _fetch; failed() runs only after _fetch has returned or raised (a timeout cancels it first), so neither closure outlives the release
        def progress(off: int) -> None:
            if first[0] is not None or first[1]:
                if first[1]:
                    # 'corrupt' flips the body's first byte before the
                    # landing check (or a relay reader) sees it
                    faultgate.corrupt("piece.wire", buf, key=what)
                if first[0] is not None:
                    first[0]()
                first[0] = None
                first[1] = False
            if span is not None:
                span.advance(off)

        async def fetch() -> tuple[int, dict]:
            if faultgate.ARMED:
                # inside the deadline: a 'hang' parks here until the
                # per-piece deadline cancels it, like a wedged parent
                await faultgate.fire("piece.wire", key=what)
            return await self._fetch(dst_addr, path, headers, mv, progress)

        def failed() -> None:
            if span is not None:
                span.close()        # before the buffer returns to the pool
            POOL.release(buf)

        try:
            mv = memoryview(buf)
            try:
                status, got = await asyncio.wait_for(fetch(), self.timeout_s)
            finally:
                mv.release()
        except asyncio.TimeoutError:
            failed()
            raise _classified(Code.CLIENT_PIECE_DOWNLOAD_FAIL,
                              f"{what}: per-piece deadline "
                              f"({self.timeout_s:.0f}s)", "timeout") from None
        except _Stall as exc:
            failed()
            raise _classified(Code.CLIENT_PIECE_DOWNLOAD_FAIL,
                              f"{what}: {exc}", "stall") from None
        except OSError as exc:
            failed()
            raise _classified(Code.CLIENT_PIECE_DOWNLOAD_FAIL,
                              f"{what}: {type(exc).__name__}: {exc}",
                              "refused") from None
        except BaseException:
            failed()
            raise
        if status == 503:
            failed()
            # upload-slot backpressure: the parent is busy, not broken
            err = DFError(Code.CLIENT_PEER_BUSY, f"parent {dst_addr} busy")
            try:
                err.retry_after_ms = int(
                    got.get("x-retry-after-ms", "0"))
            except ValueError:
                err.retry_after_ms = 0
            raise err
        if status not in (200, 206):
            failed()
            raise _classified(Code.CLIENT_PIECE_DOWNLOAD_FAIL,
                              f"{what}: HTTP {status}", "refused")
        if meta is not None:
            # cut-through serve: the parent relayed these bytes mid-landing
            meta["relayed"] = got.get("x-df-relay") == "1"
        return buf, int((time.monotonic() - t0) * 1000)
