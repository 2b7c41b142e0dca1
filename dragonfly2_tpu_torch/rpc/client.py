"""RPC client: typed service clients with retry/backoff, DFError
reconstruction, and stream calls.

Counterpart of ``dragonfly2_tpu/rpc/client.py`` on ``rpc/wire.py``'s frames.
What callers rely on is kept: a refused or reset connection raises
``DFError(UNAVAILABLE)`` and a missed deadline ``DFError(DEADLINE_EXCEEDED)``
(the transient class unary calls retry); a server-side DFError comes back
with its code; cancelling or closing a stream call ends the handler on the
other side. A ``Channel`` keeps idle connections to one address for reuse;
``ChannelPool`` bounds the channels a daemon keeps open. A channel is
plaintext unless given TLS material: ``tls_ca`` trusts that CA (the
manager's issuing CA, typically), ``tls_cert``/``tls_key`` present the
client certificate an mTLS server requires, and the target's host must
match the server certificate's names unless ``tls_server_name`` overrides
it, as grpc's ``ssl_target_name_override`` does for the reference.
Two faultgate sites fire here: ``rpc.unary`` inside each retried unary
attempt and ``rpc.stream.read`` in the stream calls' read halves.
"""

from __future__ import annotations

import asyncio
import logging
import ssl
from typing import Any, AsyncIterator

from ..common import faultgate, tracing
from ..common.errors import Code, DFError
from ..common.retry import Retrier, RetryPolicy
from ..idl.base import dumps, loads
from . import wire

log = logging.getLogger("df.rpc.client")

_RETRYABLE_DF = (Code.UNAVAILABLE, Code.DEADLINE_EXCEEDED)


def _transient_rpc(exc: BaseException) -> bool:
    """Unary retry classifier: transport failures (UNAVAILABLE) and
    missed deadlines."""
    return isinstance(exc, DFError) and exc.code in _RETRYABLE_DF


class RPCError(Exception):
    """A call failed with a status that carries no DF code (unknown
    method, broken framing)."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


def _translate(details: str) -> Exception:
    """Rebuild DFError from the DF:<code>:<msg> status convention."""
    if details.startswith("DF:"):
        try:
            _, code_s, msg = details.split(":", 2)
            return DFError(Code(int(code_s)), msg)
        except (ValueError, KeyError):
            pass
    code, _, msg = details.partition(": ")
    return RPCError(code or "UNKNOWN", msg or details)


class _Conn:
    __slots__ = ("reader", "writer")

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    def usable(self) -> bool:
        return not self.writer.is_closing() and not self.reader.at_eof()

    def close(self) -> None:
        self.writer.close()


class Channel:
    """A channel to one address ("ip:port" or "unix:/path"). Each call
    takes an idle connection or opens one; a connection whose call ended
    cleanly on both sides goes back to the idle list."""

    IDLE_LIMIT = 8

    def __init__(self, address: str, *, tls_ca: str = "",
                 tls_cert: str = "", tls_key: str = "",
                 tls_server_name: str = ""):
        self.address = address
        self.tls_ca = tls_ca
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self.tls_server_name = tls_server_name
        self._ssl: ssl.SSLContext | None = None
        self._idle: list[_Conn] = []
        self._active: set[_Conn] = set()
        self._closed = False

    @property
    def secure(self) -> bool:
        return bool(self.tls_ca or self.tls_cert)

    def _ssl_context(self) -> ssl.SSLContext:
        """The client context, built at the first connection: trust
        ``tls_ca`` (the system's roots without one) and present the
        client certificate when one is given."""
        if self._ssl is None:
            ctx = ssl.create_default_context(cafile=self.tls_ca or None)
            if self.tls_cert:
                ctx.load_cert_chain(self.tls_cert, self.tls_key or None)
            self._ssl = ctx
        return self._ssl

    async def _open(self) -> _Conn:
        if self._closed:
            raise DFError(Code.UNAVAILABLE, f"{self.address}: channel closed")
        while self._idle:
            conn = self._idle.pop()
            if conn.usable():
                self._active.add(conn)
                return conn
            conn.close()
        scheme, host, port = wire.split_address(self.address)
        try:
            if scheme == "unix":
                reader, writer = await asyncio.open_unix_connection(
                    host, limit=1 << 20)
            elif self.secure:
                reader, writer = await asyncio.open_connection(
                    host, port, limit=1 << 20, ssl=self._ssl_context(),
                    server_hostname=self.tls_server_name or host)
            else:
                reader, writer = await asyncio.open_connection(
                    host, port, limit=1 << 20)
        except OSError as exc:
            raise DFError(Code.UNAVAILABLE,
                          f"{self.address}: {exc}") from None
        conn = _Conn(reader, writer)
        self._active.add(conn)
        return conn

    def _release(self, conn: _Conn, reusable: bool) -> None:
        self._active.discard(conn)
        if (reusable and not self._closed and conn.usable()
                and len(self._idle) < self.IDLE_LIMIT):
            self._idle.append(conn)
        else:
            conn.close()

    async def close(self) -> None:
        self._closed = True
        for conn in self._idle + list(self._active):
            conn.close()
        self._idle.clear()
        self._active.clear()


def _trace_metadata():
    """The W3C traceparent as call metadata while a span is current
    (reference ``rpc/client._trace_metadata``): one trace id then covers
    the daemon's task span, the scheduler's ruling and the piece fetches.
    Free with tracing off: no current span, no metadata."""
    tp = tracing.traceparent()
    return (("traceparent", tp),) if tp else None


class _Call:
    """One call on one connection: header, message frames, END, and the
    server's messages up to its STATUS frame. The connection opens on
    first use; ``cancel()`` drops it, which ends the server's handler."""

    def __init__(self, channel: Channel, service: str, method: str,
                 kind: str, timeout: float | None, metadata=None):
        self.channel = channel
        self.header = wire.pack_map({
            "service": service, "method": method, "kind": kind,
            "timeout": float(timeout or 0.0),
            "metadata": dict(metadata or _trace_metadata() or ())})
        self.what = f"{channel.address}/{service}/{method}"
        loop = asyncio.get_running_loop()
        self.deadline = loop.time() + timeout if timeout else None
        self._conn: _Conn | None = None
        self._opening: asyncio.Task | None = None
        self._sent_end = False
        self._finished = False
        self._cancelled = False

    def _remaining(self) -> float | None:
        if self.deadline is None:
            return None
        left = self.deadline - asyncio.get_running_loop().time()
        if left <= 0:
            self._fail_conn()
            raise DFError(Code.DEADLINE_EXCEEDED,
                          f"{self.what}: deadline exceeded")
        return left

    async def _bounded(self, aw):
        """Await ``aw`` within the call's deadline."""
        try:
            return await asyncio.wait_for(aw, self._remaining())
        except asyncio.TimeoutError:
            self._fail_conn()
            raise DFError(Code.DEADLINE_EXCEEDED,
                          f"{self.what}: deadline exceeded") from None

    async def _ensure_open(self) -> _Conn:
        if self._cancelled:
            raise DFError(Code.CLIENT_CONTEXT_CANCELED,
                          f"{self.what}: call cancelled")
        if self._finished:
            raise DFError(Code.UNAVAILABLE, f"{self.what}: call finished")
        if self._conn is None:
            if self._opening is None:
                self._opening = asyncio.get_running_loop().create_task(
                    self._open())
            await self._bounded(asyncio.shield(self._opening))
        return self._conn

    async def _open(self) -> None:
        conn = await self.channel._open()
        if self._cancelled or self._finished:
            # cancelled, or the deadline passed while connecting
            self.channel._release(conn, False)
            raise DFError(Code.CLIENT_CONTEXT_CANCELED,
                          f"{self.what}: call cancelled")
        conn.writer.write(wire.frame(wire.HEADER, self.header))
        self._conn = conn

    async def _send(self, kind: int, payload: bytes = b"", *,
                    end: bool = False) -> None:
        conn = await self._ensure_open()
        data = wire.frame(kind, payload)
        if end:
            data += wire.frame(wire.END, b"")
        try:
            conn.writer.write(data)
            await self._bounded(conn.writer.drain())
        except OSError as exc:
            self._fail_conn()
            raise DFError(Code.UNAVAILABLE, f"{self.what}: {exc}") from None

    async def write(self, msg: Any) -> None:
        await self._send(wire.MESSAGE, dumps(msg))

    async def write_only(self, msg: Any) -> None:
        """The call's one request and its END in a single write: a server
        that answers before an END sent later has arrived closes the
        connection, and the END's write would then fail the call."""
        self._sent_end = True
        await self._send(wire.MESSAGE, dumps(msg), end=True)

    async def done_writing(self) -> None:
        if not self._sent_end:
            self._sent_end = True
            await self._send(wire.END)

    async def read(self) -> Any | None:
        """Next server message; None at a clean end of the call."""
        if self._cancelled:
            raise DFError(Code.CLIENT_CONTEXT_CANCELED,
                          f"{self.what}: call cancelled")
        if self._finished:
            return None
        conn = await self._ensure_open()
        try:
            got = await self._bounded(wire.read_frame(conn.reader))
        except OSError as exc:
            self._fail_conn()
            raise DFError(Code.UNAVAILABLE, f"{self.what}: {exc}") from None
        except DFError:
            self._fail_conn()
            raise
        if got is None:
            self._fail_conn()
            if self._cancelled:
                raise DFError(Code.CLIENT_CONTEXT_CANCELED,
                              f"{self.what}: call cancelled")
            raise DFError(Code.UNAVAILABLE,
                          f"{self.what}: connection closed mid-call")
        kind, payload = got
        if kind == wire.MESSAGE:
            return loads(payload)
        if kind != wire.STATUS:
            self._fail_conn()
            raise RPCError("INTERNAL", f"{self.what}: frame kind {kind}")
        self._finished = True
        status = wire.unpack_map(payload)
        self.channel._release(conn, self._sent_end and status.get("ok"))
        self._conn = None
        if not status.get("ok"):
            raise _translate(str(status.get("details", "")))
        return None

    def _fail_conn(self) -> None:
        self._finished = True
        if self._conn is not None:
            self.channel._release(self._conn, False)
            self._conn = None

    def cancel(self) -> None:
        self._cancelled = True
        if self._opening is not None and not self._opening.done():
            self._opening.cancel()
        self._fail_conn()


class ChannelPool:
    """LRU cache of channels keyed by address. ``limit`` bounds the open
    channels of a long-lived daemon; an evicted channel closes after
    ``evict_grace_s`` so streams opened on it can finish. With fleet mTLS
    every channel verifies peers against ``tls_ca`` and presents the
    daemon's leaf."""

    def __init__(self, limit: int = 128, evict_grace_s: float = 120.0,
                 tls_ca: str = "", tls_cert: str = "", tls_key: str = ""):
        self.limit = limit
        self.evict_grace_s = evict_grace_s
        self.tls_ca = tls_ca
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self._channels: dict[str, Channel] = {}
        self._evicted: list[Channel] = []
        self._closers: set[asyncio.Task] = set()

    def get(self, address: str) -> Channel:
        ch = self._channels.pop(address, None)
        if ch is None:
            ch = Channel(address, tls_ca=self.tls_ca,
                         tls_cert=self.tls_cert, tls_key=self.tls_key)
            while len(self._channels) >= self.limit:
                oldest = next(iter(self._channels))
                self._evict(self._channels.pop(oldest))
        self._channels[address] = ch   # re-insert = most recently used
        return ch

    def _evict(self, ch: Channel) -> None:
        self._evicted.append(ch)

        async def delayed() -> None:
            await asyncio.sleep(self.evict_grace_s)
            try:
                self._evicted.remove(ch)
            except ValueError:
                return            # pool.close() beat us to it
            await ch.close()

        t = asyncio.get_running_loop().create_task(delayed())
        self._closers.add(t)
        t.add_done_callback(self._closers.discard)

    async def close(self) -> None:
        for t in list(self._closers):
            t.cancel()
        for ch in self._channels.values():
            await ch.close()
        self._channels.clear()
        for ch in self._evicted:
            await ch.close()
        self._evicted.clear()


class ServiceClient:
    """Typed calls against one service on one channel."""

    def __init__(self, channel: Channel, service: str, *,
                 max_attempts: int = 3, base_backoff: float = 0.1,
                 max_backoff: float = 2.0):
        self.channel = channel
        self.service = service
        self.retry_policy = RetryPolicy(max_attempts=max_attempts,
                                        base_s=base_backoff,
                                        max_s=max_backoff)

    async def unary(self, method: str, request: Any, *,
                    timeout: float | None = None) -> Any:
        gate_key = f"{self.channel.address}/{self.service}/{method}"

        async def call():
            if faultgate.ARMED:
                # the call's deadline bounds the injected fault too, so a
                # 'hang' script cannot park the call past its timeout
                if timeout:
                    try:
                        await asyncio.wait_for(
                            faultgate.fire("rpc.unary", key=gate_key),
                            timeout)
                    except asyncio.TimeoutError:
                        raise DFError(Code.DEADLINE_EXCEEDED,
                                      f"{gate_key}: deadline during "
                                      "injected fault") from None
                else:
                    await faultgate.fire("rpc.unary", key=gate_key)
            c = _Call(self.channel, self.service, method, wire.UNARY_UNARY,
                      timeout)
            try:
                await c.write_only(request)
                resp = await c.read()
                if resp is None:
                    raise RPCError("INTERNAL", f"{c.what}: no response")
                await c.read()      # the status frame
                return resp
            except BaseException:
                c.cancel()
                raise

        def on_retry(failures, exc, pause):
            log.debug("retrying %s/%s after %s (%.2fs)",
                      self.service, method, exc, pause)

        return await Retrier(self.retry_policy).run(
            call, retryable=_transient_rpc, on_retry=on_retry)

    def unary_stream(self, method: str, request: Any, *,
                     timeout: float | None = None) -> "_StreamIter":
        return _StreamIter(_Call(self.channel, self.service, method,
                                 wire.UNARY_STREAM, timeout), request)

    async def stream_unary(self, method: str, requests: AsyncIterator[Any], *,
                           timeout: float | None = None) -> Any:
        c = _Call(self.channel, self.service, method, wire.STREAM_UNARY,
                  timeout)
        try:
            async for req in requests:
                await c.write(req)
            await c.done_writing()
            resp = await c.read()
            await c.read()
            return resp
        except BaseException:
            c.cancel()
            raise

    def stream_stream(self, method: str, *,
                      timeout: float | None = None) -> "_BidiCall":
        return _BidiCall(_Call(self.channel, self.service, method,
                               wire.STREAM_STREAM, timeout))


async def _fire_stream_read(call: _Call) -> None:
    """The ``rpc.stream.read`` site, on the read halves of stream calls
    only (a unary call reads through ``_Call.read`` and never fires it).
    An injected failure ends the call, as a transport failure would."""
    try:
        await faultgate.fire("rpc.stream.read")
    except DFError:
        call.cancel()
        raise


class _StreamIter:
    """Server-stream iterator; the request goes out on first read."""

    def __init__(self, call: _Call, request: Any):
        self.call = call
        self._request = request
        self._sent = False

    def cancel(self) -> None:
        self.call.cancel()

    def __aiter__(self):
        return self

    async def __anext__(self):
        msg = await self.read()
        if msg is None:
            raise StopAsyncIteration
        return msg

    async def read(self):
        """Like __anext__ but returns None at end of stream."""
        if faultgate.ARMED:
            await _fire_stream_read(self.call)
        if not self._sent:
            self._sent = True
            await self.call.write_only(self._request)
        return await self.call.read()


class _BidiCall:
    """Bidirectional stream with explicit write/read halves."""

    def __init__(self, call: _Call):
        self.call = call

    async def write(self, msg: Any) -> None:
        await self.call.write(msg)

    async def done_writing(self) -> None:
        await self.call.done_writing()

    async def read(self) -> Any | None:
        if faultgate.ARMED:
            await _fire_stream_read(self.call)
        return await self.call.read()

    def cancel(self) -> None:
        self.call.cancel()

    def __aiter__(self):
        return self

    async def __anext__(self):
        msg = await self.read()
        if msg is None:
            raise StopAsyncIteration
        return msg
