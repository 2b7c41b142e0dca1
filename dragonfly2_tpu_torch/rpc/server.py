"""RPC server: register async handler tables, map DFError to a status.

Counterpart of ``dragonfly2_tpu/rpc/server.py``. A service is a
``ServiceDef`` naming async handlers:

    svc = ServiceDef("df.scheduler.Scheduler")
    svc.unary_unary("RegisterPeerTask", handler)
    svc.stream_stream("ReportPieceResult", handler)

Handlers receive decoded ``idl`` messages (or an async iterator of them)
plus a context; a DFError raised anywhere reaches the caller as
``DF:<code>:<text>`` and is raised again there with the same code. The
transport is ``rpc/wire.py``'s frames over asyncio streams, on TCP or a
unix socket. A caller that closes or cancels its call ends the request
iterator and cancels the handler, as grpc does. Every server also answers
``df.health.Health/Check`` (reference ``pkg/rpc/health``), which ``dfget``
asks before it hands a download to a daemon.

TLS (``TLSOptions``) builds an ``ssl.SSLContext`` where the reference
builds grpc credentials; with a CA and ``require_client_cert`` it is
mutual TLS with manager-issued certificates. ``tls_policy`` other than
``force`` puts both protocols on one TCP port through ``mux.MuxListener``
(the rollout), and an ``"ip:START-END"`` address binds the first free
port of the range (``listen.bind_port_in_range``).
"""

from __future__ import annotations

import asyncio
import logging
import os
import ssl
from typing import AsyncIterator, Awaitable, Callable

from ..common import tracing
from ..common.errors import Code, DFError
from ..idl.base import dumps, loads
from ..idl.messages import Empty
from . import wire
from .listen import bind_port_in_range, parse_port_spec
from .mux import POLICIES, MuxListener

log = logging.getLogger("df.rpc.server")

_END = object()
_GONE = object()


class ServiceDef:
    def __init__(self, name: str):
        self.name = name
        self._methods: dict[str, tuple[str, Callable]] = {}

    def unary_unary(self, method: str, fn: Callable[..., Awaitable]) -> None:
        self._methods[method] = (wire.UNARY_UNARY, fn)

    def unary_stream(self, method: str,
                     fn: Callable[..., AsyncIterator]) -> None:
        self._methods[method] = (wire.UNARY_STREAM, fn)

    def stream_unary(self, method: str, fn: Callable[..., Awaitable]) -> None:
        self._methods[method] = (wire.STREAM_UNARY, fn)

    def stream_stream(self, method: str,
                      fn: Callable[..., AsyncIterator]) -> None:
        self._methods[method] = (wire.STREAM_STREAM, fn)

    def lookup(self, method: str) -> tuple[str, Callable] | None:
        return self._methods.get(method)


class Context:
    """What a handler may ask about its call."""

    def __init__(self, metadata: dict, peer: str):
        self._metadata = metadata
        self._peer = peer
        # the caller ended its request stream cleanly (END), as opposed to
        # going away mid-stream
        self.half_closed = False

    def invocation_metadata(self) -> tuple:
        return tuple(self._metadata.items())

    def peer(self) -> str:
        return self._peer


def span_parent(context):
    """The caller's W3C traceparent from the call's metadata (client half:
    ``client._trace_metadata``), as the ``parent`` of a
    ``tracing.span``; None without one."""
    try:
        metadata = context.invocation_metadata() or ()
    except Exception:  # noqa: BLE001 - stand-in contexts in tests
        return None
    for key, value in metadata:
        if key == "traceparent":
            return tracing.from_traceparent(value)
    return None


def _split_listen(address: str) -> tuple[str, str, int, int]:
    """("unix", path, 0, 0) or ("tcp", host, lo, hi): a single port is a
    range of one."""
    if address.startswith("unix:"):
        return "unix", address[len("unix:"):], 0, 0
    host, _, spec = address.rpartition(":")
    if not host or not spec:
        raise ValueError(f"bad address {address!r}; want ip:port, "
                         "ip:START-END or unix:/path")
    lo, hi = parse_port_spec(spec)
    return "tcp", host.strip("[]"), lo, hi


class _Protocol(Exception):
    """The peer broke the framing; the connection is dropped."""


async def _health_check(request, context) -> Empty:
    return Empty()


class TLSOptions:
    """Server-side TLS (reference ``pkg/rpc/mux.go`` credentials and
    ``security.go`` policies). ``ca_path`` with ``require_client_cert``
    is mutual TLS with manager-issued certificates (``pkg/issuer``); a
    CA alone asks for a client certificate without requiring one, as
    grpc's ``ssl_server_credentials`` does."""

    def __init__(self, cert_path: str, key_path: str, *, ca_path: str = "",
                 require_client_cert: bool = False):
        self.cert_path = cert_path
        self.key_path = key_path
        self.ca_path = ca_path
        self.require_client_cert = require_client_cert

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        if self.ca_path:
            ctx.load_verify_locations(cafile=self.ca_path)
            ctx.verify_mode = ssl.CERT_OPTIONAL
        if self.require_client_cert:
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx


class RPCServer:
    """One server hosting many ServiceDefs on one address: "ip:port",
    "ip:0" (ephemeral; the port is ``.port`` after ``start``),
    "ip:START-END" (the first free port of the range) or "unix:/path".
    ``tls`` secures the listener (``TLSOptions``).

    ``tls_policy`` (only with ``tls``; reference ``pkg/rpc/mux.go`` and
    ``credential.go``):
      "force":   TLS only on the port (the default);
      "default": plaintext and TLS accepted on one port (the rollout);
      "prefer":  both accepted, plaintext flagged as deprecated in the log
                 and the metric. Set ``.mux.policy`` to "force" at runtime
                 to retire plaintext for new connections without a
                 restart.
    """

    def __init__(self, address: str, *, tls: TLSOptions | None = None,
                 tls_policy: str = "force"):
        self.address = address
        self.port: int | None = None
        self.tls = tls
        if tls is not None:
            if tls_policy not in POLICIES:
                # refused before start() makes backend sockets: a typo'd
                # policy must not leave a dfmux-* directory behind
                raise ValueError(f"unknown tls_policy {tls_policy!r}")
        self.tls_policy = tls_policy
        self.mux = None                     # MuxListener when muxing
        self._services: dict[str, ServiceDef] = {}
        self._servers: list[asyncio.base_events.Server] = []
        self._conns: set[asyncio.Task] = set()
        self._busy: set[asyncio.Task] = set()     # connections mid-call
        health = ServiceDef("df.health.Health")
        health.unary_unary("Check", _health_check)
        self.register(health)

    def register(self, service: ServiceDef) -> None:
        self._services[service.name] = service

    async def start(self) -> None:
        scheme, host, lo, hi = _split_listen(self.address)
        ctx = self.tls.server_context() if self.tls is not None else None
        if scheme == "unix":
            # dflint: disable=DF001 — stale-socket cleanup during start(), nothing is served yet
            if os.path.exists(host):
                # dflint: disable=DF001 — see above: startup path
                os.unlink(host)
            self._servers.append(await asyncio.start_unix_server(
                self._on_conn, path=host, limit=1 << 20, ssl=ctx))
        elif ctx is not None and self.tls_policy != "force":
            # both protocols on one public port: the mux front reads each
            # connection's first byte and splices it to the matching
            # unix-socket backend (a 0700 directory: a loopback TCP
            # backend would let processes on the host skip the policy
            # and the client-certificate check; rpc/mux.py)
            plain_sock, tls_sock = MuxListener.backend_sockets()
            self._servers.append(await asyncio.start_unix_server(
                self._on_conn, path=plain_sock, limit=1 << 20))
            self._servers.append(await asyncio.start_unix_server(
                self._on_conn, path=tls_sock, limit=1 << 20, ssl=ctx))
            self.mux = MuxListener(
                host, lo, plain_sock=plain_sock, tls_sock=tls_sock,
                policy=self.tls_policy,
                sock=bind_port_in_range(host, lo, hi) if hi > lo else None)
            await self.mux.start()
            self.port = self.mux.port
        elif hi > lo:
            # a port range: the first free port wins, bound here and
            # served as it is (no window for another process to take it)
            sock = bind_port_in_range(host, lo, hi)
            self._servers.append(await asyncio.start_server(
                self._on_conn, sock=sock, limit=1 << 20, ssl=ctx))
            self.port = sock.getsockname()[1]
        else:
            srv = await asyncio.start_server(self._on_conn, host, lo,
                                             limit=1 << 20, ssl=ctx)
            self._servers.append(srv)
            self.port = srv.sockets[0].getsockname()[1]
        log.info("rpc server on %s (port=%s, tls=%s, policy=%s): %s",
                 self.address, self.port, self.tls is not None,
                 self.tls_policy if self.tls is not None else "-",
                 ",".join(self._services))

    async def stop(self, grace: float = 1.0) -> None:
        if not self._servers:
            return
        if self.mux is not None:
            await self.mux.stop()
        for srv in self._servers:
            srv.close()
        busy = list(self._busy)
        if busy and grace > 0:
            # calls in flight get ``grace`` seconds; idle connections go now
            await asyncio.wait(busy, timeout=grace)
        conns = list(self._conns)
        for t in conns:
            t.cancel()
        await asyncio.gather(*conns, return_exceptions=True)
        for srv in self._servers:
            await srv.wait_closed()
        self._servers = []
        if self.mux is not None:
            self.mux.cleanup_backend_files()

    # ------------------------------------------------------------------

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        peer = writer.get_extra_info("peername")
        peer_s = f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple) else "unix"
        try:
            while True:
                got = await wire.read_frame(reader)
                if got is None:
                    return
                kind, payload = got
                if kind != wire.HEADER:
                    raise _Protocol(f"frame kind {kind} outside a call")
                self._busy.add(task)
                try:
                    if not await self._serve_call(wire.unpack_map(payload),
                                                  reader, writer, peer_s):
                        return
                finally:
                    self._busy.discard(task)
        except (ConnectionError, _Protocol, DFError, ValueError,
                ssl.SSLError) as exc:
            log.debug("rpc connection from %s dropped: %s", peer_s, exc)
        finally:
            self._conns.discard(task)
            writer.close()

    async def _serve_call(self, hdr: dict, reader, writer,
                          peer: str) -> bool:
        """Run one call to its status frame. Returns whether the
        connection may carry another call (both sides ended cleanly)."""
        svc = self._services.get(hdr.get("service", ""))
        entry = svc.lookup(hdr.get("method", "")) if svc else None
        if entry is None or entry[0] != hdr.get("kind"):
            writer.write(wire.frame(wire.STATUS, wire.pack_map({
                "ok": False,
                "details": f"UNIMPLEMENTED: {hdr.get('service')}/"
                           f"{hdr.get('method')} ({hdr.get('kind')})"})))
            await writer.drain()
            return False
        kind, fn = entry
        ctx = Context(dict(hdr.get("metadata") or {}), peer)
        timeout = float(hdr.get("timeout") or 0.0)
        inbox: asyncio.Queue = asyncio.Queue()

        ended = []     # the caller half-closed (END)

        async def read_requests() -> None:
            """Feed the request queue; after END keep watching, so a
            caller that goes away (EOF, reset, a frame after END) is seen
            even while the handler still streams. Returns only then."""
            try:
                while True:
                    got = await wire.read_frame(reader)
                    if got is None or ended:
                        break
                    fkind, payload = got
                    if fkind == wire.MESSAGE:
                        inbox.put_nowait(loads(payload))
                    elif fkind == wire.END:
                        ended.append(True)
                        ctx.half_closed = True
                        inbox.put_nowait(_END)
                    else:
                        break
            except (ConnectionError, DFError, ValueError):
                pass
            inbox.put_nowait(_GONE)

        async def request_iter():
            while True:
                item = await inbox.get()
                if item is _END or item is _GONE:
                    inbox.put_nowait(item)   # later reads end too
                    return
                yield item

        async def first_request():
            async for req in request_iter():
                return req
            raise ConnectionResetError("call ended before its request")

        async def send(msg) -> None:
            writer.write(wire.frame(wire.MESSAGE, dumps(msg)))
            await writer.drain()

        async def stream(responses) -> None:
            try:
                async for resp in responses:
                    await send(resp)
            finally:
                # a handler cancelled inside send() leaves the generator
                # suspended at its yield: close it now, so its cleanup
                # runs with the call and not whenever it is collected
                await responses.aclose()

        async def run() -> None:
            if kind == wire.UNARY_UNARY:
                await send(await fn(await first_request(), ctx))
            elif kind == wire.UNARY_STREAM:
                await stream(fn(await first_request(), ctx))
            elif kind == wire.STREAM_UNARY:
                await send(await fn(request_iter(), ctx))
            else:
                await stream(fn(request_iter(), ctx))

        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout if timeout else None
        feeder = loop.create_task(read_requests())
        handler = loop.create_task(run())
        try:
            remaining = timeout or None
            while not handler.done():
                await asyncio.wait({handler, feeder}, timeout=remaining,
                                   return_when=asyncio.FIRST_COMPLETED)
                if feeder.done() and not handler.done():
                    # the caller closed or cancelled: end the handler now
                    handler.cancel()
                    await asyncio.gather(handler, return_exceptions=True)
                    return False
                if deadline is not None:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
            # stop reading before the status goes out: the next frame on
            # this connection belongs to the caller's next call
            feeder_gone = feeder.done()
            feeder.cancel()
            await asyncio.gather(feeder, return_exceptions=True)
            if not handler.done():
                handler.cancel()
                await asyncio.gather(handler, return_exceptions=True)
                status = {"ok": False, "details": wire.status_details(
                    DFError(Code.DEADLINE_EXCEEDED, "deadline exceeded"))}
            else:
                exc = handler.exception()
                if exc is None:
                    status = {"ok": True, "details": ""}
                elif feeder_gone:
                    return False
                else:
                    if not isinstance(exc, (DFError, ConnectionError)):
                        log.error("handler %s/%s failed",
                                  hdr.get("service"), hdr.get("method"),
                                  exc_info=exc)
                    status = {"ok": False,
                              "details": wire.status_details(exc)}
            writer.write(wire.frame(wire.STATUS, wire.pack_map(status)))
            await writer.drain()
            # reusable only when the caller half-closed too
            return bool(ended) and not feeder_gone
        finally:
            for t in (handler, feeder):
                if not t.done():
                    t.cancel()
            await asyncio.gather(handler, feeder, return_exceptions=True)
