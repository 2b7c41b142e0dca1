"""TLS/plaintext mux: both protocols on one listen port, with a rollout
policy.

Counterpart of ``dragonfly2_tpu/rpc/mux.py`` (reference
``pkg/rpc/mux.go``, cmux splitting TLS from h2c on one listener, and
``pkg/rpc/credential.go``, the default/prefer/force policies). Without it,
turning mTLS on across a fleet is a flag day: every peer's client and
server must flip together or half the mesh goes dark. With it, servers
accept both during the rollout, and ``force`` retires plaintext for new
connections only, so nothing in flight is dropped.

The public port is a small asyncio front listener that reads the first
byte of each connection (0x16 is a TLS record's handshake type; the
port's RPC frames and HTTP/1.1 requests start otherwise) and splices the
bytes to one of two backend listeners of the same server. The backends
are unix sockets in a 0700 directory, not loopback TCP: a loopback port
would let any process on the host skip the mux, and with it the policy
and the TLS client-certificate check. A process of the same user can
still reach the sockets, but it can also read the TLS keys, so no
boundary is weakened.
"""

from __future__ import annotations

import asyncio
import logging
import os
import tempfile

from ..common.metrics import REGISTRY

log = logging.getLogger("df.rpc.mux")

_conns = REGISTRY.counter("df_rpc_mux_conns_total",
                          "mux accepted connections", ("kind",))

POLICIES = ("default", "prefer", "force")
TLS_HANDSHAKE_BYTE = 0x16
FIRST_BYTE_S = 30.0
PUMP_CHUNK = 64 * 1024


class MuxListener:
    """Front listener splicing TLS or plaintext to two backend sockets.

    ``policy`` may change at runtime (the rollout knob):
      default: serve both, no judgement;
      prefer:  serve both; count plaintext and warn once that it is
               deprecated;
      force:   refuse new plaintext connections (existing ones live on).
    """

    def __init__(self, listen_ip: str, port: int, *,
                 plain_sock: str, tls_sock: str,
                 policy: str = "default", sock=None):
        """``sock``: an already-bound listening socket to serve instead of
        binding listen_ip:port here: a port range
        (``listen.bind_port_in_range``) or an AF_VSOCK listener
        (``listen.vsock_listener``)."""
        if policy not in POLICIES:
            raise ValueError(f"unknown mux policy {policy!r}")
        self.listen_ip = listen_ip
        self.port = port
        self.plain_sock = plain_sock
        self.tls_sock = tls_sock
        self.policy = policy
        self._sock = sock
        self._server: asyncio.Server | None = None
        self._conns: set[asyncio.Task] = set()
        self._warned_plain = False

    @staticmethod
    def backend_sockets() -> tuple[str, str]:
        """(plain, tls) unix socket paths in a fresh 0700 directory."""
        d = tempfile.mkdtemp(prefix="dfmux-")
        # dflint: disable=DF001 — one chmod on a fresh tempdir during server start, metadata syscall
        os.chmod(d, 0o700)
        return os.path.join(d, "plain.sock"), os.path.join(d, "tls.sock")

    async def start(self) -> None:
        if self._sock is not None:
            self._server = await asyncio.start_server(
                self._handle, sock=self._sock)
        else:
            self._server = await asyncio.start_server(
                self._handle, self.listen_ip, self.port)
        name = self._server.sockets[0].getsockname()
        self.port = name[1] if isinstance(name, tuple) and len(name) > 1 \
            else self.port
        log.info("mux on %s -> %s / %s (policy=%s)",
                 name, self.plain_sock, self.tls_sock, self.policy)

    async def stop(self) -> None:
        """Stop accepting and drop the spliced connections still open
        (a peer's pooled idle connection would otherwise hold
        ``Server.wait_closed`` for as long as it lives)."""
        if self._server is None:
            return
        self._server.close()
        conns = list(self._conns)
        for t in conns:
            t.cancel()
        await asyncio.gather(*conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    def cleanup_backend_files(self) -> None:
        """Remove the backend unix sockets and their directory, best
        effort: call after the backend servers have shut down, or every
        restart leaks one dfmux-* directory."""
        for path in (self.plain_sock, self.tls_sock):
            try:
                # dflint: disable=DF001 — socket unlink during server stop, metadata syscall
                os.unlink(path)
            except OSError:
                pass
        try:
            # dflint: disable=DF001 — tempdir rmdir during server stop, metadata syscall
            os.rmdir(os.path.dirname(self.plain_sock))
        except OSError:
            pass

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await self._splice(reader, writer)
        finally:
            self._conns.discard(task)
            writer.close()

    async def _splice(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            first = await asyncio.wait_for(reader.read(1),
                                           timeout=FIRST_BYTE_S)
        except (asyncio.TimeoutError, ConnectionError):
            writer.close()
            return
        if not first:
            writer.close()
            return
        is_tls = first[0] == TLS_HANDSHAKE_BYTE
        if not is_tls:
            if self.policy == "force":
                _conns.labels("plain_refused").inc()
                log.warning("refusing plaintext connection (policy=force)")
                writer.close()
                try:
                    await writer.wait_closed()
                except OSError:
                    pass
                return
            if self.policy == "prefer" and not self._warned_plain:
                self._warned_plain = True
                log.warning("plaintext peer connected (policy=prefer): "
                            "schedule its TLS upgrade")
        _conns.labels("tls" if is_tls else "plain").inc()
        backend = self.tls_sock if is_tls else self.plain_sock
        try:
            up_r, up_w = await asyncio.open_unix_connection(backend)
        except OSError:
            writer.close()
            return
        up_w.write(first)

        async def pump(src: asyncio.StreamReader,
                       dst: asyncio.StreamWriter) -> None:
            try:
                while True:
                    data = await src.read(PUMP_CHUNK)
                    if not data:
                        break
                    dst.write(data)
                    await dst.drain()
            except (ConnectionError, OSError):
                pass
            finally:
                try:
                    dst.close()
                except OSError:
                    pass

        try:
            await asyncio.gather(pump(reader, up_w), pump(up_r, writer))
        finally:
            up_w.close()
        for w in (writer, up_w):
            try:
                await w.wait_closed()
            except OSError:
                pass
