"""HTTP(S) proxy and registry mirror: transparent P2P for HTTP(S) fetches.

Counterpart of ``dragonfly2_tpu/daemon/proxy.py`` (reference
``client/daemon/proxy/``): a forward proxy whose regex rules decide P2P or
direct (``transport.go:223 NeedUseDragonfly``; direct rules first, then
the P2P rules, then registry blob digests by default), a registry-mirror
mode rewriting relative paths onto the upstream registry (how containerd
pulls layers through the mesh), CONNECT handling with HTTPS interception
(``proxy.go:268``, with per-host leaf certificates from ``common/certs.py``)
and an SNI listener (``proxy_sni.go:32``) for clients that resolve the
registry's name straight to the daemon.

With ``hijack`` on, a CONNECT to a matching host is answered 200 and the
client socket is upgraded to TLS with a CA-signed leaf for that host; the
decrypted requests then take the same P2P or direct route as plain HTTP,
so TLS registries stop bypassing the mesh. Without it a CONNECT stays a
blind byte tunnel. P2P GETs stream the task's bytes in order
(``PeerTaskManager.stream_task``); a QoS shed is answered 429 with
``Retry-After`` and ``X-Retry-After-Ms``. Everything else relays direct
on the port's own HTTP client (the reference's is an aiohttp session):
redirects are passed back to the client, not followed, and every response
header line is forwarded as received, repeats included. Both framings
close the connection after one response.

The port's differences: the CA lives in the daemon's resolved workdir
(``Daemon.paths``); ``stop`` closes the connections still open, so a
client holding one idle cannot hold the daemon's stop; and a CONNECT host
or SNI name that is not an IP literal or a DNS name gets no leaf (the
CONNECT is answered 400, the handshake refused).
"""

from __future__ import annotations

import asyncio
import logging
import re
import ssl
from urllib.parse import urlsplit

from ..common.certs import CertIssuer, valid_host
from ..common.errors import Code, DFError
from ..common.metrics import REGISTRY
from ..idl.messages import UrlMeta
from ..source.http_client import HTTPSourceClient
from .config import ProxyConfig

log = logging.getLogger("df.http.proxy")

_proxy_reqs = REGISTRY.counter("df_proxy_requests_total",
                               "proxy requests", ("route",))
_proxy_bytes = REGISTRY.counter("df_proxy_bytes_total",
                                "bytes returned to proxy clients", ("route",))

# registry blob digests are content-addressed: the P2P sweet spot
BLOB_RE = re.compile(r"/blobs/sha256:[0-9a-f]{64}$")

DIRECT_TIMEOUT_S = 300.0        # a relayed request's total, as aiohttp's
_HOP_BY_HOP = ("proxy-connection", "connection", "host", "content-length")


class ProxyServer:
    def __init__(self, daemon, cfg: ProxyConfig):
        self.daemon = daemon
        self.cfg = cfg
        self.rules = [re.compile(r) for r in cfg.rules]
        self.direct_rules = [re.compile(r) for r in cfg.direct_rules]
        self.hijack_rules = [re.compile(r) for r in cfg.hijack_hosts]
        self.port = cfg.port
        self.sni_port = cfg.sni_port
        self._server: asyncio.Server | None = None
        self._sni_server: asyncio.Server | None = None
        self._client: HTTPSourceClient | None = None
        self._writers: set[asyncio.StreamWriter] = set()
        self._issuer = None
        if cfg.hijack or cfg.sni_port:
            self._issuer = CertIssuer(
                daemon.paths.workdir, ca_cert_path=cfg.ca_cert,
                ca_key_path=cfg.ca_key)

    @property
    def ca_cert_path(self) -> str:
        """The CA file clients and containerd must trust when hijack is
        on."""
        return self._issuer.ca_cert_path if self._issuer else ""

    # Listen backlog: asyncio's default is 100, and a container runtime's
    # startup burst (hundreds of layer pulls dialing the proxy in one
    # tick) overflows it; the kernel then resets queued connections
    BACKLOG = 1024

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.daemon.cfg.listen_ip, self.port,
            backlog=self.BACKLOG)
        self.port = self._server.sockets[0].getsockname()[1]
        # upstream trust for relayed (non-P2P) fetches is the source
        # client's: a private-CA registry works for manifests and auth
        # too, not just on the blob path; the CA is added to the system's
        # trust, not put in its place
        self._client = HTTPSourceClient()
        self._client.set_tls(insecure=not self.cfg.verify_upstream,
                             ca_file=self.daemon.cfg.download.source_ca)
        if self.sni_port:
            self._sni_server = await asyncio.start_server(
                self._handle_sni_conn, self.daemon.cfg.listen_ip,
                max(self.sni_port, 0), ssl=self._sni_ssl_context(),
                backlog=self.BACKLOG)
            self.sni_port = self._sni_server.sockets[0].getsockname()[1]
            log.info("SNI proxy on :%d", self.sni_port)
        log.info("proxy on :%d (mirror=%s, %d p2p rules, hijack=%s)",
                 self.port, self.cfg.registry_mirror or "-", len(self.rules),
                 self.cfg.hijack)

    async def stop(self) -> None:
        for srv in (self._server, self._sni_server):
            if srv is not None:
                srv.close()
        for writer in list(self._writers):
            writer.close()
        for srv in (self._server, self._sni_server):
            if srv is not None:
                await srv.wait_closed()
        if self._client is not None:
            await self._client.close()

    # ------------------------------------------------------------------

    def use_p2p(self, url: str) -> bool:
        for rule in self.direct_rules:
            if rule.search(url):
                return False
        for rule in self.rules:
            if rule.search(url):
                return True
        # default: registry blobs ride the mesh, everything else is direct
        return bool(BLOB_RE.search(urlsplit(url).path))

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        await self._serve_conn(reader, writer, scheme="http")

    async def _handle_sni_conn(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
        """TLS connections from clients that resolved the registry's name
        to this daemon (reference ``proxy_sni.go``): asyncio completed the
        handshake with an SNI-minted leaf; inner requests are origin-form
        with a Host header and route exactly like hijacked CONNECTs."""
        sslobj = writer.get_extra_info("ssl_object")
        sni = getattr(sslobj, "_df_sni", "") if sslobj else ""
        await self._serve_conn(reader, writer, scheme="https", authority=sni)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter, *, scheme: str,
                          authority: str = "") -> None:
        self._writers.add(writer)
        try:
            await self._serve_http_loop(reader, writer, scheme=scheme,
                                        authority=authority)
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, ssl.SSLError):
            pass
        except Exception:  # noqa: BLE001 - connection boundary
            log.exception("%s proxy connection failed",
                          "sni" if authority else scheme)
        finally:
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (OSError, ssl.SSLError):
                pass

    def _sni_ssl_context(self) -> ssl.SSLContext:
        """Base server context whose SNI callback swaps in a leaf minted
        for whatever name the client asked for (reference
        ``proxy_sni.go``'s GetCertificate)."""
        assert self._issuer is not None
        issuer = self._issuer
        base = issuer.server_context(self.daemon.cfg.host_ip or "localhost")

        def on_sni(sslobj, servername, _ctx):
            # synchronous by the ssl module's contract: a first-seen name
            # mints on the event loop (openssl processes, tens of ms);
            # cached 24 h after. A name that is no host name is refused
            # before anything is minted for it.
            if servername:
                if not valid_host(servername):
                    return ssl.ALERT_DESCRIPTION_UNRECOGNIZED_NAME
                sslobj.context = issuer.server_context(servername)
                sslobj._df_sni = servername   # routing fallback (no Host)
            return None

        base.sni_callback = on_sni
        return base

    def _hijack_match(self, host: str) -> bool:
        if not self.hijack_rules:
            return True                  # hijack on = intercept everything
        return any(r.search(host) for r in self.hijack_rules)

    async def _serve_http_loop(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter, *,
                               scheme: str,
                               authority: str = "") -> None:
        while True:
            request_line = await reader.readline()
            if not request_line:
                return
            try:
                method, target, _version = \
                    request_line.decode("latin1").split(" ", 2)
            except ValueError:
                writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
                return
            headers = await self._read_headers(reader)
            if method.upper() == "CONNECT":
                host = target.partition(":")[0]
                if (self._issuer is not None and self.cfg.hijack
                        and self._hijack_match(host)):
                    if not valid_host(host):
                        # no leaf is minted for a name that is no host
                        writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                                     b"Connection: close\r\n\r\n")
                        await writer.drain()
                        return
                    # pause the transport BEFORE the 200: the client sends
                    # its ClientHello the instant it sees the reply, and
                    # bytes the plaintext reader takes before start_tls
                    # swaps protocols are lost to the handshake
                    writer.transport.pause_reading()
                    writer.write(
                        b"HTTP/1.1 200 Connection Established\r\n\r\n")
                    await writer.drain()
                    # key generation, signing and file IO off the loop
                    # (the first hit per host)
                    ctx = await asyncio.to_thread(
                        self._issuer.server_context, host)
                    # server side, as inferred for start_server streams;
                    # the TLS transport resumes reading itself
                    await writer.start_tls(ctx)
                    _proxy_reqs.labels("hijack").inc()
                    scheme, authority = "https", target
                    continue        # decrypted requests re-enter this loop
                await self._tunnel(target, reader, writer)
                return
            keep_alive = await self._handle_request(
                method.upper(), target, headers, reader, writer,
                scheme=scheme, authority=authority)
            if not keep_alive:
                return

    @staticmethod
    async def _read_headers(reader: asyncio.StreamReader) -> dict[str, str]:
        headers: dict[str, str] = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                return headers
            key, _, value = line.decode("latin1").partition(":")
            headers[key.strip().lower()] = value.strip()

    # ------------------------------------------------------------------

    async def _tunnel(self, target: str, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """CONNECT: blind byte tunnel (TLS passes through unmodified)."""
        host, _, port_s = target.partition(":")
        try:
            up_r, up_w = await asyncio.open_connection(host,
                                                       int(port_s or 443))
        except OSError as exc:
            writer.write(b"HTTP/1.1 502 Bad Gateway\r\n\r\n")
            await writer.drain()
            log.debug("CONNECT %s failed: %s", target, exc)
            return
        _proxy_reqs.labels("tunnel").inc()
        writer.write(b"HTTP/1.1 200 Connection Established\r\n\r\n")
        await writer.drain()

        async def pump(src: asyncio.StreamReader,
                       dst: asyncio.StreamWriter) -> None:
            try:
                while True:
                    data = await src.read(64 * 1024)
                    if not data:
                        break
                    dst.write(data)
                    await dst.drain()
            except OSError:
                pass
            finally:
                try:
                    dst.close()
                except OSError:
                    pass

        await asyncio.gather(pump(reader, up_w), pump(up_r, writer))

    # ------------------------------------------------------------------

    def _resolve_url(self, target: str, headers: dict[str, str], *,
                     scheme: str = "http", authority: str = "") -> str:
        if target.startswith("http://") or target.startswith("https://"):
            return target                       # forward-proxy form
        # hijacked or SNI TLS: origin-form against the intercepted authority
        if scheme == "https":
            host = headers.get("host", "") or authority
            host = host.removesuffix(":443")
            return f"https://{host}{target}"
        # registry-mirror form: relative path against the upstream registry
        if self.cfg.registry_mirror:
            return self.cfg.registry_mirror.rstrip("/") + target
        host = headers.get("host", "")
        return f"http://{host}{target}"

    async def _handle_request(self, method: str, target: str,
                              headers: dict[str, str],
                              reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter, *,
                              scheme: str = "http",
                              authority: str = "") -> bool:
        url = self._resolve_url(target, headers, scheme=scheme,
                                authority=authority)
        if method == "GET" and self.use_p2p(url):
            return await self._serve_p2p(url, headers, writer)
        return await self._serve_direct(method, url, headers, reader, writer)

    async def _serve_p2p(self, url: str, headers: dict[str, str],
                         writer: asyncio.StreamWriter) -> bool:
        _proxy_reqs.labels("p2p").inc()
        fwd = {k: v for k, v in headers.items()
               if k in ("authorization", "accept", "user-agent")}
        # multi-tenant QoS: the tenant and service class ride standard
        # request headers, so any HTTP client (containerd, curl) can tag
        # its traffic
        meta = UrlMeta(header=fwd or None, tag="proxy",
                       tenant=headers.get("x-dragonfly-tenant", ""),
                       qos_class=headers.get("x-dragonfly-class", ""))
        try:
            task_id, chunks = await self.daemon.ptm.stream_task(url, meta)
        except DFError as exc:
            if exc.code == Code.RESOURCE_EXHAUSTED:
                # a QoS shed or a tenant quota: Retry-After carries the
                # governor's hint in whole seconds, rounded up
                _proxy_reqs.labels("shed").inc()
                retry_ms = getattr(exc, "retry_after_ms", 0) or 1000
                writer.write(
                    b"HTTP/1.1 429 Too Many Requests\r\n"
                    b"Retry-After: " + str(-(-retry_ms // 1000)).encode()
                    + b"\r\nX-Retry-After-Ms: " + str(retry_ms).encode()
                    + b"\r\nConnection: close\r\n\r\n")
                await writer.drain()
                return False
            log.warning("p2p stream for %s failed: %s", url, exc.message)
            writer.write(b"HTTP/1.1 502 Bad Gateway\r\n\r\n")
            await writer.drain()
            return False
        except Exception as exc:  # noqa: BLE001 - task set-up failed
            log.warning("p2p stream for %s failed: %s", url, exc)
            writer.write(b"HTTP/1.1 502 Bad Gateway\r\n\r\n")
            await writer.drain()
            return False
        conductor = self.daemon.ptm.conductor(task_id)
        length = conductor.content_length if conductor is not None else -1
        head = "HTTP/1.1 200 OK\r\nContent-Type: application/octet-stream\r\n"
        sent_chunked = length < 0
        if sent_chunked:
            # Connection: close on this framing too: the connection closes
            # after one response either way, and a keep-alive client must
            # not pool it
            head += "Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
        else:
            head += f"Content-Length: {length}\r\nConnection: close\r\n\r\n"
        writer.write(head.encode("latin1"))
        try:
            async for chunk in chunks:
                if sent_chunked:
                    writer.write(f"{len(chunk):x}\r\n".encode())
                    writer.write(chunk)
                    writer.write(b"\r\n")
                else:
                    writer.write(chunk)
                _proxy_bytes.labels("p2p").inc(len(chunk))
                await writer.drain()
            if sent_chunked:
                writer.write(b"0\r\n\r\n")
                await writer.drain()
        except Exception as exc:  # noqa: BLE001 - client or mesh went away
            log.debug("p2p stream aborted for %s: %s", url, exc)
        return False

    async def _serve_direct(self, method: str, url: str,
                            headers: dict[str, str],
                            reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> bool:
        _proxy_reqs.labels("direct").inc()
        body = b""
        length = int(headers.get("content-length", "0") or 0)
        if length:
            body = await reader.readexactly(length)
        fwd = {k: v for k, v in headers.items() if k not in _HOP_BY_HOP}
        assert self._client is not None
        try:
            resp = await self._client.request(
                method, url, fwd, body=body, timeout_s=DIRECT_TIMEOUT_S,
                follow_redirects=False)
            try:
                writer.write(
                    f"HTTP/1.1 {resp.status} {resp.reason}\r\n".encode())
                for k, v in resp.headers.lines:
                    if k.lower() in ("transfer-encoding", "connection"):
                        continue
                    writer.write(f"{k}: {v}\r\n".encode("latin1"))
                has_len = "Content-Length" in resp.headers
                if not has_len:
                    writer.write(b"Transfer-Encoding: chunked\r\n")
                writer.write(b"Connection: close\r\n\r\n")
                async for chunk in resp.chunks(64 * 1024):
                    if not has_len:
                        writer.write(f"{len(chunk):x}\r\n".encode())
                        writer.write(chunk)
                        writer.write(b"\r\n")
                    else:
                        writer.write(chunk)
                    _proxy_bytes.labels("direct").inc(len(chunk))
                    await writer.drain()
                if not has_len:
                    writer.write(b"0\r\n\r\n")
                await writer.drain()
            finally:
                resp.close()        # no-op once the body was read whole
        except Exception as exc:  # noqa: BLE001 - upstream away
            log.debug("direct %s %s failed: %s", method, url, exc)
            try:
                writer.write(b"HTTP/1.1 502 Bad Gateway\r\n\r\n")
                await writer.drain()
            except OSError:
                pass
        return False
