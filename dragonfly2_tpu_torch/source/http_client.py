"""http(s):// origin client on the standard library.

Counterpart of ``dragonfly2_tpu/source/http_client.py``, which rides
aiohttp; the card's machine has no aiohttp, so this module speaks
HTTP/1.1 itself over ``asyncio`` streams (``ssl`` for https). The rules
are the reference's: metadata from a HEAD sent with ``Connection: close``
(so a probe's connection never enters the pool), falling back to a
``bytes=0-0`` ranged GET when the origin rejects HEAD, whose
``Content-Range`` total is the length; ``Accept-Ranges: bytes`` for range
support; redirects followed (``request`` may leave them to its caller);
404 is ``SOURCE_NOT_FOUND``, 401/403
``SOURCE_AUTH_ERROR``, and a 429/503 carries its ``Retry-After`` as
``retry_after_ms``; an unknown length streams to the end (chunked
transfer encoding or close-delimited); bodies arrive in chunks of at most
1 MiB. Keep-alive connections are pooled per event loop, as the
reference pools its sessions: the client is a process singleton that may
serve several ``asyncio.run`` lifetimes. ``request`` sends any method with
a body given whole or streamed from an async iterator (the object
gateway's backend and ``dfstore`` write through it, where the reference
uses aiohttp's session; so does the proxy's direct route, which needs a
response as received: its reason phrase and every header line in order,
repeats included, in ``Headers.lines``). ``request`` also takes what the
stress tool's aiohttp session gives the reference: a forward ``proxy``
(an ``http://`` URL goes to it as an absolute-form target with ``Host``
naming the origin; an ``https://`` URL opens a ``CONNECT`` tunnel through
it, then TLS to the origin on that stream) and per-request ``connect_s``
and ``read_s`` bounds (aiohttp's ``sock_connect`` and ``sock_read``). As
with aiohttp, the default ``User-Agent`` and ``Accept`` go out only when
the caller gives none.
``list`` is the reference's one-entry listing of the URL itself. The
``gs``, ``oras`` and ``hdfs`` clients speak their protocols through this
client. ``json_body`` parses a JSON answer as aiohttp's ``resp.json()``
does by default, refusing one whose ``Content-Type`` is not JSON.
"""

from __future__ import annotations

import asyncio
import codecs
import json
import re
import ssl
import time
from typing import AsyncIterator
from urllib.parse import urljoin, urlsplit

from ..common.errors import Code, DFError
from .client import ListEntry, SourceRequest, SourceResponse, register_client

_CHUNK = 1 << 20
_READ_LIMIT = 2 << 20        # stream buffer; bounds one head line too
_HEAD_LIMIT = 64 << 10
_MAX_REDIRECTS = 10
_REDIRECTS = frozenset({301, 302, 303, 307, 308})
_CONNECT_S = 30.0            # aiohttp's sock_connect in the reference
_READ_S = 120.0              # and its sock_read


# aiohttp's ``json_re``: a JSON type or a ``+json`` suffix, matched at the
# start of the raw header, parameters and all
_JSON_TYPE = re.compile(r"^application/(?:[\w.+-]+?\+)?json")


class ContentTypeError(ValueError):
    """A JSON body under a ``Content-Type`` that is not JSON: the
    reference's aiohttp ``ContentTypeError``, with its text."""


def json_body(status: int, headers, body: bytes, url: str):
    """``body`` parsed as aiohttp's ``resp.json()`` parses it by default:
    the lower-cased ``Content-Type`` (missing: empty) must match
    ``_JSON_TYPE``, else ``ContentTypeError``; a blank body is None; the
    text is decoded by its ``charset`` (UTF-8 when none is given or known)
    and a body that is no JSON raises ``json.JSONDecodeError``."""
    ctype = (headers.get("Content-Type") or "").lower()
    if _JSON_TYPE.match(ctype) is None:
        raise ContentTypeError(
            f"{status}, message='Attempt to decode JSON with unexpected "
            f"mimetype: {ctype}', url={url!r}")
    stripped = body.strip()
    if not stripped:
        return None
    encoding = "utf-8"
    for param in ctype.split(";")[1:]:
        key, _, value = param.strip().partition("=")
        if key.strip() == "charset" and value.strip():
            try:
                encoding = codecs.lookup(value.strip().strip('"')).name
            except LookupError:
                pass
    return json.loads(stripped.decode(encoding))


class _ProtocolError(Exception):
    """The origin's response could not be parsed or ended early."""


class Headers(dict):
    """Response headers under the origin's own names, looked up without
    regard to case (HTTP header names are case-insensitive). A repeated
    name looks up as its last value; ``lines`` holds every line as
    received, in order, repeats included (what a proxy forwards)."""

    def __init__(self, pairs=()):
        super().__init__()
        self._names: dict[str, str] = {}
        self.lines: list[tuple[str, str]] = []
        for k, v in pairs:
            self.add(k, v)

    def add(self, key: str, value: str) -> None:
        """One more line: a repeated name keeps its earlier lines."""
        self._set(key, value)
        self.lines.append((key, value))

    def _set(self, key: str, value: str) -> None:
        old = self._names.get(key.lower())
        if old is not None and old != key:
            super().__delitem__(old)
        self._names[key.lower()] = key
        super().__setitem__(key, value)

    def __setitem__(self, key: str, value: str) -> None:
        """Replaces every line of the name."""
        self._set(key, value)
        self.lines = [kv for kv in self.lines
                      if kv[0].lower() != key.lower()] + [(key, value)]

    def __getitem__(self, key: str) -> str:
        return super().__getitem__(self._names.get(key.lower(), key))

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and key.lower() in self._names

    def get(self, key: str, default=None):
        name = self._names.get(key.lower())
        return default if name is None else super().get(name, default)


def _status_error(status: int, url: str, headers=None) -> DFError:
    if status == 404:
        return DFError(Code.SOURCE_NOT_FOUND, f"origin 404: {url}")
    if status in (401, 403):
        return DFError(Code.SOURCE_AUTH_ERROR, f"origin {status}: {url}")
    err = DFError(Code.SOURCE_ERROR, f"origin status {status}: {url}")
    if headers is not None and status in (429, 503):
        # the origin's own pacing hint: the back-source retry waits what
        # the origin asked for instead of its default backoff
        value = str(headers.get("Retry-After", "")).strip()
        if value.isdigit():
            err.retry_after_ms = int(value) * 1000
    return err


class _Deadline:
    """A request's timeouts: ``total_s`` over everything when the request
    sets one, else ``connect_s`` per connect and ``read_s`` per read (the
    reference's aiohttp ``sock_connect`` and ``sock_read``)."""

    def __init__(self, total_s: float, connect_s: float = _CONNECT_S,
                 read_s: float = _READ_S):
        self.at = time.monotonic() + total_s if total_s > 0 else 0.0
        self.connect_s = connect_s
        self.read_s = read_s

    def budget(self, step_s: float) -> float:
        if not self.at:
            return step_s
        left = self.at - time.monotonic()
        if left <= 0:
            raise asyncio.TimeoutError()
        return left

    def connect(self) -> float:
        return self.budget(self.connect_s)

    def read(self) -> float:
        return self.budget(self.read_s)


class _Conn:
    __slots__ = ("reader", "writer")

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    def close(self) -> None:
        self.writer.close()


class _Response:
    """One response whose head has been read; the body streams from
    ``chunks`` and the connection returns to the pool once the body is
    read to its end (``pool`` None: closed instead)."""

    def __init__(self, conn: _Conn, method: str, status: int,
                 headers: Headers, version: str, pool: list | None,
                 deadline: _Deadline, reason: str = ""):
        self.conn = conn
        self.status = status
        self.reason = reason
        self.headers = headers
        self.deadline = deadline
        self._pool = pool
        te = headers.get("Transfer-Encoding", "").lower()
        self.chunked = "chunked" in te
        self.length = -1
        if not self.chunked:
            try:
                self.length = int(headers.get("Content-Length", "-1"))
            except ValueError:
                self.length = -1
        self.empty = (method == "HEAD" or status in (204, 304)
                      or 100 <= status < 200)
        conn_hdr = headers.get("Connection", "").lower()
        self.keep = (("close" not in conn_hdr) if version == "HTTP/1.1"
                     else ("keep-alive" in conn_hdr))
        if not self.empty and not self.chunked and self.length < 0:
            self.keep = False             # close-delimited body
        self.closed = False

    def close(self) -> None:
        """Drop the connection (a body left unread cannot be reused)."""
        if not self.closed:
            self.closed = True
            self.conn.close()

    def _release(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.keep and self._pool is not None:
            self._pool.append(self.conn)
        else:
            self.conn.close()

    async def _read(self, n: int) -> bytes:
        return await asyncio.wait_for(self.conn.reader.read(n),
                                      self.deadline.read())

    async def _readexactly(self, n: int) -> bytes:
        return await asyncio.wait_for(self.conn.reader.readexactly(n),
                                      self.deadline.read())

    async def _readline(self) -> bytes:
        line = await asyncio.wait_for(self.conn.reader.readline(),
                                      self.deadline.read())
        if not line.endswith(b"\n"):
            raise _ProtocolError("body ended inside a chunk header")
        return line

    async def chunks(self, size: int = _CHUNK) -> AsyncIterator[bytes]:
        """The body in chunks of at most ``size`` bytes."""
        try:
            if self.empty:
                pass
            elif self.chunked:
                while True:
                    line = await self._readline()
                    try:
                        left = int(line.split(b";", 1)[0].strip(), 16)
                    except ValueError:
                        raise _ProtocolError(
                            f"bad chunk size {line[:40]!r}") from None
                    if left == 0:
                        while (await self._readline()).strip():
                            pass                  # trailer fields
                        break
                    while left > 0:
                        data = await self._read(min(size, left))
                        if not data:
                            raise _ProtocolError("body ended inside a chunk")
                        left -= len(data)
                        yield data
                    if (await self._readexactly(2)) != b"\r\n":
                        raise _ProtocolError("chunk not followed by CRLF")
            elif self.length >= 0:
                left = self.length
                while left > 0:
                    data = await self._read(min(size, left))
                    if not data:
                        raise _ProtocolError(
                            f"body ended {left} bytes short of "
                            f"{self.length}")
                    left -= len(data)
                    yield data
            else:
                while True:
                    data = await self._read(size)
                    if not data:
                        break
                    yield data
        except asyncio.IncompleteReadError:
            self.close()
            raise _ProtocolError("body ended early") from None
        except BaseException:
            self.close()
            raise
        self._release()

    async def read(self) -> bytes:
        """The whole body."""
        try:
            return b"".join([c async for c in self.chunks()])
        except (OSError, asyncio.TimeoutError, _ProtocolError) as exc:
            raise DFError(Code.SOURCE_ERROR,
                          f"body read failed: {exc!r}") from None

    async def discard(self) -> None:
        """Read and drop a small body (a redirect's or an error's), so the
        connection can be reused; a large one closes it."""
        if self.empty or 0 <= self.length <= _HEAD_LIMIT or self.chunked:
            try:
                async for _ in self.chunks():
                    pass
                return
            except (_ProtocolError, OSError, asyncio.TimeoutError):
                pass
        self.close()


def _authority(host: str, port: int, default: int) -> str:
    """``host[:port]`` as a Host header or a CONNECT target writes it
    (an IPv6 literal bracketed, the scheme's default port left out)."""
    out = host if ":" not in host else f"[{host}]"
    return out if port == default else f"{out}:{port}"


def fleet_client_context(cert: str, key: str, ca: str) -> ssl.SSLContext:
    """The client context of the peer HTTP planes under fleet mTLS (piece
    GETs and PEX gossip): trust the fleet CA ``ca`` alone, present
    ``cert``/``key`` as the client certificate, and check no host name
    (peers are dialed by IP; the CA's signature authenticates), as the
    reference's sessions do."""
    ctx = ssl.create_default_context(cafile=ca)
    ctx.load_cert_chain(cert, key)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


class HTTPSourceClient:
    def __init__(self) -> None:
        # id(loop) -> (loop, {(scheme, host, port): [idle _Conn]})
        self._pools: dict[int, tuple] = {}
        self._ssl: ssl.SSLContext | None = None   # None: system trust

    def set_tls(self, *, insecure: bool = False, ca_file: str = "") -> None:
        """TLS trust for https origins: ``ca_file`` is added ON TOP of the
        system's trust (a private registry's CA while public origins keep
        working); ``insecure`` turns verification off (tests only)."""
        if insecure:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            self._ssl = ctx
        elif ca_file:
            ctx = ssl.create_default_context()
            ctx.load_verify_locations(cafile=ca_file)
            self._ssl = ctx
        else:
            self._ssl = None

    def set_client_cert(self, cert: str, key: str, ca: str) -> None:
        """Fleet mTLS toward peers (PEX gossip): ``fleet_client_context``
        in place of the system's trust, for this client only."""
        self._ssl = fleet_client_context(cert, key, ca)

    def _pool(self) -> dict:
        loop = asyncio.get_running_loop()
        entry = self._pools.get(id(loop))
        if entry is None or entry[0] is not loop:
            # connections of a finished loop are unusable: forget them
            self._pools = {k: v for k, v in self._pools.items()
                           if not v[0].is_closed()}
            entry = self._pools[id(loop)] = (loop, {})
        return entry[1]

    async def close(self) -> None:
        """Close the running loop's idle connections."""
        entry = self._pools.pop(id(asyncio.get_running_loop()), None)
        if entry is not None:
            for conns in entry[1].values():
                for c in conns:
                    c.close()

    async def _connect(self, key: tuple, deadline: _Deadline) -> _Conn:
        """A connection for a pool key: ``(scheme, host, port)`` straight
        to the origin, ``("proxy", host, port)`` to a forward proxy, or
        ``("https", host, port, proxy_host, proxy_port)``: a ``CONNECT``
        tunnel through the proxy with TLS to the origin on top."""
        scheme, host, port = key[:3]
        ctx = None
        if scheme == "https":
            ctx = self._ssl or ssl.create_default_context()
        if len(key) == 3:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port, ssl=ctx,
                                        server_hostname=host if ctx else None,
                                        limit=_READ_LIMIT),
                deadline.connect())
            return _Conn(reader, writer)
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(key[3], key[4], limit=_READ_LIMIT),
            deadline.connect())
        try:
            authority = _authority(host, port, 0)
            writer.write(f"CONNECT {authority} HTTP/1.1\r\n"
                         f"Host: {authority}\r\n\r\n".encode("latin-1"))
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                          deadline.read())
            line = head.split(b"\r\n", 1)[0]
            status = line.split(b" ", 2)
            if len(status) < 2 or not status[1].startswith(b"2"):
                raise _ProtocolError(f"proxy refused CONNECT {authority}: "
                                     f"{line[:60]!r}")
            await asyncio.wait_for(
                writer.start_tls(ctx, server_hostname=host),
                deadline.connect())
        except BaseException:
            writer.close()
            raise
        return _Conn(reader, writer)

    async def _roundtrip(self, method: str, url: str, headers: dict,
                         deadline: _Deadline, pooled: bool,
                         body=b"", content_length: int = -1,
                         proxy: str = "") -> _Response:
        parts = urlsplit(url)
        scheme = parts.scheme.lower()
        if scheme not in ("http", "https") or not parts.hostname:
            raise DFError(Code.SOURCE_ERROR, f"not an http(s) URL: {url}")
        default = 443 if scheme == "https" else 80
        port = parts.port or default
        host = parts.hostname
        key = (scheme, host, port)
        target = (parts.path or "/") + (f"?{parts.query}"
                                         if parts.query else "")
        host_hdr = _authority(host, port, default)
        if proxy:
            # a forward proxy, as aiohttp's ``proxy=`` speaks to one: plain
            # HTTP goes to it as an absolute-form target (pooled per
            # proxy); https tunnels through it (pooled per proxy and
            # origin)
            pparts = urlsplit(proxy)
            if pparts.scheme.lower() != "http" or not pparts.hostname:
                raise DFError(Code.SOURCE_ERROR,
                              f"not an http:// proxy: {proxy}")
            paddr = (pparts.hostname, pparts.port or 80)
            if scheme == "http":
                key = ("proxy", *paddr)
                target = f"http://{host_hdr}{target}"
            else:
                key = (scheme, host, port, *paddr)
        # a caller's own Host or Content-Length (a signed request carries
        # both) is sent once, as given
        given = {k.lower() for k in headers}
        lines = [f"{method} {target} HTTP/1.1"]
        if "host" not in given:
            lines.append(f"Host: {host_hdr}")
        if "user-agent" not in given:
            lines.append("User-Agent: dragonfly2-tpu-torch")
        if "accept" not in given:
            lines.append("Accept: */*")
        lines += [f"{k}: {v}" for k, v in headers.items()]
        # a streamed body is an async iterator of chunks: sent as it is
        # read, with its Content-Length when known, else chunked
        stream = not isinstance(body, (bytes, bytearray, memoryview))
        if stream:
            if "content-length" not in given:
                lines.append(f"Content-Length: {content_length}"
                             if content_length >= 0
                             else "Transfer-Encoding: chunked")
        elif (body or method in ("POST", "PUT")) \
                and "content-length" not in given:
            lines.append(f"Content-Length: {len(body)}")
        raw = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        if not stream:
            raw += body
        pool = self._pool().setdefault(key, []) if pooled else None
        chunked = stream and content_length < 0 \
            and "content-length" not in given
        for attempt in range(2):
            conn = None
            # a streamed body cannot be sent twice: a fresh connection
            while pool and conn is None and not stream:
                c = pool.pop()
                if not c.writer.is_closing() and not c.reader.at_eof():
                    conn = c
                else:
                    c.close()
            reused = conn is not None
            if conn is None:
                conn = await self._connect(key, deadline)
            try:
                conn.writer.write(raw)
                await asyncio.wait_for(conn.writer.drain(),
                                       deadline.read())
                if stream:
                    async for chunk in body:
                        if not chunk:
                            continue
                        if chunked:
                            conn.writer.write(f"{len(chunk):x}\r\n"
                                              .encode())
                        conn.writer.write(chunk)
                        if chunked:
                            conn.writer.write(b"\r\n")
                        await asyncio.wait_for(conn.writer.drain(),
                                               deadline.read())
                    if chunked:
                        conn.writer.write(b"0\r\n\r\n")
                        await asyncio.wait_for(conn.writer.drain(),
                                               deadline.read())
                head = await asyncio.wait_for(
                    conn.reader.readuntil(b"\r\n\r\n"),
                    deadline.read())
            except (OSError, asyncio.IncompleteReadError) as exc:
                conn.close()
                if reused and attempt == 0:
                    continue       # the origin closed an idle connection
                if isinstance(exc, asyncio.IncompleteReadError):
                    raise _ProtocolError("connection closed before the "
                                         "response head") from None
                raise
            except asyncio.LimitOverrunError:
                conn.close()
                raise _ProtocolError("response head too large") from None
            except BaseException:
                conn.close()
                raise
            return self._parse(conn, method, head, pool, deadline)
        raise _ProtocolError("connection closed")      # pragma: no cover

    @staticmethod
    def _parse(conn: _Conn, method: str, head: bytes, pool,
               deadline: _Deadline) -> _Response:
        text = head[:-4].decode("latin-1").split("\r\n")
        version, _, rest = text[0].partition(" ")
        if not version.startswith("HTTP/1."):
            conn.close()
            raise _ProtocolError(f"bad status line {text[0][:60]!r}")
        code, _, reason = rest.partition(" ")
        try:
            status = int(code)
        except ValueError:
            conn.close()
            raise _ProtocolError(f"bad status line {text[0][:60]!r}") \
                from None
        headers = Headers()
        for line in text[1:]:
            k, sep, v = line.partition(":")
            if sep:
                headers.add(k.strip(), v.strip())
        return _Response(conn, method, status, headers, version, pool,
                         deadline, reason=reason.strip())

    async def _request(self, method: str, url: str, headers: dict,
                       timeout_s: float, *, pooled: bool = True,
                       body=b"", content_length: int = -1,
                       follow_redirects: bool = True, proxy: str = "",
                       connect_s: float = _CONNECT_S,
                       read_s: float = _READ_S) -> _Response:
        """One request, following redirects (a 303 turns into a GET and
        drops the body) unless ``follow_redirects`` is false. A streamed
        body is sent once: its response is returned as it is, redirect or
        not."""
        deadline = _Deadline(timeout_s, connect_s, read_s)
        for _hop in range(_MAX_REDIRECTS + 1):
            resp = await self._roundtrip(method, url, headers, deadline,
                                         pooled, body, content_length,
                                         proxy)
            location = resp.headers.get("Location")
            if (not follow_redirects or resp.status not in _REDIRECTS
                    or not location
                    or not isinstance(body, (bytes, bytearray,
                                             memoryview))):
                return resp
            await resp.discard()
            url = urljoin(url, location)
            if resp.status == 303 and method != "HEAD":
                method, body = "GET", b""
        raise DFError(Code.SOURCE_ERROR, f"too many redirects: {url}")

    async def request(self, method: str, url: str,
                      headers: dict | None = None, *, body=b"",
                      content_length: int = -1, timeout_s: float = 0.0,
                      pooled: bool = True,
                      follow_redirects: bool = True, proxy: str = "",
                      connect_s: float = _CONNECT_S,
                      read_s: float = _READ_S) -> _Response:
        """Any method, for the clients that write as well as read (the
        object-storage backend, dfstore, the proxy's direct route, the
        stress tool): ``body`` is bytes or an async iterator of chunks
        (streamed; ``content_length`` when known). The response's body is
        read with ``chunks()`` or ``read()``; a transport failure is
        ``SOURCE_ERROR``. With ``follow_redirects`` false a 3xx is the
        response. ``proxy`` (``http://host:port``) sends the request
        through a forward proxy; without ``timeout_s``, ``connect_s``
        bounds each connect and ``read_s`` each read, so a body that
        stalls raises."""
        try:
            return await self._request(method, url, dict(headers or {}),
                                       timeout_s, pooled=pooled, body=body,
                                       content_length=content_length,
                                       follow_redirects=follow_redirects,
                                       proxy=proxy, connect_s=connect_s,
                                       read_s=read_s)
        except (OSError, asyncio.TimeoutError, _ProtocolError) as exc:
            raise DFError(Code.SOURCE_ERROR,
                          f"{method} {url} failed: {exc!r}") from None

    async def _head(self, req: SourceRequest) -> tuple[int, Headers]:
        # Probes carry ``Connection: close`` and stay out of the pool: an
        # origin that writes a body for HEAD would otherwise leave it in a
        # pooled connection, and the next GET reusing it would hang
        probe_headers = {**req.header, "Connection": "close"}
        try:
            resp = await self._request("HEAD", req.url, probe_headers,
                                       req.timeout_s, pooled=False)
            resp.close()
            if resp.status < 400:
                return resp.status, resp.headers
        except (OSError, asyncio.TimeoutError, _ProtocolError):
            pass
        # some origins reject HEAD: a 1-byte ranged GET as the probe
        probe = {**probe_headers, "Range": "bytes=0-0"}
        try:
            resp = await self._request("GET", req.url, probe, req.timeout_s,
                                       pooled=False)
        except (OSError, asyncio.TimeoutError, _ProtocolError) as exc:
            raise DFError(Code.SOURCE_ERROR,
                          f"origin probe failed: {exc!r}") from None
        resp.close()
        if resp.status >= 400:
            raise _status_error(resp.status, req.url, headers=resp.headers)
        headers = resp.headers
        cr = headers.get("Content-Range", "")
        if "/" in cr:
            headers["Content-Length"] = cr.rsplit("/", 1)[1]
            headers["Accept-Ranges"] = "bytes"
        return resp.status, headers

    async def content_length(self, req: SourceRequest) -> int:
        _, headers = await self._head(req)
        try:
            total = int(headers.get("Content-Length", "-1"))
        except ValueError:
            return -1
        if req.range is not None and total >= 0:
            return min(req.range.length, max(0, total - req.range.start))
        return total

    async def supports_range(self, req: SourceRequest) -> bool:
        _, headers = await self._head(req)
        return headers.get("Accept-Ranges", "").lower() == "bytes"

    async def last_modified(self, req: SourceRequest) -> str:
        _, headers = await self._head(req)
        return headers.get("Last-Modified", "")

    async def download(self, req: SourceRequest) -> SourceResponse:
        headers = dict(req.header)
        if req.range is not None:
            headers["Range"] = req.range.http_header()
        try:
            resp = await self._request("GET", req.url, headers,
                                       req.timeout_s)
        except (OSError, asyncio.TimeoutError, _ProtocolError) as exc:
            raise DFError(Code.SOURCE_ERROR,
                          f"origin get failed: {exc!r}") from None
        if resp.status >= 400:
            await resp.discard()
            raise _status_error(resp.status, req.url, headers=resp.headers)
        if req.range is not None and resp.status != 206:
            resp.close()
            raise DFError(Code.SOURCE_RANGE_UNSUPPORTED,
                          f"origin ignored range request: status "
                          f"{resp.status}")
        length = resp.length
        total = length
        cr = resp.headers.get("Content-Range", "")
        if "/" in cr:
            tail = cr.rsplit("/", 1)[1]
            if tail.isdigit():
                total = int(tail)

        async def chunks() -> AsyncIterator[bytes]:
            try:
                async for data in resp.chunks():
                    yield data
            except (OSError, asyncio.TimeoutError, _ProtocolError) as exc:
                raise DFError(Code.SOURCE_ERROR,
                              f"origin body failed: {exc!r}") from None
            finally:
                resp.close()       # a body abandoned midway (no-op at EOF)

        return SourceResponse(
            status=resp.status, content_length=length, total_length=total,
            supports_range=resp.status == 206
            or resp.headers.get("Accept-Ranges", "").lower() == "bytes",
            last_modified=resp.headers.get("Last-Modified", ""),
            header=resp.headers, chunks=chunks())

    async def list(self, req: SourceRequest) -> list[ListEntry]:
        """Plain HTTP has no directory protocol: one entry, the URL."""
        return [ListEntry(url=req.url, name=req.url.rsplit("/", 1)[-1],
                          is_dir=False,
                          content_length=await self.content_length(req))]


register_client(["http", "https"], HTTPSourceClient())
