"""HTTP/1.1 on asyncio streams: the request parser, the router and a
routes-only server.

The reference serves its HTTP surfaces with ``aiohttp.web``; the card's
machine has no aiohttp. The daemon's upload server (piece serving plus
routed surfaces) and the launchers' debug server (``debug_http.py``)
share this module: one parser, one router, one connection loop.

A routed handler is a coroutine. A ``GET`` or ``DELETE`` handler takes
(params, query), a ``POST`` handler (params, query, body); each returns
(status, body): a dict is sent as JSON, bytes as
``application/octet-stream``, a str as plain text. A request body is read
whole before the handler runs, up to 1 MiB (aiohttp's default
``client_max_size``); a larger one is answered 413 and the connection
closed.
"""

from __future__ import annotations

import asyncio
import json
import logging
from urllib.parse import parse_qs, urlsplit

log = logging.getLogger("df.http")

REASONS = {200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
           206: "Partial Content", 400: "Bad Request",
           404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
           413: "Request Entity Too Large",
           416: "Range Not Satisfiable", 429: "Too Many Requests",
           431: "Request Header Fields Too Large", 501: "Not Implemented",
           502: "Bad Gateway", 503: "Service Unavailable"}
HEAD_LIMIT = 64 << 10
BODY_LIMIT = 1 << 20        # aiohttp's default client_max_size


class HTTPError(Exception):
    def __init__(self, status: int, text: str, headers: dict | None = None):
        super().__init__(text)
        self.status = status
        self.text = text
        self.headers = headers or {}


def head(status: int, headers: dict) -> bytes:
    lines = [f"HTTP/1.1 {status} {REASONS.get(status, 'Status')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Router:
    """Exact paths, or a path whose last segment is a ``{name}``
    parameter, per method."""

    def __init__(self) -> None:
        self._routes: list[tuple[str, list[str], object]] = []

    def add_get(self, path: str, handler) -> None:
        self._routes.append(("GET", path.split("/"), handler))

    def add_post(self, path: str, handler) -> None:
        self._routes.append(("POST", path.split("/"), handler))

    def add_delete(self, path: str, handler) -> None:
        self._routes.append(("DELETE", path.split("/"), handler))

    def match(self, method: str, path: str):
        """(handler, params) for the route; None when no route has the
        path; raises 405 when routes have the path but not the method."""
        parts = path.split("/")
        path_known = False
        for route_method, pattern, handler in self._routes:
            if len(pattern) != len(parts):
                continue
            params = {}
            for want, got in zip(pattern, parts):
                if want.startswith("{") and want.endswith("}"):
                    if not got:
                        break
                    params[want[1:-1]] = got
                elif want != got:
                    break
            else:
                if route_method == method:
                    return handler, params
                path_known = True
        if path_known:
            raise HTTPError(405, "405: Method Not Allowed")
        return None

    async def dispatch(self, method: str, target: str, writer,
                       body: bytes = b"") -> bool:
        """Answer a routed request; False when no route has its path."""
        url = urlsplit(target)
        found = self.match(method, url.path)
        if found is None:
            return False
        handler, params = found
        query = {k: v[0] for k, v in parse_qs(url.query).items()}
        if method == "POST":
            status, out = await handler(params, query, body)
        else:
            status, out = await handler(params, query)
        if isinstance(out, bytes):
            ctype, data = "application/octet-stream", out
        elif isinstance(out, str):
            ctype, data = "text/plain; charset=utf-8", out.encode()
        else:
            ctype = "application/json; charset=utf-8"
            data = json.dumps(out).encode()
        writer.write(head(status, {"Content-Type": ctype,
                                   "Content-Length": str(len(data))}) + data)
        await writer.drain()
        return True


def parse_request(raw: bytes) -> tuple[str, str, dict]:
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


async def send_error(writer, exc: HTTPError, *, keep: bool) -> None:
    body = exc.text.encode()
    headers = {"Content-Type": "text/plain; charset=utf-8",
               "Content-Length": str(len(body)), **exc.headers}
    if not keep:
        headers["Connection"] = "close"
    writer.write(head(exc.status, headers) + body)
    await writer.drain()


async def linger(reader, writer, timeout_s: float = 1.0) -> None:
    """Half-close, then drop what the client still sends for a while: a
    close with its body unread resets the connection, which can destroy
    the answer before the client reads it."""
    async def drain() -> None:
        while await reader.read(1 << 16):
            pass
    try:
        writer.write_eof()
        await asyncio.wait_for(drain(), timeout_s)
    except (OSError, asyncio.TimeoutError):
        pass


async def serve_connection(reader, writer, route) -> None:
    """Requests of one keep-alive connection, each answered by
    ``await route(method, target, headers, writer, body)``; an
    ``HTTPError`` it raises is sent as the answer."""
    try:
        while True:
            try:
                raw = await reader.readuntil(b"\r\n\r\n")
            except asyncio.IncompleteReadError:
                return                    # client closed between requests
            except asyncio.LimitOverrunError:
                await send_error(writer, HTTPError(
                    431, "request head too large"), keep=False)
                return
            method, target, headers = parse_request(raw)
            keep = headers.get("connection", "").lower() != "close"
            length = int(headers.get("content-length") or 0)
            if length > BODY_LIMIT:
                await send_error(writer, HTTPError(
                    413, "request body too large"), keep=False)
                await linger(reader, writer)
                return
            # read whole before the handler runs: an unread body would be
            # parsed as the next request on this connection
            body = await reader.readexactly(length) if length else b""
            try:
                await route(method, target, headers, writer, body)
            except HTTPError as exc:
                await send_error(writer, exc, keep=keep)
            if not keep:
                return
    except (OSError, ValueError, asyncio.IncompleteReadError) as exc:
        # OSError: resets, and the TLS errors of an mTLS data plane
        log.debug("http connection dropped: %s", exc)
    finally:
        writer.close()


class RouteServer:
    """A server of one ``Router`` only (404 for any other path)."""

    def __init__(self, router: Router, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self.host = host
        self.port = port
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port, limit=HEAD_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def _on_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await serve_connection(reader, writer, self._route)
        finally:
            self._conns.discard(task)

    async def _route(self, method, target, headers, writer, body) -> None:
        if not await self.router.dispatch(method, target, writer, body):
            raise HTTPError(404, "404: Not Found")
