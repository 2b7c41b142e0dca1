"""Manager REST API.

Counterpart of ``dragonfly2_tpu/manager/rest.py`` (reference
``manager/handlers`` + ``manager/router``) for the entities this slice
ports: health, metrics, scheduler clusters (list, create), schedulers,
seed peers, seed-peer clusters (list, create), applications (list,
create), tenants (list, and create with the class checked against the
QoS vocabulary) and models (list). The reference serves with ``aiohttp.web``; the
card's machine has no aiohttp, so this module speaks HTTP/1.1 on
``asyncio.start_server``, as ``daemon/upload_server.py`` does, with the
same paths, status codes and JSON bodies. Jobs, users, personal access
tokens, OAuth and the cluster PATCH wait for later slices.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
from urllib.parse import parse_qs, urlsplit

from ..common.metrics import REGISTRY
from ..idl.messages import PRIORITY_CLASSES, ClusterConfig
from .store import Store

log = logging.getLogger("df.mgr.rest")

_REASONS = {200: "OK", 201: "Created", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed",
            413: "Payload Too Large", 500: "Internal Server Error"}
_HEAD_LIMIT = 64 << 10
_BODY_LIMIT = 1 << 20
_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"


class _HTTPError(Exception):
    def __init__(self, status: int, error: str):
        super().__init__(error)
        self.status = status
        self.error = error


def _json(obj, status: int = 200) -> tuple[int, str, bytes]:
    return status, _JSON, json.dumps(obj).encode()


def _body(raw: bytes) -> dict:
    """The request's JSON object; 400 for anything else."""
    try:
        body = json.loads(raw or b"{}")
    except ValueError as exc:
        raise _HTTPError(400, f"bad JSON body: {exc}") from None
    if not isinstance(body, dict):
        raise _HTTPError(400, "body must be a JSON object")
    return body


def _name(body: dict) -> str:
    name = body.get("name")
    if not isinstance(name, str) or not name:
        raise _HTTPError(400, "missing field 'name'")
    return name


class RestAPI:
    def __init__(self, store: Store, *, host: str = "0.0.0.0",
                 port: int = 0):
        self.store = store
        self.host = host
        self.port = port
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()
        self._routes = {
            ("GET", "/healthy"): self._healthy,
            ("GET", "/metrics"): self._metrics,
            ("GET", "/api/v1/scheduler-clusters"): self._list_sched_clusters,
            ("POST", "/api/v1/scheduler-clusters"):
                self._create_sched_cluster,
            ("GET", "/api/v1/schedulers"): self._list_schedulers,
            ("GET", "/api/v1/seed-peers"): self._list_seed_peers,
            ("GET", "/api/v1/applications"): self._list_applications,
            ("POST", "/api/v1/applications"): self._create_application,
            ("GET", "/api/v1/tenants"): self._list_tenants,
            ("POST", "/api/v1/tenants"): self._create_tenant,
            ("GET", "/api/v1/models"): self._list_models,
            ("GET", "/api/v1/seed-peer-clusters"): self._list_sp_clusters,
            ("POST", "/api/v1/seed-peer-clusters"): self._create_sp_cluster,
        }

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port, limit=_HEAD_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("manager REST on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    # -- HTTP/1.1 ------------------------------------------------------

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
                    return
                lines = raw[:-4].decode("latin-1").split("\r\n")
                parts = lines[0].split(" ")
                if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
                    return
                headers = {}
                for line in lines[1:]:
                    k, _, v = line.partition(":")
                    headers[k.strip().lower()] = v.strip()
                keep = headers.get("connection", "").lower() != "close"
                length = int(headers.get("content-length") or 0)
                if length > _BODY_LIMIT:
                    status, ctype, payload = _json(
                        {"error": "body too large"}, 413)
                    keep = False
                else:
                    body = await reader.readexactly(length) if length else b""
                    status, ctype, payload = await self._dispatch(
                        parts[0], parts[1], body)
                head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}",
                        f"Content-Type: {ctype}",
                        f"Content-Length: {len(payload)}"]
                if not keep:
                    head.append("Connection: close")
                writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                             + payload)
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, ValueError, asyncio.IncompleteReadError) \
                as exc:
            log.debug("REST connection dropped: %s", exc)
        finally:
            self._conns.discard(task)
            writer.close()

    async def _dispatch(self, method: str, target: str,
                        body: bytes) -> tuple[int, str, bytes]:
        url = urlsplit(target)
        handler = self._routes.get((method, url.path))
        if handler is None:
            if any(path == url.path for _, path in self._routes):
                return 405, _TEXT, b"405: Method Not Allowed"
            return 404, _TEXT, b"404: Not Found"
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        try:
            return await handler(query, body)
        except _HTTPError as exc:
            return _json({"error": exc.error}, exc.status)
        except Exception as exc:  # noqa: BLE001 - one request, not the server
            log.exception("REST %s %s failed", method, url.path)
            return _json({"error": str(exc)}, 500)

    # -- handlers ------------------------------------------------------

    async def _healthy(self, _q, _b):
        return 200, _TEXT, b"ok"

    async def _metrics(self, _q, _b):
        return 200, _TEXT, REGISTRY.expose().encode()

    async def _list_sched_clusters(self, _q, _b):
        return _json(await asyncio.to_thread(self.store.scheduler_clusters))

    async def _create_sched_cluster(self, _q, raw):
        body = _body(raw)
        name = _name(body)
        try:
            cfg = ClusterConfig(**(body.get("config") or {}))
        except TypeError as exc:
            raise _HTTPError(400, str(exc)) from None
        try:
            cid = await asyncio.to_thread(
                lambda: self.store.create_scheduler_cluster(
                    name, config=cfg, scopes=body.get("scopes"),
                    is_default=bool(body.get("is_default"))))
        except Exception as exc:  # noqa: BLE001 - e.g. duplicate name
            raise _HTTPError(400, str(exc)) from None
        return _json({"id": cid}, 201)

    async def _list_schedulers(self, _q, _b):
        return _json([dataclasses.asdict(s) for s in
                      await asyncio.to_thread(self.store.schedulers)])

    async def _list_seed_peers(self, _q, _b):
        return _json([dataclasses.asdict(s) for s in
                      await asyncio.to_thread(self.store.seed_peers)])

    async def _list_applications(self, _q, _b):
        return _json(await asyncio.to_thread(self.store.applications))

    async def _create_application(self, _q, raw):
        body = _body(raw)
        name = _name(body)
        app_id = await asyncio.to_thread(
            lambda: self.store.upsert_application(
                name, url=body.get("url", ""),
                priority=body.get("priority")))
        return _json({"id": app_id}, 201)

    async def _list_tenants(self, _q, _b):
        return _json(await asyncio.to_thread(self.store.tenants))

    async def _create_tenant(self, _q, raw):
        """A tenant's quota row. The class is checked against the QoS
        vocabulary at the write: a typo'd class fails the POST rather than
        losing its default at the scheduler."""
        body = _body(raw)
        if not body.get("name"):
            return _json({"error": "name required"}, 400)
        cls = body.get("qos_class", "")
        if cls and cls not in PRIORITY_CLASSES:
            return _json({"error": f"unknown qos_class {cls!r} "
                                   f"(known: {list(PRIORITY_CLASSES)})"},
                         400)
        try:
            max_running = int(body.get("max_running", 0) or 0)
            retry_ms = int(body.get("shed_retry_after_ms", 0) or 0)
        except (TypeError, ValueError) as exc:
            raise _HTTPError(400, str(exc)) from None
        tenant_id = await asyncio.to_thread(
            lambda: self.store.upsert_tenant(
                body["name"], qos_class=cls, max_running=max_running,
                shed_retry_after_ms=retry_ms))
        return _json({"id": tenant_id}, 201)

    async def _list_models(self, query, _b):
        name = query.get("name")
        return _json(await asyncio.to_thread(
            lambda: self.store.models(name=name)))

    async def _list_sp_clusters(self, _q, _b):
        return _json(await asyncio.to_thread(self.store.seed_peer_clusters))

    async def _create_sp_cluster(self, _q, raw):
        name = _name(_body(raw))
        try:
            cid = await asyncio.to_thread(self.store.create_seed_peer_cluster,
                                          name)
        except Exception as exc:  # noqa: BLE001 - e.g. duplicate name
            raise _HTTPError(400, str(exc)) from None
        return _json({"id": cid}, 201)
