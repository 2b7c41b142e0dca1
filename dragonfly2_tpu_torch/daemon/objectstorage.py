"""Object-storage gateway: S3-ish REST on the daemon, P2P-accelerated GETs.

Counterpart of ``dragonfly2_tpu/daemon/objectstorage.py`` (reference
``client/daemon/objectstorage/``): the routes of the reference
(``/healthy``, ``GET /buckets``, ``GET /buckets/{bucket}/objects`` and
``HEAD``/``GET``/``PUT``/``DELETE`` on ``/buckets/{bucket}/objects/{key}``),
a GET through the P2P task engine (``PeerTaskManager.stream_task``, in
piece order as the pieces land), a PUT with write-back to the bucket's
backend and import into the local piece cache, and the reference's
``df_objstore_requests_total{op,status}``. A bucket maps to a source URL
base (``ObjectStorageConfig.buckets``: ``file://``, ``http(s)://``,
``s3://``, ``gs://``, ``memory://``, or a scheme a source plugin
registered) and optionally to a
write backend (``backends``: ``common/objectstorage.py``); a ``file://``
bucket gets an implicit file backend. Reads of an ``s3`` backend's bucket
go to that backend's endpoint (``s3+http(s)://``), under the object
task's ``UrlMeta(tag="objstore")``, so a prefetcher that names the same
URL and meta joins the same swarm.

The reference serves with aiohttp (``client_max_size=0``, streamed both
ways). This gateway has its own connection loop on asyncio streams, with
``common/httpd.py``'s parser: a request body (``Content-Length`` or
chunked) is streamed to the handler and a PUT spools it to a file under
the daemon's data directory (memory stays bounded at any object size);
a GET streams its response as the pieces are read. The QoS governor's
shed answers a GET 429 with ``Retry-After`` and ``X-Retry-After-Ms``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import tempfile
from dataclasses import dataclass
from typing import AsyncIterator
from urllib.parse import parse_qs, quote, unquote, urlsplit

from ..common.errors import Code, DFError
from ..common.httpd import HEAD_LIMIT, head, linger, parse_request
from ..common.metrics import REGISTRY
from ..common.objectstorage import BackendConfig, S3Credentials, make_backend
from ..idl.messages import TaskType, UrlMeta
from ..source import SourceRequest, client_for
from .config import ObjectStorageConfig

log = logging.getLogger("df.http.objstore")

_obj_reqs = REGISTRY.counter("df_objstore_requests_total",
                             "object gateway requests", ("op", "status"))

_CHUNK = 1 << 20


class _Body:
    """A request's body, read from the connection as the handler asks:
    ``Content-Length`` or chunked transfer encoding."""

    def __init__(self, reader: asyncio.StreamReader, headers: dict):
        self.reader = reader
        self.chunked = "chunked" in headers.get("transfer-encoding",
                                                "").lower()
        self.left = 0 if self.chunked else int(
            headers.get("content-length") or 0)
        self.done = not self.chunked and self.left == 0

    async def chunks(self) -> AsyncIterator[bytes]:
        if self.chunked:
            while not self.done:
                line = await self.reader.readline()
                size = int(line.split(b";", 1)[0].strip() or b"0", 16)
                if size == 0:
                    while (await self.reader.readline()).strip():
                        pass                      # trailer fields
                    self.done = True
                    return
                while size > 0:
                    data = await self.reader.read(min(_CHUNK, size))
                    if not data:
                        raise ConnectionError("body ended inside a chunk")
                    size -= len(data)
                    yield data
                await self.reader.readexactly(2)
            return
        while self.left > 0:
            data = await self.reader.read(min(_CHUNK, self.left))
            if not data:
                raise ConnectionError("body ended early")
            self.left -= len(data)
            yield data
        self.done = True

    async def discard(self) -> None:
        async for _ in self.chunks():
            pass


@dataclass
class _Request:
    method: str
    path: str
    query: dict
    headers: dict
    body: _Body
    writer: asyncio.StreamWriter


def _reply(req: _Request, status: int, body=b"",
           headers: dict | None = None) -> None:
    """Queue a whole response: a dict or list goes as JSON, a str as
    text."""
    if isinstance(body, (dict, list)):
        data = json.dumps(body).encode()
        ctype = "application/json; charset=utf-8"
    elif isinstance(body, str):
        data, ctype = body.encode(), "text/plain; charset=utf-8"
    else:
        data, ctype = body, "application/octet-stream"
    out = {"Content-Type": ctype, "Content-Length": str(len(data))}
    out.update(headers or {})
    req.writer.write(head(status, out) + (b"" if req.method == "HEAD"
                                           else data))


class ObjectGateway:
    def __init__(self, daemon, cfg: ObjectStorageConfig):
        self.daemon = daemon
        self.cfg = cfg
        self.port = cfg.port
        # write-path backends (reference pkg/objectstorage clients);
        # file:// read buckets get an implicit file backend
        self._backends = {}
        for bucket, bcfg in (cfg.backends or {}).items():
            self._backends[bucket] = make_backend(BackendConfig(**bcfg))
        for bucket, base in cfg.buckets.items():
            if bucket not in self._backends and base.startswith("file://"):
                self._backends[bucket] = make_backend(BackendConfig(
                    kind="file", base=base[len("file://"):]))
        self._writebacks: set[asyncio.Task] = set()
        # reads of s3-backed buckets sign with the backend's credentials.
        # The s3 source client is a process singleton, so one credential
        # set per process: signing bucket B's reads with bucket A's key
        # would fail only at read time, so two sets are refused here
        s3_creds = {(b["access_key"], b["secret_key"],
                     b.get("region", "us-east-1"))
                    for b in (cfg.backends or {}).values()
                    if b.get("kind") == "s3" and b.get("access_key")}
        if len(s3_creds) > 1:
            raise DFError(Code.INVALID_ARGUMENT,
                          "multiple s3 backends with DIFFERENT credentials "
                          "are not supported in one daemon")
        self._s3_creds = (S3Credentials(*next(iter(s3_creds)))
                          if s3_creds else None)
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()
        self._spool_dir = ""

    def _object_url(self, bucket: str, key: str) -> str:
        base = self.cfg.buckets.get(bucket)
        if base is None:
            raise DFError(Code.NOT_FOUND, f"bucket {bucket!r} not configured")
        bcfg = (self.cfg.backends or {}).get(bucket)
        if base.startswith("s3://") and bcfg and bcfg.get("kind") == "s3":
            # reads go to the configured backend's endpoint and bucket:
            # resolving s3:// from the process's environment while writes
            # go to the configured endpoint would 404 after a cache loss
            endpoint = bcfg["base"].rstrip("/")
            scheme = "s3+https" if endpoint.startswith("https") else "s3+http"
            host = endpoint.split("://", 1)[1]
            backend_bucket = bcfg.get("bucket") or bucket
            base = f"{scheme}://{host}/{backend_bucket}"
        # the key arrives percent-decoded, so '../..' may be literal: dot
        # segments are refused outright, and a file:// key must resolve
        # under the bucket's base
        if any(seg in ("..", ".") for seg in key.split("/")):
            raise DFError(Code.INVALID_ARGUMENT,
                          f"object key {key!r} contains dot segments")
        url = base.rstrip("/") + "/" + quote(key)
        if url.startswith("file://"):
            # dflint: disable=DF001 — two lstat walks for sandbox containment, µs-scale
            root = os.path.realpath(base[len("file://"):])
            # dflint: disable=DF001 — two lstat walks for sandbox containment, µs-scale
            dest = os.path.realpath(base[len("file://"):].rstrip("/")
                                    + "/" + key)
            if dest != root and not dest.startswith(root + os.sep):
                raise DFError(Code.INVALID_ARGUMENT,
                              f"object key {key!r} escapes bucket")
        return url

    async def start(self) -> None:
        if self._s3_creds is not None:
            client_for("s3://x/x").set_credentials(self._s3_creds)
        self._spool_dir = os.path.join(self.daemon.paths.data_dir,
                                       "objstore-spool")
        # dflint: disable=DF001 — spool-dir creation during start(), the gateway serves nothing yet
        os.makedirs(self._spool_dir, exist_ok=True)
        self._server = await asyncio.start_server(
            self._on_conn, self.daemon.cfg.listen_ip, self.port,
            limit=HEAD_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("object gateway on :%d (%d buckets)", self.port,
                 len(self.cfg.buckets))

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for t in list(self._conns):
                t.cancel()
            await asyncio.gather(*self._conns, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None
        # drain in-flight async write-backs: a 202 promised eventual
        # backend durability, and cancelling one loses the only durable
        # copy
        if self._writebacks:
            log.info("draining %d async write-backs", len(self._writebacks))
            _done, pending = await asyncio.wait(self._writebacks, timeout=30)
            for t in pending:
                t.cancel()
                log.error("async write-back cancelled at shutdown — object "
                          "may exist only in the cache")
        for backend in self._backends.values():
            close = getattr(backend, "close", None)
            if close is not None:
                await close()

    # ------------------------------------------------------------------
    # connection loop
    # ------------------------------------------------------------------

    async def _on_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                try:
                    raw = await reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError:
                    return               # the client closed between requests
                except asyncio.LimitOverrunError:
                    writer.write(head(431, {"Content-Length": "0",
                                             "Connection": "close"}))
                    await writer.drain()
                    return
                method, target, headers = parse_request(raw)
                url = urlsplit(target)
                req = _Request(method=method, path=url.path,
                               query={k: v[0] for k, v in
                                      parse_qs(url.query).items()},
                               headers=headers, body=_Body(reader, headers),
                               writer=writer)
                keep = await self._route(req)
                keep = keep and headers.get("connection",
                                            "").lower() != "close"
                if not req.body.done:
                    if req.body.left > HEAD_LIMIT or req.body.chunked:
                        # an unread large body: answer, then drop the
                        # connection rather than read it through
                        await writer.drain()
                        await linger(reader, writer)
                        return
                    await req.body.discard()
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, ValueError,
                asyncio.IncompleteReadError) as exc:
            log.debug("gateway connection dropped: %s", exc)
        finally:
            self._conns.discard(task)
            writer.close()

    async def _route(self, req: _Request) -> bool:
        """Answer one request; False when the connection must close (a
        stream failed mid-body)."""
        parts = req.path.split("/", 4)
        if req.path == "/healthy" and req.method == "GET":
            _reply(req, 200, "ok")
        elif req.path == "/buckets" and req.method == "GET":
            _reply(req, 200, sorted(self.cfg.buckets))
        elif (len(parts) == 4 and parts[1] == "buckets" and parts[2]
              and parts[3] == "objects"):
            if req.method != "GET":
                _reply(req, 405, "405: Method Not Allowed")
            else:
                await self._list_objects(req, unquote(parts[2]))
        elif (len(parts) == 5 and parts[1] == "buckets" and parts[2]
              and parts[3] == "objects" and parts[4]):
            bucket, key = unquote(parts[2]), unquote(parts[4])
            handler = {"HEAD": self._head_object, "GET": self._get_object,
                       "PUT": self._put_object,
                       "DELETE": self._delete_object}.get(req.method)
            if handler is None:
                _reply(req, 405, "405: Method Not Allowed")
            else:
                return await handler(req, bucket, key) is not False
        else:
            _reply(req, 404, "404: Not Found")
        return True

    # ------------------------------------------------------------------
    # handlers
    # ------------------------------------------------------------------

    async def _list_objects(self, req: _Request, bucket: str) -> None:
        try:
            url = self._object_url(bucket, "")
            entries = await client_for(url).list(SourceRequest(url=url))
        except DFError as exc:
            _obj_reqs.labels("list", "err").inc()
            _reply(req, 404, {"error": exc.message})
            return
        _obj_reqs.labels("list", "ok").inc()
        _reply(req, 200, [
            {"key": e.name, "size": e.content_length, "is_dir": e.is_dir}
            for e in entries])

    async def _head_object(self, req: _Request, bucket: str,
                           key: str) -> None:
        try:
            url = self._object_url(bucket, key)
        except DFError:
            _obj_reqs.labels("head", "404").inc()
            _reply(req, 404)
            return
        try:
            length = await client_for(url).content_length(
                SourceRequest(url=url))
        except DFError:
            length = -1
        if length < 0:
            _obj_reqs.labels("head", "404").inc()
            _reply(req, 404)
            return
        _obj_reqs.labels("head", "ok").inc()
        req.writer.write(head(200, {"Content-Length": str(length)}))

    async def _get_object(self, req: _Request, bucket: str,
                          key: str) -> bool:
        try:
            url = self._object_url(bucket, key)
        except DFError as exc:
            _obj_reqs.labels("get", "404").inc()
            _reply(req, 404, {"error": exc.message})
            return True
        # multi-tenant QoS: class and tenant ride request headers, the
        # proxy surface's contract
        meta = UrlMeta(
            tag="objstore",
            tenant=req.headers.get("x-dragonfly-tenant", ""),
            qos_class=req.headers.get("x-dragonfly-class", ""))
        try:
            task_id, chunks = await self.daemon.ptm.stream_task(url, meta)
        except DFError as exc:
            if exc.code == Code.RESOURCE_EXHAUSTED:
                # a QoS shed or tenant quota: the 429 + Retry-After
                # contract
                _obj_reqs.labels("get", "shed").inc()
                retry_ms = getattr(exc, "retry_after_ms", 0) or 1000
                _reply(req, 429, {"error": exc.message},
                       {"Retry-After": str(-(-retry_ms // 1000)),
                        "X-Retry-After-Ms": str(retry_ms)})
                return True
            _obj_reqs.labels("get", "err").inc()
            _reply(req, 502, {"error": exc.message})
            return True
        # the head waits for the first piece: by then the length is known
        # (a fresh task learns it at register), and a task that fails
        # before its first byte still gets a status
        try:
            first = await anext(chunks, None)
        except DFError as exc:
            _obj_reqs.labels("get", "err").inc()
            _reply(req, 502, {"error": exc.message})
            return True
        conductor = self.daemon.ptm.conductor(task_id)
        length = conductor.content_length if conductor is not None else -1
        if length < 0:
            ts = self.daemon.ptm.storage_mgr.find_completed_task(task_id)
            length = ts.md.content_length if ts is not None else -1
        hdrs = {"Content-Type": "application/octet-stream"}
        if length >= 0:
            hdrs["Content-Length"] = str(length)
        else:
            hdrs["Transfer-Encoding"] = "chunked"
        w = req.writer
        w.write(head(200, hdrs))

        async def rest() -> AsyncIterator[bytes]:
            if first is not None:
                yield first
            async for chunk in chunks:
                yield chunk

        try:
            async for chunk in rest():
                if length < 0:
                    w.write(f"{len(chunk):x}\r\n".encode() + chunk
                            + b"\r\n")
                else:
                    w.write(chunk)
                await w.drain()
        except DFError as exc:
            # mid-stream failure: the dropped connection is the error
            log.warning("object stream %s failed: %s", url, exc.message)
            _obj_reqs.labels("get", "err").inc()
            return False
        if length < 0:
            w.write(b"0\r\n\r\n")
        _obj_reqs.labels("get", "ok").inc()
        return True

    async def _put_object(self, req: _Request, bucket: str,
                          key: str) -> None:
        """PUT with write-back (reference ``objectstorage.go:369``
        modes):

        - ``write_back`` (default): spool, write to the backend, then
          import into the local piece cache: 201 only once the backend
          has the object;
        - ``async_write_back``: 202 as soon as the local import lands;
          the backend upload runs in the background (a failed one is
          logged and counted as ``put``/``writeback_err``).
        """
        try:
            url = self._object_url(bucket, key)
        except DFError as exc:
            _obj_reqs.labels("put", "404").inc()
            _reply(req, 404, {"error": exc.message})
            return
        backend = self._backends.get(bucket)
        if backend is None:
            _obj_reqs.labels("put", "501").inc()
            _reply(req, 501, {"error": f"bucket {bucket!r} has no write "
                                       f"backend"})
            return
        mode = (req.headers.get("x-dragonfly-write-back-mode")
                or req.query.get("mode") or "write_back")
        if mode not in ("write_back", "async_write_back"):
            _obj_reqs.labels("put", "400").inc()
            _reply(req, 400, {"error": f"unknown mode {mode!r}"})
            return
        # the body is spooled once; the local import and the backend
        # upload both read the spool
        tmp_fd, tmp_path = tempfile.mkstemp(prefix="df-objput-",
                                            dir=self._spool_dir)

        def unlink() -> None:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass

        try:
            with os.fdopen(tmp_fd, "wb") as f:
                async for chunk in req.body.chunks():
                    await asyncio.to_thread(f.write, chunk)

            async def import_local() -> None:
                # a re-PUT must replace the cached task, or the mesh
                # serves the old bytes while the backend holds the new
                # (import_file leaves a completed task as it is)
                task_id = self.daemon.ptm._task_id(url,
                                                   UrlMeta(tag="objstore"))
                await self.daemon.ptm.delete_task(task_id)
                await self.daemon.ptm.import_file(
                    tmp_path, url, UrlMeta(tag="objstore"),
                    task_type=TaskType.STANDARD)

            async def write_back() -> None:
                # dflint: disable=DF001 — one stat of a temp file we just wrote
                size = os.path.getsize(tmp_path)

                async def chunks():
                    # off-loop open and reads: a multi-GB upload must not
                    # stall the daemon's sockets per block
                    f = await asyncio.to_thread(open, tmp_path, "rb")
                    try:
                        while True:
                            block = await asyncio.to_thread(f.read, _CHUNK)
                            if not block:
                                return
                            yield block
                    finally:
                        f.close()

                backend_bucket = getattr(backend, "bucket", "") or bucket
                await backend.put_object(backend_bucket, key, chunks(),
                                         content_length=size)

            if mode == "write_back":
                # the backend first: 201 promises the origin has the
                # object, and a failed backend write must not leave the
                # mesh serving bytes the origin never accepted
                await write_back()
                try:
                    await import_local()
                except DFError as exc:
                    log.warning("PUT import of %s failed: %s", key,
                                exc.message)
                unlink()
            else:
                # latency over durability: the local import serves at
                # once, the backend converges
                try:
                    await import_local()
                except DFError as exc:
                    log.warning("PUT import of %s failed: %s", key,
                                exc.message)

                async def write_back_bg() -> None:
                    try:
                        await write_back()
                    except Exception as exc:  # noqa: BLE001
                        _obj_reqs.labels("put", "writeback_err").inc()
                        log.error("async write-back of %s/%s FAILED — the "
                                  "object exists only in the volatile "
                                  "cache: %s", bucket, key, exc)
                    finally:
                        unlink()

                task = asyncio.get_running_loop().create_task(write_back_bg())
                self._writebacks.add(task)
                task.add_done_callback(self._writebacks.discard)
        except DFError as exc:
            _obj_reqs.labels("put", "err").inc()
            unlink()
            _reply(req, 502, {"error": exc.message})
            return
        except BaseException:
            unlink()
            raise
        _obj_reqs.labels("put", "ok").inc()
        _reply(req, 201 if mode == "write_back" else 202)

    async def _delete_object(self, req: _Request, bucket: str,
                             key: str) -> None:
        try:
            url = self._object_url(bucket, key)
        except DFError as exc:
            _reply(req, 404, {"error": exc.message})
            return
        # the write backend first: dropping only the cache would let the
        # next read-through GET resurrect the object from the origin
        backend = self._backends.get(bucket)
        if backend is not None:
            try:
                await backend.delete_object(
                    getattr(backend, "bucket", "") or bucket, key)
            except DFError as exc:
                _obj_reqs.labels("delete", "err").inc()
                _reply(req, 502, {"error": exc.message})
                return
        elif url.startswith("file://"):
            try:
                await asyncio.to_thread(os.unlink, unquote(
                    url[len("file://"):]))
            except FileNotFoundError:
                pass
        # and the cached task
        task_id = self.daemon.ptm._task_id(url, UrlMeta(tag="objstore"))
        await self.daemon.ptm.delete_task(task_id)
        _obj_reqs.labels("delete", "ok").inc()
        _reply(req, 204)
