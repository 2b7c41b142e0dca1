"""Manager REST API.

Counterpart of ``dragonfly2_tpu/manager/rest.py`` (reference
``manager/handlers`` + ``manager/router``): health, metrics, scheduler
clusters (list, create), schedulers, seed peers, seed-peer clusters
(list, create), applications (list, create), tenants (list, and create
with the class checked against the QoS vocabulary), models (list), jobs
(``POST /api/v1/jobs`` of a ``preheat`` or ``sync_peers`` job, the list,
one by id), the cluster ``PATCH /api/v1/scheduler-clusters/{id}``, which
merges its ``config`` into the stored one (a numeric string coerced, a
wrong type or an unknown key refused) and replaces ``scopes``, and the
users, personal access tokens and OAuth providers of REST auth. With
``auth`` (an ``auth.Authenticator``) every request passes its ``gate``
before it is routed, as the reference's aiohttp middleware runs around
the 404 and 405 answers too: an unknown path without credentials is 401;
the OAuth sign-in and callback routes exist only then, and the sign-in
route answers 404 without it. The reference serves with
``aiohttp.web``; the card's machine has no aiohttp, so this module speaks
HTTP/1.1 on ``asyncio.start_server``, as ``daemon/upload_server.py`` does,
with the same paths (``{id}`` matching one path segment), status codes,
headers (``Location``, ``Retry-After``) and JSON bodies; a method not
routed on a known path is 405. Malformed input the reference answers 500
(a body that is no JSON object, a non-integer id, unknown ``url_meta``
keys) is 400 here.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import re
import socket
from dataclasses import dataclass
from urllib.parse import parse_qs, unquote, urlsplit

from ..common.errors import DFError
from ..common.metrics import REGISTRY
from ..idl.messages import PRIORITY_CLASSES, ClusterConfig, UrlMeta
from .auth import OAuthFlow
from .jobs import JobRunner
from .store import Store

log = logging.getLogger("df.mgr.rest")

_REASONS = {200: "OK", 201: "Created", 302: "Found", 400: "Bad Request",
            401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error"}
_HEAD_LIMIT = 64 << 10
_BODY_LIMIT = 1 << 20
_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"


class _HTTPError(Exception):
    def __init__(self, status: int, error: str):
        super().__init__(error)
        self.status = status
        self.error = error


@dataclass
class _Request:
    """What a handler reads of its request: the query (last value of each
    name), the body, the headers (names in lower case), ``Host`` and the
    user the auth gate attached (None: auth off or a public path)."""
    query: dict
    body: bytes
    headers: dict
    user: dict | None = None

    @property
    def host(self) -> str:
        # aiohttp's request.host: the Host header, else the machine's name
        return self.headers.get("host") or socket.getfqdn()


def _json(obj, status: int = 200, headers: dict | None = None
          ) -> tuple[int, str, bytes, dict]:
    """A JSON response: status, content type, body and extra headers."""
    return status, _JSON, json.dumps(obj).encode(), headers or {}


def _body(raw: bytes) -> dict:
    """The request's JSON object; 400 for anything else."""
    try:
        body = json.loads(raw or b"{}")
    except ValueError as exc:
        raise _HTTPError(400, f"bad JSON body: {exc}") from None
    if not isinstance(body, dict):
        raise _HTTPError(400, "body must be a JSON object")
    return body


def _int_id(raw: str) -> int:
    try:
        return int(raw)
    except ValueError:
        raise _HTTPError(400, f"id must be an integer: {raw!r}") from None


def _name(body: dict) -> str:
    name = body.get("name")
    if not isinstance(name, str) or not name:
        raise _HTTPError(400, "missing field 'name'")
    return name


class RestAPI:
    def __init__(self, store: Store, jobs: JobRunner | None = None, *,
                 host: str = "0.0.0.0", port: int = 0, auth=None):
        """``auth``: an ``auth.Authenticator``; None leaves the API open
        (the reference's dev mode, its middleware off)."""
        self.store = store
        self.jobs = jobs
        self.host = host
        self.port = port
        self.auth = auth
        self._oauth_flow = None
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
            ("POST", "/api/v1/jobs"): self._create_job,
            ("GET", "/api/v1/jobs"): self._list_jobs,
            ("GET", "/api/v1/jobs/{id}"): self._get_job,
            ("PATCH", "/api/v1/scheduler-clusters/{id}"):
                self._update_sched_cluster,
            ("POST", "/api/v1/users/signin"): self._signin,
            ("POST", "/api/v1/users"): self._create_user,
            ("GET", "/api/v1/users"): self._list_users,
            ("POST", "/api/v1/personal-access-tokens"): self._create_pat,
            ("GET", "/api/v1/personal-access-tokens"): self._list_pats,
            ("DELETE", "/api/v1/personal-access-tokens/{id}"):
                self._revoke_pat,
            ("GET", "/api/v1/oauth"): self._list_oauth,
            ("POST", "/api/v1/oauth"): self._create_oauth,
            ("DELETE", "/api/v1/oauth/{id}"): self._delete_oauth,
        }
        if auth is not None:
            self._oauth_flow = OAuthFlow(store, auth)
            self._routes[("GET", "/oauth/signin/{name}")] = \
                self._oauth_signin
            self._routes[("GET", "/oauth/callback/{name}")] = \
                self._oauth_callback
        # a "{name}" segment matches one path segment; its decoded text
        # is the handler's third argument
        self._patterns = [
            (method, re.compile("^" + re.sub(r"\\\{\w+\\\}", "([^/]+)",
                                             re.escape(path)) + "$"),
             handler)
            for (method, path), handler in self._routes.items()]

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
        if self._oauth_flow is not None:
            await self._oauth_flow.close()

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
                    status, ctype, payload, extra = _json(
                        {"error": "body too large"}, 413)
                    keep = False
                else:
                    body = await reader.readexactly(length) if length else b""
                    status, ctype, payload, extra = await self._dispatch(
                        parts[0], parts[1], body, headers)
                head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}",
                        f"Content-Type: {ctype}",
                        f"Content-Length: {len(payload)}",
                        *(f"{k}: {v}" for k, v in extra.items())]
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

    async def _dispatch(self, method: str, target: str, body: bytes,
                        headers: dict) -> tuple[int, str, bytes, dict]:
        url = urlsplit(target)
        req = _Request({k: v[-1] for k, v in parse_qs(url.query).items()},
                       body, headers)
        try:
            if self.auth is not None:
                # before routing: an unknown path or an unrouted method
                # without credentials is 401, as in the reference
                req.user, refused = self.auth.gate(method, unquote(url.path),
                                                   headers)
                if refused is not None:
                    status, answer, extra = refused
                    return _json(answer, status, extra)
            handler, args, known = None, (), False
            for m, pattern, h in self._patterns:
                match = pattern.match(url.path)
                if match is None:
                    continue
                known = True
                if m == method:
                    handler = h
                    args = tuple(unquote(g) for g in match.groups())
                    break
            if handler is None:
                if known:
                    return 405, _TEXT, b"405: Method Not Allowed", {}
                return 404, _TEXT, b"404: Not Found", {}
            return await handler(req, *args)
        except _HTTPError as exc:
            return _json({"error": exc.error}, exc.status)
        except Exception as exc:  # noqa: BLE001 - one request, not the server
            log.exception("REST %s %s failed", method, url.path)
            return _json({"error": str(exc)}, 500)

    # -- handlers ------------------------------------------------------

    async def _healthy(self, _r):
        return 200, _TEXT, b"ok", {}

    async def _metrics(self, _r):
        return 200, _TEXT, REGISTRY.expose().encode(), {}

    async def _list_sched_clusters(self, _r):
        return _json(await asyncio.to_thread(self.store.scheduler_clusters))

    async def _create_sched_cluster(self, r):
        body = _body(r.body)
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

    async def _list_schedulers(self, _r):
        return _json([dataclasses.asdict(s) for s in
                      await asyncio.to_thread(self.store.schedulers)])

    async def _list_seed_peers(self, _r):
        return _json([dataclasses.asdict(s) for s in
                      await asyncio.to_thread(self.store.seed_peers)])

    async def _list_applications(self, _r):
        return _json(await asyncio.to_thread(self.store.applications))

    async def _create_application(self, r):
        body = _body(r.body)
        name = _name(body)
        app_id = await asyncio.to_thread(
            lambda: self.store.upsert_application(
                name, url=body.get("url", ""),
                priority=body.get("priority")))
        return _json({"id": app_id}, 201)

    async def _list_tenants(self, _r):
        return _json(await asyncio.to_thread(self.store.tenants))

    async def _create_tenant(self, r):
        """A tenant's quota row. The class is checked against the QoS
        vocabulary at the write: a typo'd class fails the POST rather than
        losing its default at the scheduler."""
        body = _body(r.body)
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

    async def _list_models(self, r):
        name = r.query.get("name")
        return _json(await asyncio.to_thread(
            lambda: self.store.models(name=name)))

    async def _list_sp_clusters(self, _r):
        return _json(await asyncio.to_thread(self.store.seed_peer_clusters))

    async def _create_sp_cluster(self, r):
        name = _name(_body(r.body))
        try:
            cid = await asyncio.to_thread(self.store.create_seed_peer_cluster,
                                          name)
        except Exception as exc:  # noqa: BLE001 - e.g. duplicate name
            raise _HTTPError(400, str(exc)) from None
        return _json({"id": cid}, 201)

    async def _create_job(self, r):
        body = _body(r.body)
        args = body.get("args", {})
        if not isinstance(args, dict):
            raise _HTTPError(400, "args must be an object")
        if body.get("type") == "preheat":
            if not args.get("url"):
                return _json({"error": "preheat requires args.url"}, 400)
            if args.get("type", "file") not in ("file", "image"):
                return _json({"error": "preheat args.type must be file|image"},
                             400)
            meta = None
            if args.get("url_meta"):
                try:
                    meta = UrlMeta(**args["url_meta"])
                except TypeError as exc:
                    raise _HTTPError(400, f"url_meta: {exc}") from None
            job_id = await self.jobs.submit_preheat(
                url=args["url"], url_meta=meta,
                cluster_id=args.get("cluster_id"),
                type_=args.get("type", "file"),
                platform=args.get("platform", ""))
        elif body.get("type") == "sync_peers":
            job_id = await self.jobs.submit_sync_peers(
                cluster_id=args.get("cluster_id"))
        else:
            return _json({"error": "unknown job type"}, 400)
        return _json({"id": job_id}, 201)

    async def _list_jobs(self, _r):
        return _json(await asyncio.to_thread(self.store.jobs))

    async def _get_job(self, _r, job_id):
        job = await asyncio.to_thread(self.store.job, _int_id(job_id))
        if job is None:
            return _json({"error": "not found"}, 404)
        job["args"] = json.loads(job["args"])
        job["result"] = json.loads(job["result"])
        return _json(job)

    async def _update_sched_cluster(self, r, cluster_id):
        # parsed as the reference's request.json(): an empty or junk body
        # answers 400 with the decoder's own message
        try:
            body = json.loads(r.body.decode())
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except Exception as exc:  # noqa: BLE001 - malformed input is a 400
            return _json({"error": str(exc)}, 400)
        cid = _int_id(cluster_id)
        cfg = None
        if body.get("config") is not None:
            if not isinstance(body["config"], dict):
                return _json({"error": "config must be an object"}, 400)
            # a partial update merges over the stored config: rebuilding
            # from the defaults would reset every omitted tunable
            current = await asyncio.to_thread(self.store.cluster_config, cid)
            # each value is checked against the stored field's type: a
            # wrong-typed value would be stored and then break every
            # scheduler's dynconfig refresh
            coerced = {}
            for k, v in body["config"].items():
                if not hasattr(current, k):
                    return _json({"error": f"unknown config key {k!r}"}, 400)
                target = type(getattr(current, k))
                value = _coerce(target, v)
                if value is _BAD:
                    return _json({"error": f"{k} must be {target.__name__}"},
                                 400)
                coerced[k] = value
            try:
                cfg = dataclasses.replace(current, **coerced)
            except TypeError as exc:
                return _json({"error": str(exc)}, 400)
        if cfg is None and body.get("scopes") is None:
            return _json({"error": "nothing to update"}, 400)
        ok = await asyncio.to_thread(
            lambda: self.store.update_scheduler_cluster(
                cid, config=cfg, scopes=body.get("scopes")))
        return _json({"ok": ok}, 200 if ok else 404)


    # -- users and tokens (reference manager/handlers/user.go, pat.go) --

    async def _signin(self, r):
        if self.auth is None:
            return _json({"error": "auth disabled"}, 404)
        body = _body(r.body)
        user = await asyncio.to_thread(
            self.store.verify_user, body.get("name", ""),
            body.get("password", ""))
        if user is None:
            return _json({"error": "bad credentials"}, 401)
        return _json({"token": self.auth.mint_session(user),
                      "role": user["role"]})

    async def _create_user(self, r):
        body = _body(r.body)
        try:
            uid = await asyncio.to_thread(
                lambda: self.store.create_user(
                    body["name"], body["password"],
                    role=body.get("role", "guest")))
        except Exception as exc:  # noqa: BLE001 - a duplicate name, a bad role
            return _json({"error": str(exc)}, 400)
        return _json({"id": uid}, 201)

    async def _create_pat(self, r):
        body = _body(r.body)
        user = r.user or {"id": body.get("user_id", 0)}
        token = await asyncio.to_thread(
            lambda: self.store.create_pat(
                user["id"], label=body.get("label", ""),
                ttl_s=float(body.get("ttl_s", 0))))
        return _json({"token": token}, 201)

    async def _list_pats(self, r):
        uid = r.user["id"] if r.user and r.user["role"] != "root" else None
        return _json(await asyncio.to_thread(lambda: self.store.pats(uid)))

    async def _revoke_pat(self, _r, pat_id):
        await asyncio.to_thread(self.store.revoke_pat, _int_id(pat_id))
        return _json({"ok": True})

    async def _list_users(self, r):
        if r.user is not None and r.user.get("role") != "root":
            # user names include OAuth identities: operators only
            return _json({"error": "forbidden"}, 403)
        return _json(await asyncio.to_thread(self.store.users))

    # -- OAuth (reference manager/handlers/oauth.go) ----------------------

    async def _list_oauth(self, _r):
        return _json(await asyncio.to_thread(self.store.oauths))

    async def _create_oauth(self, r):
        body = _body(r.body)
        try:
            oid = await asyncio.to_thread(
                lambda: self.store.create_oauth(
                    body["name"], client_id=body["client_id"],
                    client_secret=body["client_secret"],
                    auth_url=body["auth_url"], token_url=body["token_url"],
                    userinfo_url=body["userinfo_url"],
                    scopes=body.get("scopes", "")))
        except KeyError as exc:
            return _json({"error": f"missing field {exc}"}, 400)
        except Exception as exc:  # noqa: BLE001 - e.g. a duplicate name
            return _json({"error": str(exc)}, 400)
        return _json({"id": oid}, 201)

    async def _delete_oauth(self, _r, oauth_id):
        ok = await asyncio.to_thread(self.store.delete_oauth,
                                     _int_id(oauth_id))
        return _json({"ok": ok}, 200 if ok else 404)

    def _redirect_uri(self, r, name: str) -> str:
        return r.query.get("redirect_uri",
                           f"http://{r.host}/oauth/callback/{name}")

    async def _oauth_signin(self, r, name):
        try:
            url = await self._oauth_flow.signin_url(
                name, self._redirect_uri(r, name))
        except DFError as exc:
            # the state table is full (a flood of mints): 429, not 500
            return _json({"error": exc.message}, 429)
        if url is None:
            return _json({"error": "unknown provider"}, 404)
        # aiohttp's HTTPFound, body and all
        return 302, _TEXT, b"302: Found", {"Location": url}

    async def _oauth_callback(self, r, name):
        result = await self._oauth_flow.callback(
            name, r.query.get("code", ""), r.query.get("state", ""),
            self._redirect_uri(r, name))
        if result is None:
            return _json({"error": "oauth signin rejected"}, 401)
        return _json(result)


_BAD = object()


def _coerce(target: type, v):
    """``v`` as a value of the stored field's type, or ``_BAD``: a bool
    only for a bool; for an int, no bool or float (a float would be
    truncated) but a numeric string (what clients send); for a float, no
    bool."""
    if target is bool:
        return v if isinstance(v, bool) else _BAD
    if target is int:
        if isinstance(v, (bool, float)):
            return _BAD
        try:
            return int(v)
        except (TypeError, ValueError):
            return _BAD
    if target is float:
        if isinstance(v, bool):
            return _BAD
        try:
            return float(v)
        except (TypeError, ValueError):
            return _BAD
    return v if isinstance(v, target) else _BAD
