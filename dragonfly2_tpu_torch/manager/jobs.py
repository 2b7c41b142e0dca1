"""Manager job runner: preheat and sync-peers fan-out to schedulers.

Counterpart of ``dragonfly2_tpu/manager/jobs.py`` (reference
``manager/job/preheat.go``, ``sync_peers.go`` and ``internal/job``, the
machinery group jobs over Redis queues). The queue is in-process and the
job table of record is the store's: a job is written ``pending``, turns
``running`` when its fan-out starts and ends ``succeeded`` (at least one
scheduler succeeded) or ``failed``, with one result entry per scheduler
address, so one scheduler's error is its own entry. A job a dead manager
left ``pending`` or ``running`` is dispatched again at boot
(``resume_interrupted``); both job types are idempotent, since a
re-dispatched ``Preheat`` joins the seed job its scheduler still runs.

An ``image`` preheat resolves an OCI manifest reference to its config and
layer blobs first (one level of manifest list or index, filtered by
``platform`` ``os/arch``), answering one bearer challenge with a token
from the challenge's realm, and hands the won ``Authorization`` to the
seeds in each blob's ``UrlMeta.header`` (headers are not part of the task
id). The reference resolves on an aiohttp session; the port's HTTP client
(``source/http_client.py``) follows a GET's redirects as aiohttp does.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import re
from urllib.parse import urlencode

from ..idl.messages import PreheatRequest, SyncPeersRequest, UrlMeta
from ..rpc.client import ChannelPool, ServiceClient
from ..source.http_client import HTTPSourceClient, json_body
from .store import Store

log = logging.getLogger("df.mgr.jobs")

SCHEDULER_SERVICE = "df.scheduler.Scheduler"

LIST_TYPES = (
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.index.v1+json")
MANIFEST_TYPES = (
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.oci.image.manifest.v1+json")
PREHEAT_CONCURRENCY = 8          # blobs in flight per scheduler
PREHEAT_TIMEOUT_S = 600.0        # one Preheat call, seed job included
SYNC_PEERS_TIMEOUT_S = 60.0
REGISTRY_TIMEOUT_S = 60.0        # each registry request of a resolution


class JobRunner:
    def __init__(self, store: Store):
        self.store = store
        self._channels = ChannelPool(limit=64)
        self._running: set[asyncio.Task] = set()
        self._http = HTTPSourceClient()

    def _spawn(self, coro) -> None:
        t = asyncio.get_running_loop().create_task(coro)
        self._running.add(t)
        t.add_done_callback(self._running.discard)

    async def submit_preheat(self, *, url: str, url_meta: UrlMeta | None = None,
                             cluster_id: int | None = None,
                             type_: str = "file",
                             platform: str = "") -> int:
        """``type_`` "file" preheats one URL; "image" treats ``url`` as an
        OCI manifest reference (``.../v2/<name>/manifests/<ref>``),
        resolves it (manifest lists filtered by ``platform`` "os/arch"),
        and preheats every config and layer blob (reference
        ``manager/job/preheat.go`` getImageLayers)."""
        job_id = await asyncio.to_thread(
            self.store.create_job, "preheat",
            {"url": url, "cluster_id": cluster_id,
             "type": type_, "platform": platform,
             # kept so that a resumed preheat warms the same task id
             # (UrlMeta is part of the task id)
             "url_meta": dataclasses.asdict(url_meta) if url_meta else None})
        self._spawn(self._run_preheat(job_id, url, url_meta, cluster_id,
                                      type_=type_, platform=platform))
        return job_id

    async def _fan_out(self, job_id: int, cluster_id: int | None,
                       kind: str, call) -> None:
        """The job scaffold: mark it running, call every active scheduler
        with per-target isolation, write the final state.
        ``call(client, addr)`` returns (result dict, ok)."""
        await asyncio.to_thread(self.store.update_job, job_id,
                                state="running")
        schedulers = await asyncio.to_thread(
            lambda: self.store.schedulers(cluster_id=cluster_id,
                                          only_active=True))
        if not schedulers:
            await asyncio.to_thread(self.store.update_job, job_id,
                                    state="failed",
                                    result={"error": "no active schedulers"})
            return
        results = {}
        ok = 0
        for sched in schedulers:
            addr = f"{sched.ip}:{sched.port}"
            try:
                client = ServiceClient(self._channels.get(addr),
                                       SCHEDULER_SERVICE)
                result, good = await call(client, addr)
                results[addr] = result
                if good:
                    ok += 1
            except Exception as exc:  # noqa: BLE001 - per-target isolation
                results[addr] = {"state": "failed", "error": str(exc)}
        state = "succeeded" if ok else "failed"
        await asyncio.to_thread(self.store.update_job, job_id, state=state,
                                result=results)
        log.info("%s job %d %s across %d scheduler(s)", kind, job_id, state,
                 len(schedulers))

    async def _run_preheat(self, job_id: int, url: str,
                           url_meta: UrlMeta | None,
                           cluster_id: int | None, *,
                           type_: str = "file",
                           platform: str = "") -> None:
        urls = [url]
        blob_meta = url_meta
        if type_ == "image":
            try:
                urls, auth = await self._resolve_image_layers(url, url_meta,
                                                              platform)
            except Exception as exc:  # noqa: BLE001 - job outcome, not crash
                await asyncio.to_thread(
                    self.store.update_job, job_id, state="failed",
                    result={"error": f"image resolution failed: {exc}"})
                return
            if not urls:
                await asyncio.to_thread(
                    self.store.update_job, job_id, state="failed",
                    result={"error": "image has no matching platform "
                                     "manifests/layers"})
                return
            if auth:
                # the seeds fetch the blobs: each blob's UrlMeta carries the
                # registry token the resolution won (reference parseLayers)
                base_meta = blob_meta or UrlMeta()
                blob_meta = dataclasses.replace(
                    base_meta, header={**(base_meta.header or {}), **auth})

        async def call(client, addr):
            # blobs are independent: the job ends with its slowest blob
            sem = asyncio.Semaphore(PREHEAT_CONCURRENCY)

            async def one(u: str) -> dict:
                async with sem:
                    resp = await client.unary(
                        "Preheat", PreheatRequest(url=u, url_meta=blob_meta,
                                                  wait=True),
                        timeout=PREHEAT_TIMEOUT_S)
                return {"url": u, "state": resp.state,
                        "task_id": resp.task_id}

            states = list(await asyncio.gather(*[one(u) for u in urls]))
            good = all(s["state"] == "succeeded" for s in states)
            if type_ == "image":
                return ({"state": "succeeded" if good else "failed",
                         "blobs": states}, good)
            return (states[0], good)

        await self._fan_out(job_id, cluster_id, "preheat", call)

    # -- OCI image resolution (reference manager/job/preheat.go) ---------

    @staticmethod
    def _parse_bearer_challenge(header: str) -> dict:
        return dict(re.findall(r'(\w+)="([^"]*)"', header))

    async def _get(self, url: str, headers: dict):
        resp = await self._http.request("GET", url, headers,
                                        timeout_s=REGISTRY_TIMEOUT_S)
        return resp.status, resp.headers, await resp.read()

    async def _registry_get(self, url: str, headers: dict,
                            auth: dict) -> tuple[int, dict, bytes]:
        """GET with the registry token dance: on a 401 with a Bearer
        challenge, fetch a token from the advertised realm and retry once
        (reference newImageAuthClient). A won token lands in ``auth``
        (mutated), so later requests and the seeds' blob fetches reuse
        it. The headers are looked up regardless of the server's casing:
        aiohttp gives the reference's ``dict(resp.headers)`` the canonical
        names of the headers it knows, ``Content-Type`` among them."""
        status, hdrs, body = await self._get(url, {**headers, **auth})
        if status != 401:
            return status, hdrs, body
        challenge = hdrs.get("WWW-Authenticate", "")
        ch = self._parse_bearer_challenge(challenge)
        realm = ch.get("realm")
        if not challenge.lower().startswith("bearer") or not realm:
            return 401, {}, b""
        params = {k: v for k, v in ch.items()
                  if k in ("service", "scope") and v}
        if params:
            realm += ("&" if "?" in realm else "?") + urlencode(params)
        tstatus, thdrs, tbody = await self._get(realm, {})
        if tstatus != 200:
            return 401, {}, b""
        # a token under a type that is not JSON fails the resolution, and
        # with it the job, as the reference's resp.json() does
        tok = json_body(tstatus, thdrs, tbody, realm).get("token") or ""
        auth["Authorization"] = f"Bearer {tok}"
        return await self._get(url, {**headers, **auth})

    async def _resolve_image_layers(self, url: str,
                                    url_meta: UrlMeta | None,
                                    platform: str
                                    ) -> tuple[list[str], dict]:
        """Manifest reference -> (every config and layer blob URL, the
        auth header the token dance won), following one level of manifest
        list or index (filtered by ``platform`` "os/arch" when given, as
        the reference's filterManifests)."""
        base, _, _ref = url.rpartition("/manifests/")
        if not base:
            raise ValueError(f"not a manifest reference: {url}")
        headers = dict((url_meta.header or {}) if url_meta else {})
        headers["Accept"] = ", ".join((*LIST_TYPES, *MANIFEST_TYPES))
        want_os = want_arch = ""
        if platform:
            want_os, _, want_arch = platform.partition("/")
        blobs: list[str] = []
        auth: dict = {}
        status, hdrs, body = await self._registry_get(url, headers, auth)
        if status != 200:
            raise ValueError(f"manifest fetch {status} for {url}")
        doc = json.loads(body)
        ctype = hdrs.get("Content-Type", doc.get("mediaType", ""))
        manifests = [doc]
        if ctype in LIST_TYPES or "manifests" in doc:
            manifests = []
            for entry in doc.get("manifests", []):
                p = entry.get("platform") or {}
                if platform and (p.get("os") != want_os
                                 or p.get("architecture") != want_arch):
                    continue
                status, _h, mbody = await self._registry_get(
                    f"{base}/manifests/{entry['digest']}", headers, auth)
                if status != 200:
                    raise ValueError(
                        f"sub-manifest fetch {status} for "
                        f"{entry['digest']}")
                manifests.append(json.loads(mbody))
        for m in manifests:
            cfg = (m.get("config") or {}).get("digest")
            if cfg:
                blobs.append(f"{base}/blobs/{cfg}")
            for layer in m.get("layers", []):
                if layer.get("digest"):
                    blobs.append(f"{base}/blobs/{layer['digest']}")
        # de-duplicated in order (layers shared across platforms)
        seen: set[str] = set()
        return ([b for b in blobs if not (b in seen or seen.add(b))], auth)

    async def submit_sync_peers(self, *,
                                cluster_id: int | None = None) -> int:
        """Fan SyncPeers out to the active schedulers; the live hosts land
        in the job's result (reference manager/job/sync_peers.go)."""
        job_id = await asyncio.to_thread(
            self.store.create_job, "sync_peers", {"cluster_id": cluster_id})
        self._spawn(self._run_sync_peers(job_id, cluster_id))
        return job_id

    async def _run_sync_peers(self, job_id: int,
                              cluster_id: int | None) -> None:
        async def call(client, addr):
            resp = await client.unary(
                "SyncPeers", SyncPeersRequest(cluster_id=cluster_id or 0),
                timeout=SYNC_PEERS_TIMEOUT_S)
            hosts = resp.hosts or []
            return ({"state": "succeeded",
                     "hosts": [{"id": h.id, "ip": h.ip,
                                "hostname": h.hostname, "type": int(h.type),
                                "download_port": h.download_port}
                               for h in hosts]}, True)

        await self._fan_out(job_id, cluster_id, "sync_peers", call)

    async def resume_interrupted(self) -> int:
        """Jobs the previous process left ``pending`` or ``running`` are
        dispatched again at boot (reference internal/job keeps jobs
        across restarts on Redis)."""
        # one snapshot of both states before any dispatch: a dispatched
        # job turns pending -> running, and a second query would see it
        # again
        snapshot = [job
                    for state in ("pending", "running")
                    for job in await asyncio.to_thread(
                        lambda s=state: self.store.jobs(state=s))]
        seen: set[int] = set()
        resumed = 0
        for job in snapshot:
            if job["id"] in seen:
                continue
            seen.add(job["id"])
            args = json.loads(job["args"] or "{}")
            if job["type"] == "preheat" and args.get("url"):
                meta = (UrlMeta(**args["url_meta"])
                        if args.get("url_meta") else None)
                self._spawn(self._run_preheat(
                    job["id"], args["url"], meta, args.get("cluster_id"),
                    type_=args.get("type", "file"),
                    platform=args.get("platform", "")))
            elif job["type"] == "sync_peers":
                self._spawn(self._run_sync_peers(job["id"],
                                                 args.get("cluster_id")))
            else:
                # an unknown type or malformed args: a terminal state, since
                # a job left running for good is what this scan ends
                await asyncio.to_thread(
                    self.store.update_job, job["id"], state="failed",
                    result={"error": f"unresumable job "
                                     f"type={job['type']!r}"})
                continue
            resumed += 1
        if resumed:
            log.info("resumed %d interrupted job(s)", resumed)
        return resumed

    async def close(self) -> None:
        for t in list(self._running):
            t.cancel()
        await asyncio.gather(*self._running, return_exceptions=True)
        await self._channels.close()
        await self._http.close()
