"""The manager's jobs (preheat, sync-peers, resume) and the cluster PATCH,
against the reference's.

* Codec: ``PreheatRequest``, ``PreheatResponse``, ``SyncPeersRequest``
  and ``SyncPeersResponse`` built from seeded fields give the reference's
  msgpack bytes.
* Store: job rows and a PATCHed cluster config written by either
  package's ``Store`` read back equal through the other's.
* Scheduler: ``preheat`` and ``sync_peers`` of both ``SchedulerService``
  classes against a stub seed client give the same task ids (the id a
  daemon's register computes), states, ``SCHED_FORBIDDEN`` with no seed,
  the same trigger counts (a failed seed re-triggered, a running one
  joined) and the same response bytes.
* REST: one sequence of job POSTs and GETs, and one of cluster PATCH
  bodies (the merge, a numeric string, junk, an unknown key, the empty
  body), sent to both REST servers, get equal status codes and JSON
  (timestamps aside), but where the reference answers 500 (ROADMAP known
  difference 8: a non-integer id, unknown ``url_meta`` keys) and the
  port 400.
* Image resolution: both packages' ``_resolve_image_layers`` against a
  standard-library registry stand-in (a bearer challenge with a
  ``/token`` realm, a manifest list with a config and layers per
  platform) return the same blob URLs and token, whether the stand-in
  names its ``Content-Type`` in that casing or lower case, with and
  without a platform filter.
* Resume: a preheat job left ``running`` whose ``url_meta`` carries a
  header, filtered query parameters and shards is resumed by both
  packages' ``JobRunner`` into the same task id and the same seed
  request bytes as the preheat that was never interrupted.
* Ports of ``tests/test_plugins_jobs.py::TestSyncPeers`` and
  ``::TestDurableJobs``, and of ``tests/test_manager.py::TestManagerE2E::
  test_discovery_preheat_download`` (the leecher with a CPU device sink)
  and ``::test_image_preheat_resolves_layers_with_token_auth`` (the
  stand-in above); a preheat whose manager stopped mid-job is resumed by
  a manager restarted on the same database and ports, joins the seed job
  still running, and the origin sends each byte once.
* ``chip_smoke.py`` phase 23 rehearsed on the CPU at a 16 MB weights file
  (the origin paced to 4 MB/s, so the seed's back-source outlasts the
  manager's restart) and a 4 MiB image layer, with every check of the
  phase.

Every test that starts servers runs under ``asyncio.wait_for`` with a
limit of its own.
"""

import asyncio
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import aiohttp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.common import ids as ref_ids
from dragonfly2_tpu.common.errors import DFError as RefDFError
from dragonfly2_tpu.idl import base as ref_base
import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.manager.jobs import JobRunner as RefJobRunner
from dragonfly2_tpu.manager.rest import RestAPI as RefRestAPI
from dragonfly2_tpu.manager.store import Store as RefStore
from dragonfly2_tpu_torch.common import ids
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl import base as port_base
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.manager import Manager, ManagerConfig
from dragonfly2_tpu_torch.manager.jobs import JobRunner
from dragonfly2_tpu_torch.manager.rest import RestAPI
from dragonfly2_tpu_torch.manager.store import Store
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.server import Scheduler

from conftest import run
from torch_origin import Origin
import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 60.0


def _limited(coro, limit: float = LIMIT_S):
    return run(asyncio.wait_for(coro, limit))


def _pkg(impl: str):
    return ref_msg if impl == "ref" else port_msg


def _meta(m, rng: np.random.Generator):
    """A seeded UrlMeta of package ``m`` with every nested field set."""
    n = int(rng.integers(1, 1 << 30))
    return m.UrlMeta(
        digest=f"sha256:{n:064x}", tag=f"tag-{n % 97}",
        range=f"bytes=0-{n % 4096}",
        filtered_query_params=["Signature", f"X-Exp-{n % 7}"],
        header={"X-Tenant": f"t{n % 5}", "Authorization": f"Bearer {n}"},
        application=f"app-{n % 3}", priority=m.Priority(int(n % 7)),
        tenant=f"tenant-{n % 11}", qos_class="bulk",
        shards="w0,w1")


# ---------------------------------------------------------------- codec

def _messages(m, seed: int) -> list:
    rng = np.random.default_rng(seed)
    hosts = [m.Host(id=f"h{i}", ip=f"10.0.0.{i}", hostname=f"host-{i}",
                    port=int(rng.integers(1, 65535)),
                    download_port=int(rng.integers(1, 65535)),
                    type=m.HostType(int(rng.integers(0, 3))))
             for i in range(int(rng.integers(1, 5)))]
    return [
        m.PreheatRequest(url=f"http://origin/f{seed}?Signature=x",
                         url_meta=_meta(m, rng),
                         wait=bool(rng.integers(0, 2))),
        m.PreheatResponse(task_id=f"{int(rng.integers(1 << 62)):064x}",
                          state=["pending", "running", "succeeded",
                                 "failed"][int(rng.integers(0, 4))],
                          content_length=int(rng.integers(-1, 1 << 40)),
                          total_piece_count=int(rng.integers(-1, 1 << 20))),
        m.SyncPeersRequest(cluster_id=int(rng.integers(0, 1 << 31))),
        m.SyncPeersResponse(hosts=hosts),
    ]


@pytest.mark.parametrize("index", range(4))
def test_codec_bytes_match_reference(index):
    for seed in range(8):
        ref = _messages(ref_msg, seed)[index]
        port = _messages(port_msg, seed)[index]
        raw = port_base.dumps(port)
        assert raw == ref_base.dumps(ref), type(port).__name__
        assert port_base.dumps(port_base.loads(raw)) == raw
        assert ref_base.dumps(ref_base.loads(raw)) == raw


# ---------------------------------------------------------------- store

def _write_jobs(store, rng: np.random.Generator) -> None:
    cid = store.create_scheduler_cluster("c1", is_default=True)
    store.create_scheduler_cluster("c2")
    for i in range(6):
        args = {"url": f"http://o/{i}", "cluster_id": int(rng.integers(3)),
                "type": "file", "platform": "",
                "url_meta": {"tag": f"t{i}", "header": {"A": str(i)}}}
        jid = store.create_job("preheat" if i % 2 else "sync_peers", args)
        state = ["pending", "running", "succeeded", "failed"][i % 4]
        if state != "pending":
            store.update_job(jid, state=state,
                             result={"addr": {"state": state,
                                              "n": int(rng.integers(99))}})
    current = store.cluster_config(cid)
    store.update_scheduler_cluster(cid, config=dataclasses.replace(
        current, candidate_parent_limit=int(rng.integers(1, 20)),
        peer_load_limit=int(rng.integers(1, 200))))
    store.update_scheduler_cluster(cid, scopes={"zones": ["z1", "z2"]})
    assert not store.update_scheduler_cluster(cid)
    assert not store.update_scheduler_cluster(99, scopes={})


def _read_jobs(store) -> dict:
    return {"jobs": store.jobs(),
            "by_state": {s: store.jobs(state=s)
                         for s in ("pending", "running", "succeeded",
                                   "failed")},
            "one": [store.job(i) for i in range(1, 8)],
            "config": dataclasses.asdict(store.cluster_config(1)),
            "clusters": store.scheduler_clusters()}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_job_rows_and_patched_config_read_back_in_the_other_package(
        tmp_path, writer):
    path = str(tmp_path / "m.db")
    w = RefStore(path) if writer == "reference" else Store(path)
    _write_jobs(w, np.random.default_rng(20))
    w.close()
    ref, port = RefStore(path), Store(path)
    try:
        got, want = _read_jobs(port), _read_jobs(ref)
        assert got == want
        assert got["one"][6] is None and len(got["jobs"]) == 6
        assert got["clusters"][0]["scopes"] == '{"zones": ["z1", "z2"]}'
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------- scheduler

class _StubSeed:
    """A seed client whose triggers follow a script: "ok" lands the whole
    task on a seed peer, "fail" returns having landed nothing, "hang"
    lands it once ``release`` is set. Each trigger's ObtainSeeds request
    is recorded as the real client would send it."""

    def __init__(self, m, script: list[str], seeds: bool = True):
        self.m = m
        self.script = list(script)
        self.seeds = seeds
        self.requests: list[bytes] = []
        self.release = asyncio.Event()
        self.resource = None

    def available(self) -> bool:
        return self.seeds

    def trigger(self, task, url_meta):
        """Counted when the service fires it, as its task is made."""
        m = self.m
        self.requests.append((m is ref_msg and ref_base or port_base).dumps(
            m.ObtainSeedsRequest(url=task.url, url_meta=url_meta,
                                 task_id=task.id)))
        return self._run(task, self.script.pop(0))

    async def _run(self, task, step: str) -> None:
        m = self.m
        if step == "fail":
            return
        if step == "hang":
            await self.release.wait()
        host = self.resource.store_host(m.Host(
            id="seed-h", ip="127.0.0.1", hostname="seed-h", port=1,
            download_port=2, type=m.HostType.SUPER_SEED))
        peer = self.resource.get_or_create_peer("seed-peer", task, host)
        task.set_content_info(4 << 20, 0, 1)
        info = m.PieceInfo(piece_num=0, range_start=0, range_size=4 << 20)
        task.record_piece(info)
        peer.finished_pieces.add(0)
        states = type(peer.state)
        peer.transit(states.RUNNING)
        peer.transit(states.SUCCEEDED)


def _service(impl: str, stub: _StubSeed):
    if impl == "ref":
        from dragonfly2_tpu.scheduler.config import SchedulerConfig as Cfg
        from dragonfly2_tpu.scheduler.evaluator import Evaluator
        from dragonfly2_tpu.scheduler.resource import Resource
        from dragonfly2_tpu.scheduler.scheduling import Scheduling
        from dragonfly2_tpu.scheduler.service import SchedulerService
        from dragonfly2_tpu.scheduler.topology_store import TopologyStore
        cfg = Cfg()
        res = Resource()
        svc = SchedulerService(cfg, res, Scheduling(cfg, Evaluator()),
                               stub, TopologyStore())
    else:
        from dragonfly2_tpu_torch.scheduler.evaluator import Evaluator
        from dragonfly2_tpu_torch.scheduler.resource import Resource
        from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
        from dragonfly2_tpu_torch.scheduler.service import SchedulerService
        from dragonfly2_tpu_torch.scheduler.topology_store import \
            TopologyStore
        res = Resource()
        cfg = SchedulerConfig()
        svc = SchedulerService(cfg, res, Scheduling(cfg, Evaluator()), stub,
                               TopologyStore())
    stub.resource = res
    return svc


def _preheat_script(impl: str, seed: int) -> dict:
    """One seeded sequence of Preheat calls through ``impl``'s service."""
    m = _pkg(impl)
    rng = np.random.default_rng(seed)
    meta = _meta(m, rng)
    url = f"http://origin.test/ckpt-{seed}.bin?X-Exp-{seed % 7}=1&b=2"
    out: dict = {"calls": []}

    async def main():
        # no seed: SCHED_FORBIDDEN, and no task is made
        svc = _service(impl, _StubSeed(m, [], seeds=False))
        try:
            await svc.preheat(m.PreheatRequest(url=url), None)
        except (DFError, RefDFError) as exc:
            out["forbidden"] = (int(exc.code), str(exc))
        out["forbidden_tasks"] = len(svc.resource.tasks)
        # a failed seed is re-triggered; a done one is not
        stub = _StubSeed(m, ["fail", "ok", "hang"])
        svc = _service(impl, stub)
        for req in (m.PreheatRequest(url=url, url_meta=meta),
                    m.PreheatRequest(url=url, url_meta=meta),
                    m.PreheatRequest(url=url, url_meta=meta, wait=False)):
            resp = await svc.preheat(req, None)
            out["calls"].append((resp.state, len(stub.requests),
                                 (ref_base if impl == "ref" else port_base)
                                 .dumps(resp)))
        # a running seed job is joined, not triggered again
        plain = f"http://origin.test/other-{seed}"
        for _ in range(2):
            resp = await svc.preheat(m.PreheatRequest(url=plain, wait=False),
                                     None)
            out["calls"].append((resp.state, len(stub.requests),
                                 resp.task_id))
        waiter = asyncio.get_running_loop().create_task(svc.preheat(
            m.PreheatRequest(url=plain, wait=True), None))
        await asyncio.sleep(0.05)
        assert not waiter.done()
        stub.release.set()
        resp = await waiter
        out["calls"].append((resp.state, len(stub.requests), resp.task_id))
        out["seed_requests"] = stub.requests
        out["task_ids"] = sorted(svc.resource.tasks)
        # sync_peers: every host the scheduler holds
        for i in range(int(rng.integers(1, 4))):
            svc.resource.store_host(m.Host(
                id=f"l{i}", ip=f"10.1.0.{i}", hostname=f"leech-{i}",
                port=10 + i, download_port=20 + i))
        resp = await svc.sync_peers(m.SyncPeersRequest(cluster_id=3), None)
        out["sync"] = (ref_base if impl == "ref" else port_base).dumps(resp)

    _limited(main(), 20)
    out["url"], out["meta"] = url, meta
    return out


@pytest.mark.parametrize("seed", range(3))
def test_preheat_and_sync_peers_answer_as_the_reference(seed):
    got, want = _preheat_script("port", seed), _preheat_script("ref", seed)
    for key in ("forbidden", "forbidden_tasks", "calls", "seed_requests",
                "task_ids", "sync"):
        assert got[key] == want[key], key
    assert got["forbidden"][0] == int(Code.SCHED_FORBIDDEN)
    assert got["forbidden_tasks"] == 0
    # fail -> re-trigger -> succeeded; the third preheat joins nothing
    assert [c[:2] for c in got["calls"][:3]] == [
        ("failed", 1), ("succeeded", 2), ("succeeded", 2)]
    assert [c[:2] for c in got["calls"][3:]] == [
        ("running", 3), ("running", 3), ("succeeded", 3)]
    # the task id is the one a register of the same URL and meta computes
    meta = got["meta"]
    want_id = ids.task_id(
        got["url"], tag=meta.tag, application=meta.application,
        digest=meta.digest, piece_range=meta.range,
        filtered_query_params=meta.filtered_query_params)
    assert port_base.loads(got["calls"][0][2]).task_id == want_id
    assert want_id == ref_ids.task_id(
        got["url"], tag=meta.tag, application=meta.application,
        digest=meta.digest, piece_range=meta.range,
        filtered_query_params=meta.filtered_query_params)


# ---------------------------------------------------------------- REST

def _untimed(obj):
    if isinstance(obj, list):
        return [_untimed(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items()
                if k not in ("created_at", "updated_at")}
    return obj


async def _terminal(store, ids_: list[int], limit: float = 10.0) -> None:
    for _ in range(int(limit / 0.05)):
        rows = [store.job(i) for i in ids_]
        if all(r["state"] in ("succeeded", "failed") for r in rows):
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"jobs not terminal: {rows}")


def _job_posts(rng: np.random.Generator) -> list:
    n = int(rng.integers(1, 1000))
    return [
        {"type": "sync_peers"},
        {"type": "sync_peers", "args": {"cluster_id": 1}},
        {"type": "preheat", "args": {"url": f"http://o.test/f{n}"}},
        {"type": "preheat", "args": {
            "url": f"http://o.test/g{n}", "cluster_id": 1,
            "url_meta": {"tag": f"t{n}", "header": {"X-A": "1"},
                         "filtered_query_params": ["sig"]}}},
        {"type": "preheat", "args": {"url": f"http://o.test/v2/x/blobs/{n}",
                                     "type": "image",
                                     "platform": "linux/amd64"}},
        {"type": "preheat", "args": {}},
        {"type": "preheat", "args": {"url": "http://o.test/f",
                                     "type": "bogus"}},
        {"type": "nope"},
        {},
    ]


PATCH_BODIES = [
    {"config": {"candidate_parent_limit": 7}},
    {"config": {"filter_parent_limit": "20"}},
    {"config": {"peer_load_limit": "junk"}},
    {"config": {"peer_load_limit": 1.5}},
    {"config": {"peer_load_limit": True}},
    {"config": {"bogus": 1}},
    {"config": 5},
    {},
    b"",
    b"not json",
    b"[1]",
    {"scopes": {"zones": ["z1"]}},
    {"config": {"job_rate_limit": 3}, "scopes": {"slices": ["s0"]}},
]


@pytest.mark.parametrize("seed", range(2))
def test_rest_jobs_and_cluster_patch_answer_as_the_reference(tmp_path, seed):
    rng = np.random.default_rng(40 + seed)
    ref_store = RefStore(str(tmp_path / "ref.db"))
    store = Store(str(tmp_path / "port.db"))
    for s in (ref_store, store):
        s.create_scheduler_cluster("c1", is_default=True)
        s.create_scheduler_cluster("c2")

    async def main():
        ref_jobs, jobs = RefJobRunner(ref_store), JobRunner(store)
        ref_api = RefRestAPI(ref_store, ref_jobs, host="127.0.0.1")
        api = RestAPI(store, jobs, host="127.0.0.1")
        await ref_api.start()
        await api.start()
        try:
            async with aiohttp.ClientSession() as http:
                async def call(port, method, route, body=None):
                    kw = ({"data": body} if isinstance(body, bytes)
                          else {"json": body} if body is not None else {})
                    async with http.request(
                            method, f"http://127.0.0.1:{port}{route}",
                            **kw) as r:
                        raw = await r.read()
                        try:
                            return r.status, json.loads(raw)
                        except ValueError:
                            return r.status, raw

                async def both(method, route, body=None):
                    return (await call(ref_api.port, method, route, body),
                            await call(api.port, method, route, body))

                created = []
                for body in _job_posts(rng):
                    want, got = await both("POST", "/api/v1/jobs", body)
                    assert got == want, body
                    if got[0] == 201:
                        created.append(got[1]["id"])
                assert created == [1, 2, 3, 4, 5]
                await _terminal(ref_store, created)
                await _terminal(store, created)
                for route in ["/api/v1/jobs",
                              *[f"/api/v1/jobs/{i}" for i in created],
                              "/api/v1/jobs/99"]:
                    want, got = await both("GET", route)
                    assert got[0] == want[0] and \
                        _untimed(got[1]) == _untimed(want[1]), route
                # no scheduler is registered: every job fails alike
                listed = (await call(api.port, "GET", "/api/v1/jobs"))[1]
                assert [j["state"] for j in listed] == ["failed"] * 5
                image = (await call(api.port, "GET", "/api/v1/jobs/5"))[1]
                assert image["result"]["error"].startswith(
                    "image resolution failed: not a manifest reference")
                # a method not routed on a known path, an unknown path
                for method, route in (("DELETE", "/api/v1/jobs/1"),
                                      ("PUT", "/api/v1/jobs"),
                                      ("GET", "/api/v1/scheduler-clusters/1"),
                                      ("GET", "/api/v1/schedulers/1"),
                                      ("GET", "/api/v1/jobs/1/x")):
                    want, got = await both(method, route)
                    assert got[0] == want[0] in (404, 405), (method, route)

                cfg = {"candidate_parent_limit": int(rng.integers(1, 9))}
                for body in [{"config": cfg}, *PATCH_BODIES]:
                    for cid in (1, 2, 99):
                        want, got = await both(
                            "PATCH", f"/api/v1/scheduler-clusters/{cid}",
                            body)
                        assert got == want, (cid, body)
                want, got = await both("GET", "/api/v1/scheduler-clusters")
                assert _untimed(got[1]) == _untimed(want[1])
                c1 = json.loads(got[1][0]["config"])
                assert c1["candidate_parent_limit"] == 7
                assert c1["filter_parent_limit"] == 20
                assert c1["job_rate_limit"] == 3
                assert json.loads(got[1][0]["scopes"]) == {"slices": ["s0"]}

                # known difference 8: the reference's 500s are 400 here
                for method, route, body in (
                        ("GET", "/api/v1/jobs/abc", None),
                        ("PATCH", "/api/v1/scheduler-clusters/abc",
                         {"config": {"job_rate_limit": 1}}),
                        ("POST", "/api/v1/jobs",
                         {"type": "preheat", "args": {
                             "url": "http://o.test/f",
                             "url_meta": {"bogus_key": 1}}}),
                        ("POST", "/api/v1/jobs",
                         {"type": "sync_peers", "args": [1]}),
                        ("POST", "/api/v1/jobs", b"[]")):
                    want, got = await both(method, route, body)
                    assert (want[0], got[0]) == (500, 400), (route, body)
                    assert "error" in got[1]
                assert len(store.jobs()) == len(created)
        finally:
            await api.stop()
            await ref_api.stop()
            await jobs.close()
            await ref_jobs.close()

    try:
        _limited(main())
    finally:
        ref_store.close()
        store.close()


# ---------------------------------------------------------------- registry

TOKEN = "reg-tok-42"


def _dg(b: bytes) -> str:
    return "sha256:" + hashlib.sha256(b).hexdigest()


class Registry:
    """An OCI registry stand-in on the standard library: every manifest
    and blob request must carry ``Bearer <TOKEN>`` (else a 401 with a
    Bearer challenge whose realm is its ``/token``, which asks for
    ``service``); ``/v2/img/manifests/v1`` is a manifest list of
    ``linux/amd64`` and ``linux/arm64``, each a config and layers. It
    counts token grants and blob body bytes per digest. ``ctype_name``
    is the name it sends its ``Content-Type`` under, ``list_type`` false
    leaves the list's ``mediaType`` out of its body, and ``mislabeled``
    answers ``v1`` with the amd64 manifest under the list's type (a
    client that missed the header under a casing would read it as a
    manifest)."""

    def __init__(self, layers: dict[str, bytes], *,
                 ctype_name: str = "Content-Type", list_type: bool = True,
                 mislabeled: bool = False):
        self.layers = layers
        self.ctype_name = ctype_name
        cfg = json.dumps({"arch": "amd64"}).encode()
        self.cfg = cfg
        self.blobs = {_dg(b): b for b in (*layers.values(), cfg)}
        man_amd = json.dumps({
            "schemaVersion": 2,
            "config": {"digest": _dg(cfg), "size": len(cfg)},
            "layers": [{"digest": _dg(layers["amd-l1"])},
                       {"digest": _dg(layers["amd-l2"])},
                       {"digest": _dg(layers["amd-l1"])}]}).encode()
        man_arm = json.dumps({
            "schemaVersion": 2,
            "config": {"digest": _dg(cfg), "size": len(cfg)},
            "layers": [{"digest": _dg(layers["arm-l1"])}]}).encode()
        self.manifests = {_dg(man_amd): man_amd, _dg(man_arm): man_arm}
        index = {"schemaVersion": 2, "manifests": [
            {"digest": _dg(man_amd),
             "platform": {"os": "linux", "architecture": "amd64"}},
            {"digest": _dg(man_arm),
             "platform": {"os": "linux", "architecture": "arm64"}}]}
        if list_type:
            index["mediaType"] = ("application/vnd.docker.distribution."
                                  "manifest.list.v2+json")
        # mislabeled: the amd64 manifest itself under the list's type
        self.index = man_amd if mislabeled else json.dumps(index).encode()
        self.tokens = 0
        self.served = {d: 0 for d in self.blobs}
        self.lock = threading.Lock()
        self._server = None

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def __enter__(self) -> "Registry":
        reg = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _send(self, status: int, body: bytes = b"",
                      headers: dict | None = None) -> None:
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                path, _, query = self.path.partition("?")
                if path == "/token":
                    if "service=reg.test" not in query:
                        self._send(400)
                        return
                    with reg.lock:
                        reg.tokens += 1
                    self._send(200, json.dumps({"token": TOKEN}).encode(),
                               {"Content-Type": "application/json"})
                    return
                if self.headers.get("Authorization") != f"Bearer {TOKEN}":
                    realm = f"{reg.base}/token"
                    self._send(401, headers={"WWW-Authenticate":
                               f'Bearer realm="{realm}",service="reg.test",'
                               f'scope="repository:img:pull"'})
                    return
                m = re.match(r"/v2/img/(manifests|blobs)/([^/]+)$", path)
                if m is None:
                    self._send(404)
                elif m.group(1) == "manifests":
                    ref = m.group(2)
                    if ref == "v1":
                        self._send(200, reg.index, {
                            reg.ctype_name: "application/vnd.docker."
                            "distribution.manifest.list.v2+json"})
                    elif ref in reg.manifests:
                        self._send(200, reg.manifests[ref], {
                            reg.ctype_name: "application/vnd.docker."
                            "distribution.manifest.v2+json"})
                    else:
                        self._send(404)
                elif m.group(2) in reg.blobs:
                    data = reg.blobs[m.group(2)]
                    start, end, status = 0, len(data), 200
                    rm = re.match(r"bytes=(\d+)-(\d*)$",
                                  self.headers.get("Range", ""))
                    hdrs = {"Accept-Ranges": "bytes"}
                    if rm:
                        start = int(rm.group(1))
                        end = min(len(data), int(rm.group(2)) + 1
                                  if rm.group(2) else len(data))
                        status = 206
                        hdrs["Content-Range"] = \
                            f"bytes {start}-{end - 1}/{len(data)}"
                    with reg.lock:
                        reg.served[m.group(2)] += end - start
                    self._send(status, data[start:end], hdrs)
                else:
                    self._send(404)

            def do_HEAD(self) -> None:
                path = self.path.partition("?")[0]
                m = re.match(r"/v2/img/blobs/([^/]+)$", path)
                if (self.headers.get("Authorization") != f"Bearer {TOKEN}"
                        or m is None or m.group(1) not in reg.blobs):
                    self.send_response(401 if m else 404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Accept-Ranges", "bytes")
                self.send_header("Content-Length",
                                 str(len(reg.blobs[m.group(1)])))
                self.end_headers()

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()


def _layers(seed: int) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for name, n in (("amd-l1", 1 << 20), ("amd-l2", 700_001),
                            ("arm-l1", 1 << 20))}


@pytest.mark.parametrize("ctype_name,list_type,platform,mislabeled", [
    ("Content-Type", True, "linux/amd64", False),
    ("content-type", True, "linux/amd64", False),
    ("content-type", False, "linux/arm64", False),
    ("Content-Type", False, "", False),
    ("Content-Type", True, "linux/amd64", True),
    ("content-type", True, "linux/amd64", True),
])
def test_image_resolution_equals_the_references(ctype_name, list_type,
                                                platform, mislabeled):
    with Registry(_layers(7), ctype_name=ctype_name, list_type=list_type,
                  mislabeled=mislabeled) as reg:
        url = f"{reg.base}/v2/img/manifests/v1"

        async def main():
            ref, port = RefJobRunner(RefStore()), JobRunner(Store())
            try:
                want = await ref._resolve_image_layers(url, None, platform)
                got = await port._resolve_image_layers(url, None, platform)
                return want, got
            finally:
                await ref.close()
                await port.close()

        want, got = _limited(main(), 20)
        assert got == want
        blobs, auth = got
        assert auth == {"Authorization": f"Bearer {TOKEN}"}
        assert reg.tokens == 2              # one dance per package
        amd = [_dg(reg.cfg), _dg(reg.layers["amd-l1"]),
               _dg(reg.layers["amd-l2"])]
        arm = [_dg(reg.layers["arm-l1"])]
        names = [b.rsplit("/", 1)[1] for b in blobs]
        if mislabeled:
            # the header's list type wins under either casing (aiohttp
            # names the headers it knows canonically), and the body has no
            # list entry
            assert names == []
        else:
            assert names == {"linux/amd64": amd,
                             "linux/arm64": [amd[0], *arm],
                             "": amd + arm}[platform]
        assert not any(reg.served.values())


# ---------------------------------------------------------------- resume

async def _resumed_seed_request(impl: str, tmp_path, meta_fields: dict,
                                url: str, interrupted: bool):
    """A preheat job through ``impl``'s JobRunner and a scheduler RPC
    server whose seed client is a stub: submitted at once, or written as
    a job a dead manager left running (its ``url_meta`` through JSON) and
    resumed. Returns the job row and the stub's ObtainSeeds bytes."""
    m = _pkg(impl)
    meta = m.UrlMeta(**meta_fields)
    if impl == "ref":
        from dragonfly2_tpu.rpc.server import RPCServer
        from dragonfly2_tpu.scheduler.service import build_service
        store = RefStore(str(tmp_path / f"{impl}-{interrupted}.db"))
        runner_cls = RefJobRunner
    else:
        from dragonfly2_tpu_torch.rpc.server import RPCServer
        from dragonfly2_tpu_torch.scheduler.service import build_service
        store = Store(str(tmp_path / f"{impl}-{interrupted}.db"))
        runner_cls = JobRunner
    stub = _StubSeed(m, ["ok"])
    svc = _service(impl, stub)
    rpc = RPCServer("127.0.0.1:0")
    rpc.register(build_service(svc))
    await rpc.start()
    runner = runner_cls(store)
    try:
        cid = store.create_scheduler_cluster("c", is_default=True)
        store.upsert_scheduler(hostname="s", ip="127.0.0.1", port=rpc.port,
                               cluster_id=cid)
        if interrupted:
            jid = store.create_job("preheat", {
                "url": url, "cluster_id": None, "type": "file",
                "platform": "", "url_meta": json.loads(json.dumps(
                    dataclasses.asdict(meta)))})
            store.update_job(jid, state="running")
            assert await runner.resume_interrupted() == 1
        else:
            jid = await runner.submit_preheat(url=url, url_meta=meta)
        await _terminal(store, [jid])
        job = store.job(jid)
        job["result"] = json.loads(job["result"])
        return job, stub.requests
    finally:
        await runner.close()
        await rpc.stop(0.5)
        store.close()


def test_a_resumed_preheat_keeps_its_task_id_and_seed_request(tmp_path):
    meta = dataclasses.asdict(_meta(port_msg, np.random.default_rng(11)))
    meta["priority"] = int(meta["priority"])
    url = "http://origin.test/ckpt.bin?Signature=s&X-Exp-3=9&z=1"

    async def main():
        out = {}
        for impl in ("ref", "port"):
            for interrupted in (False, True):
                out[impl, interrupted] = await _resumed_seed_request(
                    impl, tmp_path, meta, url, interrupted)
        return out

    out = _limited(main())
    want_id = ids.task_id(
        url, tag=meta["tag"], application=meta["application"],
        digest=meta["digest"], piece_range=meta["range"],
        filtered_query_params=meta["filtered_query_params"])
    requests = set()
    for (impl, interrupted), (job, reqs) in out.items():
        assert job["state"] == "succeeded", (impl, interrupted, job)
        (entry,) = job["result"].values()
        assert entry["task_id"] == want_id, (impl, interrupted)
        assert len(reqs) == 1
        requests.add(reqs[0])
    # one request's bytes, header, filtered params and shards included
    assert len(requests) == 1
    sent = port_base.loads(requests.pop())
    assert sent.url_meta.header == meta["header"]
    assert sent.url_meta.shards == "w0,w1"


# ---------------------------------------------------------------- pods

def _cfg(tmp_path, name: str, **kw) -> DaemonConfig:
    return DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                        host_ip="127.0.0.1", listen_ip="127.0.0.1",
                        device="cpu", **kw)


async def _rest(port: int, method: str, route: str, body=None):
    async with aiohttp.ClientSession() as http:
        async with http.request(method, f"http://127.0.0.1:{port}{route}",
                                json=body) as r:
            return r.status, await r.json()


async def _wait_job(rest_port: int, job_id: int, limit: float = 30.0) -> dict:
    for _ in range(int(limit / 0.1)):
        _, job = await _rest(rest_port, "GET", f"/api/v1/jobs/{job_id}")
        if job["state"] in ("succeeded", "failed"):
            return job
        await asyncio.sleep(0.1)
    raise AssertionError(f"job {job_id} not terminal: {job}")


def test_sync_peers_job_aggregates_live_hosts(tmp_path):
    """Port of ``TestSyncPeers``: manager job -> scheduler SyncPeers RPC ->
    the hosts in the job's result."""
    async def main():
        from dragonfly2_tpu_torch.idl.messages import Host, HostType
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    workdir=str(tmp_path)))
        await mgr.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", advertise_ip="127.0.0.1",
            manager_addresses=[mgr.address]))
        await sched.start()
        try:
            for name in ("h-a", "h-b"):
                sched.resource.store_host(Host(
                    id=name, ip="127.0.0.1", hostname=name, port=1,
                    download_port=2, type=HostType.NORMAL))
            status, body = await _rest(mgr.rest.port, "POST", "/api/v1/jobs",
                                       {"type": "sync_peers"})
            assert status == 201
            job = await _wait_job(mgr.rest.port, body["id"])
            assert job["state"] == "succeeded", job
            hosts = next(iter(job["result"].values()))["hosts"]
            assert {h["id"] for h in hosts} >= {"h-a", "h-b"}
        finally:
            await sched.stop()
            await mgr.stop()

    _limited(main())


def test_interrupted_job_resumes_on_restart(tmp_path):
    """Port of ``TestDurableJobs``: a job a dead manager left 'running' is
    dispatched again when a manager boots on the same database; with no
    scheduler it fails, a terminal state, not stuck."""
    async def main():
        db = str(tmp_path / "m.db")
        store = Store(db)
        jid = store.create_job("sync_peers", {})
        store.update_job(jid, state="running")
        odd = store.create_job("mystery", {})
        store.close()
        m = Manager(ManagerConfig(listen_ip="127.0.0.1", db_path=db,
                                  workdir=str(tmp_path)))
        await m.start()
        try:
            for _ in range(100):
                job = m.store.job(jid)
                if job["state"] in ("succeeded", "failed"):
                    break
                await asyncio.sleep(0.05)
            assert job["state"] == "failed", job
            assert json.loads(job["result"]) == {
                "error": "no active schedulers"}
            assert m.store.job(odd)["state"] == "failed"
            assert json.loads(m.store.job(odd)["result"]) == {
                "error": "unresumable job type='mystery'"}
        finally:
            await m.stop()

    _limited(main())


async def _pod(tmp_path, mgr: Manager):
    seed = Daemon(_cfg(tmp_path, "seedM", is_seed=True,
                       manager_addresses=[mgr.address]))
    await seed.start()
    assert mgr.store.seed_peers(only_active=True)
    sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                      manager_addresses=[mgr.address]))
    await sched.start()
    assert mgr.store.schedulers(only_active=True)
    assert sched.seed_client.available()
    return seed, sched


async def _sink_pull(leech: Daemon, url: str) -> tuple:
    """A pull with back-source disabled into a CPU device sink: its task
    id, its conductor and the sink's bytes."""
    task_id = None
    async for r in leech.ptm.start_file_task(port_msg.DownloadRequest(
            url=url, disable_back_source=True, timeout_s=30,
            device_sink=port_msg.DeviceSink(enabled=True))):
        task_id = r.task_id or task_id
    c = leech.ptm.conductor(task_id)
    out = await asyncio.to_thread(c.device_ingest.result, 30)
    flat = b"".join(t.numpy().tobytes() for t in out)
    return task_id, c, flat[:c.content_length]


def test_discovery_preheat_download(tmp_path):
    """Port of ``test_discovery_preheat_download``: the seed and the
    scheduler register with the manager, a REST preheat warms the seed,
    and a leecher that knows only the manager pulls into a CPU device
    sink with the origin gone."""
    data = np.random.default_rng(21).integers(
        0, 256, 3 << 20, dtype=np.uint8).tobytes()

    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1"))
        await mgr.start()
        origin = Origin({"w.bin": data}).__enter__()
        url = f"{origin.base}/w.bin"
        seed, sched = await _pod(tmp_path, mgr)
        leech = None
        try:
            status, body = await _rest(mgr.rest.port, "POST", "/api/v1/jobs",
                                       {"type": "preheat",
                                        "args": {"url": url}})
            assert status == 201
            job = await _wait_job(mgr.rest.port, body["id"])
            assert job["state"] == "succeeded", job
            (entry,) = job["result"].values()
            origin.__exit__(None, None, None)
            origin = None
            leech = Daemon(_cfg(tmp_path, "leechM",
                                manager_addresses=[mgr.address]))
            await leech.start()
            task_id, c, got = await _sink_pull(leech, url)
            assert entry["task_id"] == task_id
            assert got == data
            assert c.traffic_source == 0 and c.traffic_p2p == len(data)
        finally:
            if origin is not None:
                origin.__exit__(None, None, None)
            if leech is not None:
                await leech.stop()
            await sched.stop()
            await seed.stop()
            await mgr.stop()

    _limited(main())


def test_image_preheat_resolves_layers_with_token_auth(tmp_path):
    """Port of ``test_image_preheat_resolves_layers_with_token_auth``: a
    REST preheat of type image against the token-auth stand-in resolves
    the manifest list, filters by platform and warms every config and
    layer blob of linux/amd64 into the seed, the seed's fetches riding
    the token the manager's dance won; no arm64 byte leaves the stand-in."""
    with Registry(_layers(8)) as reg:
        async def main():
            mgr = Manager(ManagerConfig(listen_ip="127.0.0.1"))
            await mgr.start()
            seed, sched = await _pod(tmp_path, mgr)
            try:
                status, body = await _rest(
                    mgr.rest.port, "POST", "/api/v1/jobs",
                    {"type": "preheat", "args": {
                        "url": f"{reg.base}/v2/img/manifests/v1",
                        "type": "image", "platform": "linux/amd64"}})
                assert status == 201
                job = await _wait_job(mgr.rest.port, body["id"])
                assert job["state"] == "succeeded", job
                stored = {ts.md.url.rsplit("/", 1)[-1]
                          for ts in seed.storage_mgr.tasks() if ts.md.done}
                return job, stored
            finally:
                await sched.stop()
                await seed.stop()
                await mgr.stop()

        job, stored = _limited(main())
        amd = {_dg(reg.cfg), _dg(reg.layers["amd-l1"]),
               _dg(reg.layers["amd-l2"])}
        (entry,) = job["result"].values()
        assert entry["state"] == "succeeded"
        assert {b["url"].rsplit("/", 1)[-1] for b in entry["blobs"]} == amd
        assert len(entry["blobs"]) == 3
        assert stored == amd
        assert reg.tokens == 1
        assert reg.served[_dg(reg.layers["arm-l1"])] == 0
        for d in amd:
            assert reg.served[d] == len(reg.blobs[d]), d


def test_a_preheat_survives_its_managers_stop(tmp_path):
    """A preheat whose manager stops while the seed's back-source is under
    way: the job stays ``running`` in the database; a manager restarted
    on the same database and ports resumes it, the re-dispatched Preheat
    joins the seed job still running (one trigger), the job succeeds with
    the task id a pull computes, and the origin sends each byte once."""
    data = np.random.default_rng(23).integers(
        0, 256, 6 << 20, dtype=np.uint8).tobytes()
    db = str(tmp_path / "m.db")

    async def main():
        cfg = ManagerConfig(listen_ip="127.0.0.1", db_path=db)
        mgr = Manager(cfg)
        await mgr.start()
        cfg.grpc_port, cfg.rest_port = mgr.port, mgr.rest.port
        with Origin({"w.bin": data}, pace_bps=1 << 20,
                    chunk=128 << 10) as origin:
            url = f"{origin.base}/w.bin"
            seed, sched = await _pod(tmp_path, mgr)
            leech = None
            try:
                status, body = await _rest(
                    mgr.rest.port, "POST", "/api/v1/jobs",
                    {"type": "preheat", "args": {"url": url}})
                assert status == 201
                jid = body["id"]
                task_id = ids.task_id(url)
                for _ in range(200):
                    task = sched.resource.tasks.get(task_id)
                    if (origin.body_bytes > 0 and task is not None
                            and task.seed_job is not None):
                        break
                    await asyncio.sleep(0.02)
                await mgr.stop()
                assert not task.seed_job.done()
                row = Store(db)
                try:
                    assert row.job(jid)["state"] == "running"
                finally:
                    row.close()
                mgr = Manager(cfg)
                await mgr.start()
                job = await _wait_job(mgr.rest.port, jid)
                assert job["state"] == "succeeded", job
                (entry,) = job["result"].values()
                assert entry["task_id"] == task_id
                assert task.seed_retries == 0
                assert origin.body_bytes == len(data)
                leech = Daemon(_cfg(tmp_path, "leechR",
                                    manager_addresses=[mgr.address]))
                await leech.start()
                pulled, c, got = await _sink_pull(leech, url)
                assert pulled == task_id and got == data
                assert c.traffic_source == 0
                assert origin.body_bytes == len(data)
            finally:
                if leech is not None:
                    await leech.stop()
                await sched.stop()
                await seed.stop()
                await mgr.stop()

    _limited(main())


# ---------------------------------------------------------------- phase 23

def test_phase_23_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_preheat`` at a 16 MB weights file with CPU
    sinks: the manager, seed and scheduler from their launchers, the
    manager SIGKILLed during the seed's back-source and restarted, L's
    pull with the origin gone, the image job, sync_peers and the PATCHes
    through a Dynconfig, with every check of the phase."""
    real_run = subprocess.run

    def fake_run(args, *a, **kw):
        if args and args[0] == "nvidia-smi":
            return subprocess.CompletedProcess(args, 0,
                                               "CPU rehearsal, 0 W\n", "")
        return real_run(args, *a, **kw)

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    monkeypatch.setitem(chip_smoke.LLAMA3_8B, "vocab", 2000)
    monkeypatch.setattr(chip_smoke, "CHAIN_PACE_BPS", 4_000_000)
    monkeypatch.setattr(chip_smoke, "PREHEAT_LAYER_BYTES", 4 << 20)
    monkeypatch.setattr(chip_smoke, "PREHEAT_ARM_BYTES", 1 << 20)
    monkeypatch.setattr(sys, "path", [ROOT, *sys.path])
    os.makedirs(tmp_path / "deploy")
    header, nbytes = chip_smoke.safetensors_header(chip_smoke.deploy_layout())
    with open(tmp_path / "deploy" / chip_smoke.TREE_WEIGHTS, "wb") as f:
        f.write(header)
        f.write(memoryview(chip_smoke.seeded_bytes(
            np.random.default_rng(0), nbytes)))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit",
                        lambda phase, rec: lines.append((phase, rec)))
    chip_smoke.phase_preheat(str(tmp_path), torch.device("cpu"))
    (phase, rec), = lines
    assert phase == "phase 23 preheat"
    assert rec["origin_bytes"] == rec["file_bytes"] == len(header) + nbytes
    assert rec["resumed_before_seed_done_s"] > 0
    assert rec["image_blobs"] == 2 and rec["standin"]["grants"] == 1
    assert list(rec["dynconfig"]["seen"][-1]) == [7, 20]
    assert rec["return_codes"] == {"manager": -9, "manager-restarted": 0,
                                   "scheduler": 0, "seed": 0}
    assert not os.path.exists(tmp_path / "preheat")
