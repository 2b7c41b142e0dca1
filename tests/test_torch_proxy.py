"""The registry mirror proxy against the reference's, through both packages.

Each case runs the same inputs through a reference daemon and a port
daemon (``pkg``), with the same standard-library stand-ins and clients:
``chip_smoke.RegistryStandIn`` (a TLS v2 registry with a bearer token,
counting body bytes per digest and manifest hits), ``torch_origin.Origin``
(plain HTTP) and ``chip_smoke.OCIClient`` (a containerd-shaped puller on
``http.client``).

* The reference's suites: ``TestHTTPSInterception`` (a CONNECT MITM'd onto
  the mesh; the SNI listener minting for the ClientHello's name),
  ``tests/test_aux.py::TestProxy`` (P2P and direct routes, the mirror
  rewrite), ``TestOCIPullThroughMesh`` (two hijacking daemons, then a
  mirror-mode daemon, origin bytes per layer) and ``TestProxyConcurrency``
  (100/200, 200/400 and 500/1000 clients, byte-identical bodies).
* The port's own: ``use_p2p`` and ``_resolve_url`` equal the reference's
  over seeded tables of URLs, rules and headers; a direct-route 307 and a
  401 with repeated ``WWW-Authenticate`` and ``Set-Cookie`` lines passed
  through as received; a caller's ``Accept`` and ``User-Agent`` sent
  once; a shed GET answered 429 with ``Retry-After`` and
  ``X-Retry-After-Ms``; a CONNECT that no hijack rule matches, and one
  with hijack off, each a blind tunnel; the port's ``stop`` with an idle
  client connection open; a CPU rehearsal of ``chip_smoke.py`` phase 20.
* ``test_stream_survives_parent_death`` (``tests/test_churn.py``'s, on the
  port's launchers): ``slow``, as its reference is.

Tolerances are exact: bodies are compared byte for byte.
"""

import asyncio
import hashlib
import http.client
import json
import os
import random
import signal
import socket
import ssl
import subprocess
import sys
import threading
import time
import types
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from dragonfly2_tpu.common import cryptoshim as ref_shim

if not ref_shim.install():
    pytest.skip("no openssl binary", allow_module_level=True)

import dragonfly2_tpu.daemon.config as ref_cfg  # noqa: E402
from dragonfly2_tpu.common.metrics import REGISTRY as REF_REGISTRY  # noqa
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon  # noqa: E402
from dragonfly2_tpu.daemon.proxy import ProxyServer as RefProxy  # noqa
from dragonfly2_tpu.daemon.qos import QosSection as RefQos  # noqa: E402
from dragonfly2_tpu.idl.messages import UrlMeta as RefUrlMeta  # noqa
from dragonfly2_tpu.scheduler import Scheduler as RefScheduler  # noqa
from dragonfly2_tpu.scheduler import SchedulerConfig as RefSchedCfg  # noqa

import chip_smoke  # noqa: E402
import dragonfly2_tpu_torch.daemon.config as port_cfg  # noqa: E402
from chip_smoke import (MEDIA_MANIFEST, OCIClient,  # noqa: E402
                        RegistryStandIn, oci_digest, oci_manifest,
                        peer_sources)
from dragonfly2_tpu_torch.common.metrics import REGISTRY as PORT_REGISTRY
from dragonfly2_tpu_torch.daemon.daemon import Daemon as PortDaemon
from dragonfly2_tpu_torch.daemon.proxy import ProxyServer as PortProxy
from dragonfly2_tpu_torch.idl.messages import UrlMeta as PortUrlMeta
from dragonfly2_tpu_torch.scheduler.config import \
    SchedulerConfig as PortSchedCfg
from dragonfly2_tpu_torch.scheduler.server import Scheduler as PortScheduler
from torch_origin import Origin  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20
PKG = {
    "reference": types.SimpleNamespace(
        cfg=ref_cfg, Daemon=RefDaemon, Proxy=RefProxy, UrlMeta=RefUrlMeta,
        Qos=RefQos, registry=REF_REGISTRY, extra={},
        scheduler=lambda: RefScheduler(RefSchedCfg())),
    "port": types.SimpleNamespace(
        cfg=port_cfg, Daemon=PortDaemon, Proxy=PortProxy,
        UrlMeta=PortUrlMeta, Qos=port_cfg.QosSection,
        registry=PORT_REGISTRY, extra={"device": "cpu"},
        scheduler=lambda: PortScheduler(PortSchedCfg(listen_ip="127.0.0.1"))),
}
PKGS = sorted(PKG)


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def make_daemon(pkg: str, tmp_path, name: str, *, proxy: dict,
                source_ca: str = "", sched: str = "", qos: dict | None = None):
    p = PKG[pkg]
    kw = dict(workdir=str(tmp_path / f"{pkg}-{name}"), host_ip="127.0.0.1",
              listen_ip="127.0.0.1", hostname=name,
              storage=p.cfg.StorageSection(gc_interval_s=3600),
              download=p.cfg.DownloadConfig(source_ca=source_ca),
              proxy=p.cfg.ProxyConfig(**proxy), **p.extra)
    if sched:
        kw["scheduler"] = p.cfg.SchedulerConfig(addresses=[sched])
    if qos:
        kw["qos"] = p.Qos(**qos)
    return p.Daemon(p.cfg.DaemonConfig(**kw))


def counters(pkg: str) -> dict:
    reqs = PKG[pkg].registry.counter("df_proxy_requests_total",
                                     labels=("route",))
    return {r: reqs.value(r)
            for r in ("hijack", "tunnel", "p2p", "shed", "direct")}


class Registry:
    """``RegistryStandIn`` on a thread of the test process, its blobs
    written under ``tmp_path``."""

    def __init__(self, tmp_path, blobs: dict[str, bytes],
                 manifest: bytes = b"{}"):
        d = tmp_path / "registry-blobs"
        d.mkdir(exist_ok=True)
        paths = {}
        for digest, data in blobs.items():
            paths[digest] = str(d / digest[7:])
            with open(paths[digest], "wb") as f:
                f.write(data)
        self.reg = RegistryStandIn(str(tmp_path / "registry"), paths,
                                   manifest)

    def __enter__(self):
        self.port = self.reg.start()
        self.url = f"https://127.0.0.1:{self.port}"
        return self

    def __exit__(self, *exc):
        self.reg.stop()

    def served(self, digest: str) -> int:
        return self.reg.stats()["served"][digest]


def fetch(client: OCIClient, path: str, headers: dict | None = None):
    """One GET through ``client``: (status, body, peer SANs)."""
    try:
        resp = client.request(path, headers)
        return resp.status, resp.read(), client.peer_sans
    finally:
        client.close()


# ------------------------------------- the reference's TestHTTPSInterception

@pytest.mark.parametrize("pkg", PKGS)
def test_connect_is_mitmed_and_rides_the_mesh(tmp_path, pkg):
    """The client trusts only the daemon's CA (a blind tunnel would show
    the registry's own leaf and fail); the blob lands in the piece store,
    so a second pull leaves the registry untouched."""
    blob = _bytes(6 * MiB, 1)
    digest = oci_digest(blob)
    with Registry(tmp_path, {digest: blob}) as reg:
        async def main():
            d = make_daemon(pkg, tmp_path, "proxyd", source_ca=reg.reg.ca_path,
                            proxy={"enabled": True, "hijack": True})
            await d.start()
            out = []
            try:
                for _ in range(2):
                    client = OCIClient(
                        "connect", ("127.0.0.1", d.proxy_server.port),
                        reg.url, ca=d.proxy_server.ca_cert_path)
                    status, body, sans = await asyncio.to_thread(
                        fetch, client, f"/v2/repo/blobs/{digest}")
                    out.append((status, oci_digest(body), sans,
                                reg.served(digest)))
            finally:
                await d.stop()
            return out

        got = asyncio.run(asyncio.wait_for(main(), 120))
    assert got == [(200, digest, [["127.0.0.1"]], len(blob))] * 2


@pytest.mark.parametrize("pkg", PKGS)
def test_sni_listener_mints_for_client_hello_name(tmp_path, pkg):
    blob = _bytes(6 * MiB, 2)
    digest = oci_digest(blob)
    with Registry(tmp_path, {digest: blob}) as reg:
        async def main():
            d = make_daemon(pkg, tmp_path, "proxyd", source_ca=reg.reg.ca_path,
                            proxy={"enabled": True, "hijack": True,
                                   "sni_port": -1})
            await d.start()
            try:
                assert d.proxy_server.sni_port > 0
                client = OCIClient(
                    "sni", ("127.0.0.1", d.proxy_server.sni_port), reg.url,
                    ca=d.proxy_server.ca_cert_path, sni="registry.test")
                return await asyncio.to_thread(
                    fetch, client, f"/v2/repo/blobs/{digest}")
            finally:
                await d.stop()

        status, body, sans = asyncio.run(asyncio.wait_for(main(), 120))
    assert (status, oci_digest(body)) == (200, digest)
    assert sans == [["registry.test"]]       # minted for the SNI name


def _sni_handshake(port: int, ca: str, name: str, *,
                   check_name: bool = True) -> dict:
    """A TLS handshake with the SNI listener that sends ``name`` and
    trusts only ``ca``; the leaf it verified."""
    ctx = ssl.create_default_context(cafile=ca)
    ctx.check_hostname = check_name
    with socket.create_connection(("127.0.0.1", port), timeout=30) as raw:
        with ctx.wrap_socket(raw, server_hostname=name) as tls:
            return tls.getpeercert()


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name", ["$ENV::DF_SNI_SECRET",
                                  "a.test,DNS:evil.test"])
def test_an_sni_name_that_is_no_host_gets_no_leaf(tmp_path, pkg, name,
                                                   monkeypatch):
    """OpenSSL's config parser would expand ``$ENV::NAME`` and a comma
    would add a SAN: the port refuses the handshake before anything is
    minted; the reference mints the name as given. No SAN carries the
    variable's value."""
    monkeypatch.setenv("DF_SNI_SECRET", "s3cr3t-value")

    async def main():
        d = make_daemon(pkg, tmp_path, "snid",
                        proxy={"enabled": True, "hijack": True,
                               "sni_port": -1})
        await d.start()
        issuer = d.proxy_server._issuer
        mints = []
        real = issuer._mint
        monkeypatch.setattr(issuer, "_mint",
                            lambda host: mints.append(host) or real(host))
        try:
            return await asyncio.to_thread(
                _sni_handshake, d.proxy_server.sni_port,
                d.proxy_server.ca_cert_path, name, check_name=False), mints
        except ssl.SSLError as exc:
            return exc, mints
        finally:
            await d.stop()

    got, mints = asyncio.run(asyncio.wait_for(main(), 60))
    if pkg == "port":
        assert isinstance(got, ssl.SSLError) and mints == []
    else:
        assert {v for _, v in got["subjectAltName"]} == {name}
        assert mints == [name]
    assert "s3cr3t" not in repr(got)


def test_a_hijacked_connect_to_no_host_is_answered_400(tmp_path):
    """The port's own: a CONNECT target that is no host name gets no leaf
    (and no 200) from a hijacking proxy."""
    async def main():
        d = make_daemon("port", tmp_path, "proxyd",
                        proxy={"enabled": True, "hijack": True})
        await d.start()
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", d.proxy_server.port)
            writer.write(b"CONNECT a.test,DNS:evil.test:443 HTTP/1.1\r\n"
                         b"Host: a.test:443\r\n\r\n")
            await writer.drain()
            reply = await reader.read()
            writer.close()
            return reply, counters("port")["hijack"]
        finally:
            await d.stop()

    before = counters("port")["hijack"]
    reply, hijacks = asyncio.run(asyncio.wait_for(main(), 60))
    assert reply.startswith(b"HTTP/1.1 400 ")
    assert hijacks == before


@pytest.mark.parametrize("pkg", PKGS)
def test_a_fresh_sni_name_mints_off_the_event_loop(tmp_path, pkg,
                                                   monkeypatch):
    """ROADMAP Queue 3 entry 60, fixed. The port's SNI listener peeks at
    the ClientHello and mints a first-seen name on its own executor
    before the handshake: each mint runs on a thread other than the
    loop's, a ticker on the loop never sees a gap as long as the shortest
    mint, and each fresh name's first handshake still returns its leaf.
    The reference mints inside the ``ssl`` module's synchronous SNI
    callback, on the loop's thread, and the loop serves nothing else for
    the mint (a known difference; its wheel mints in about a
    millisecond, the port's ``openssl`` processes in tens)."""
    fresh = [f"fresh{i}.test" for i in range(3)]

    async def main():
        d = make_daemon(pkg, tmp_path, "snid",
                        proxy={"enabled": True, "hijack": True,
                               "sni_port": -1})
        await d.start()
        issuer = d.proxy_server._issuer
        real = issuer._mint
        mints = []

        def timed(host):
            t = time.perf_counter()
            out = real(host)
            mints.append((threading.get_ident(), time.perf_counter() - t))
            return out

        monkeypatch.setattr(issuer, "_mint", timed)
        gaps, done = [], asyncio.Event()

        async def ticker():
            last = time.perf_counter()
            while not done.is_set():
                await asyncio.sleep(0.002)
                now = time.perf_counter()
                gaps.append(now - last)
                last = now

        tick = asyncio.create_task(ticker())
        try:
            sans = [await asyncio.to_thread(
                _sni_handshake, d.proxy_server.sni_port,
                d.proxy_server.ca_cert_path, name) for name in fresh]
        finally:
            done.set()
            await tick
            await d.stop()
        return threading.get_ident(), mints, gaps, sans

    loop_thread, mints, gaps, sans = asyncio.run(
        asyncio.wait_for(main(), 60))
    assert [{v for _, v in s["subjectAltName"]} for s in sans] == \
        [{n} for n in fresh]
    assert len(mints) == len(fresh)
    if pkg == "port":
        assert all(tid != loop_thread for tid, _ in mints)
        assert max(gaps) < min(dt for _, dt in mints)
    else:
        assert [tid for tid, _ in mints] == [loop_thread] * len(fresh)
        assert max(gaps) >= max(dt for _, dt in mints)


# ----------------------------------------- tests/test_aux.py::TestProxy

def _forward_get(port: int, url: str, headers: dict | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", url, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_p2p_and_direct_routes(tmp_path, pkg):
    blob = _bytes(700_000, 3)
    manifest = b'{"schemaVersion": 2}'
    digest = hashlib.sha256(blob).hexdigest()
    with Origin({f"v2/app/blobs/sha256:{digest}": blob,
                 "v2/app/manifests/latest": manifest}) as origin:
        blob_url = f"{origin.base}/v2/app/blobs/sha256:{digest}"

        async def main():
            d = make_daemon(pkg, tmp_path, "proxyd",
                            proxy={"enabled": True})
            await d.start()
            try:
                before = counters(pkg)
                got = [await asyncio.to_thread(
                    _forward_get, d.proxy_server.port, url)
                    for url in (blob_url,
                                f"{origin.base}/v2/app/manifests/latest")]
                done = d.storage_mgr.find_completed_task(d.ptm._task_id(
                    blob_url, PKG[pkg].UrlMeta(tag="proxy")))
                after = counters(pkg)
                return got, done is not None, {
                    k: after[k] - before[k] for k in after}
            finally:
                await d.stop()

        got, done, moved = asyncio.run(asyncio.wait_for(main(), 60))
    assert got == [(200, blob), (200, manifest)]
    assert done                      # the blob became a completed task
    assert moved == {"hijack": 0, "tunnel": 0, "p2p": 1, "shed": 0,
                     "direct": 1}


@pytest.mark.parametrize("pkg", PKGS)
def test_registry_mirror_rewrite(tmp_path, pkg):
    blob = _bytes(300_000, 4)
    digest = hashlib.sha256(blob).hexdigest()
    with Origin({f"v2/lib/blobs/sha256:{digest}": blob}) as origin:
        async def main():
            d = make_daemon(pkg, tmp_path, "mirrord",
                            proxy={"enabled": True,
                                   "registry_mirror": origin.base})
            await d.start()
            try:
                # containerd-style: a relative path against the mirror
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", d.proxy_server.port)
                writer.write(f"GET /v2/lib/blobs/sha256:{digest} HTTP/1.1"
                             f"\r\nHost: mirror\r\n\r\n".encode())
                await writer.drain()
                head = await reader.readuntil(b"\r\n\r\n")
                body = await reader.read()
                writer.close()
                return head, body
            finally:
                await d.stop()

        head, body = asyncio.run(asyncio.wait_for(main(), 60))
    assert head.split(b"\r\n")[0] == b"HTTP/1.1 200 OK"
    assert b"connection: close" in head.lower()
    assert body == blob if b"content-length" in head.lower() \
        else blob in body


# ------------------------------------------------- TestOCIPullThroughMesh

OCI_LAYERS = [_bytes(9 * MiB + 17, 5), _bytes(5 * MiB + 1, 6)]   # 3 + 2 pieces
OCI_CONFIG = json.dumps({"architecture": "amd64"}).encode()
OCI_MANIFEST = oci_manifest(OCI_CONFIG, [(oci_digest(b), len(b))
                                         for b in OCI_LAYERS])


def _pull(route: str, port: int, registry: str, ca: str = "") -> dict:
    client = OCIClient(route, ("127.0.0.1", port), registry, ca=ca)
    try:
        out = client.pull("repo/app", "v1")
    finally:
        client.close()
    return {"config": oci_digest(out["config"]),
            "layers": [oci_digest(memoryview(h.numpy()))
                       for h, _ in out["layers"]]}


@pytest.mark.parametrize("pkg", PKGS)
def test_containerd_shaped_pull_two_daemons_then_a_mirror(tmp_path, pkg):
    """A back-sources every blob once through its CONNECT; B's pull rides
    the mesh (no further origin byte, every piece from a peer); manifests
    relay direct on every pull; C's mirror rewrite rides the mesh too."""
    blobs = {oci_digest(b): b for b in (*OCI_LAYERS, OCI_CONFIG)}
    want = {"config": oci_digest(OCI_CONFIG),
            "layers": [oci_digest(b) for b in OCI_LAYERS]}
    sizes = {d: len(b) for d, b in blobs.items()}
    with Registry(tmp_path, blobs, OCI_MANIFEST) as reg:
        async def main():
            sched = PKG[pkg].scheduler()
            await sched.start()
            kw = dict(sched=sched.address, source_ca=reg.reg.ca_path)
            a = make_daemon(pkg, tmp_path, "noda",
                            proxy={"enabled": True, "hijack": True}, **kw)
            b = make_daemon(pkg, tmp_path, "nodb",
                            proxy={"enabled": True, "hijack": True}, **kw)
            c = make_daemon(pkg, tmp_path, "nodc",
                            proxy={"enabled": True,
                                   "registry_mirror": reg.url}, **kw)
            started = []
            try:
                for d in (a, b, c):
                    await d.start()
                    started.append(d)
                rounds = []
                for route, d in (("connect", a), ("connect", b),
                                 ("mirror", c)):
                    got = await asyncio.to_thread(
                        _pull, route, d.proxy_server.port, reg.url,
                        d.proxy_server.ca_cert_path)
                    stats = reg.reg.stats()
                    rounds.append((got, stats["served"],
                                   stats["manifest_hits"], peer_sources(d)))
                return rounds
            finally:
                for d in reversed(started):
                    await d.stop()
                await sched.stop()

        rounds = asyncio.run(asyncio.wait_for(main(), 180))
    for i, (got, served, hits, sources) in enumerate(rounds):
        assert got == want
        assert served == sizes           # each blob's bytes left it once
        assert hits == i + 1             # manifests relay direct
        assert sources
        if i == 0:
            assert set(sources) == {"origin"}
        else:
            assert "origin" not in sources, sources


# ------------------------------------------------- TestProxyConcurrency

CONC_BLOB = _bytes(256 * 1024, 7)
CONC_PATH = f"blobs/sha256:{hashlib.sha256(CONC_BLOB).hexdigest()}"


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("concurrency,total",
                         [(100, 200), (200, 400), (500, 1000)])
def test_concurrent_proxy_downloads(tmp_path, pkg, concurrency, total):
    """N clients at once through one daemon's proxy: the first creates the
    task, the rest join its ordered stream or replay the completed task;
    every body is byte-identical."""
    import aiohttp

    with Origin({CONC_PATH: CONC_BLOB}) as origin:
        async def main():
            d = make_daemon(pkg, tmp_path, f"d{concurrency}",
                            proxy={"enabled": True})
            await d.start()
            try:
                proxy = f"http://127.0.0.1:{d.proxy_server.port}"
                url = f"{origin.base}/{CONC_PATH}"
                sem = asyncio.Semaphore(concurrency)
                bodies = []

                async def one(session) -> None:
                    async with sem:
                        async with session.get(url, proxy=proxy) as resp:
                            assert resp.status == 200, resp.status
                            bodies.append(await resp.read())

                conn = aiohttp.TCPConnector(limit=concurrency + 50)
                async with aiohttp.ClientSession(connector=conn) as s:
                    await asyncio.gather(*[one(s) for _ in range(total)])
                return bodies
            finally:
                await d.stop()

        bodies = asyncio.run(asyncio.wait_for(main(), 120))
        assert origin.body_bytes == len(CONC_BLOB)
    assert len(bodies) == total
    assert all(b == CONC_BLOB for b in bodies)


# ------------------------------------------------------------ the port's

def _rules_table(seed: int) -> list[dict]:
    """Seeded proxies: rule sets, mirrors, and requests (targets in the
    three URL forms, headers with and without ``Host``)."""
    rng = random.Random(seed)
    hexes = [hashlib.sha256(str(i).encode()).hexdigest() for i in range(4)]
    hosts = ["registry.example:5000", "127.0.0.1:8443", "docker.io",
             "ghcr.io:443", ""]
    paths = ([f"/v2/lib/app/blobs/sha256:{h}" for h in hexes]
             + [f"/v2/lib/app/blobs/sha256:{hexes[0]}?x=1",
                f"/v2/lib/app/blobs/sha256:{hexes[1][:20]}",
                "/v2/lib/app/manifests/latest", "/v2/", "/models/w.bin",
                "/data/shard-00001.tar", "/blobs/sha256:" + hexes[2]])
    rule_pool = [r"\.bin$", r"/models/", r"shard-\d+", r"manifests",
                 r"docker\.io", r"sha256:[0-9a-f]{8}", r"^https://"]
    out = []
    for _ in range(6):
        cfg = {"rules": rng.sample(rule_pool, rng.randint(0, 3)),
               "direct_rules": rng.sample(rule_pool, rng.randint(0, 2)),
               "registry_mirror": rng.choice(
                   ["", "https://mirror.example", "http://10.0.0.9:5000/"])}
        reqs = []
        for _ in range(40):
            path = rng.choice(paths)
            host = rng.choice(hosts)
            form = rng.choice(["absolute-http", "absolute-https", "origin"])
            target = (f"{form.split('-')[1]}://{host or 'h'}{path}"
                      if form != "origin" else path)
            headers = {"host": host} if host and rng.random() < 0.7 else {}
            reqs.append((target, headers, rng.choice(["http", "https"]),
                         rng.choice(["", "sni.example", "10.1.1.1:443"])))
        out.append((cfg, reqs))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_use_p2p_and_resolve_url_equal_the_references(seed):
    dummy = types.SimpleNamespace(cfg=types.SimpleNamespace(workdir=""),
                                  paths=types.SimpleNamespace(workdir=""))
    for cfg, reqs in _rules_table(seed):
        ref = RefProxy(dummy, ref_cfg.ProxyConfig(enabled=True, **cfg))
        port = PortProxy(dummy, port_cfg.ProxyConfig(enabled=True, **cfg))
        for target, headers, scheme, authority in reqs:
            got = [p._resolve_url(target, headers, scheme=scheme,
                                  authority=authority) for p in (ref, port)]
            assert got[0] == got[1], (cfg, target, headers, scheme)
            assert ref.use_p2p(got[0]) == port.use_p2p(got[1]), \
                (cfg, got[0])


class _Redirecting:
    """An origin answering ``/redirect`` 307 to ``/elsewhere`` and
    ``/auth`` 401 with repeated ``WWW-Authenticate`` and ``Set-Cookie``
    lines; it records the paths asked."""

    def __enter__(self):
        seen = self.seen = []

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def do_GET(self) -> None:
                seen.append(self.path)
                body = b"denied"
                if self.path == "/redirect":
                    self.send_response(307)
                    self.send_header("Location", "/elsewhere")
                    body = b""
                elif self.path == "/auth":
                    self.send_response(401)
                    self.send_header("WWW-Authenticate",
                                     'Bearer realm="a",service="r"')
                    self.send_header("WWW-Authenticate", 'Basic realm="b"')
                    self.send_header("Set-Cookie", "a=1")
                    self.send_header("Set-Cookie", "b=2")
                else:
                    self.send_response(200)
                    body = b"elsewhere"
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()


def _raw_get(port: int, target: str) -> tuple[str, list, bytes]:
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(f"GET {target} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    return lines[0], [tuple(x.strip() for x in line.split(":", 1))
                      for line in lines[1:]], body


@pytest.mark.parametrize("pkg", PKGS)
def test_direct_route_passes_a_307_and_repeated_headers_as_received(
        tmp_path, pkg):
    """The direct route does not follow a redirect: the client gets the
    307 with its reason and ``Location``; a 401's two
    ``WWW-Authenticate`` and two ``Set-Cookie`` lines arrive in order."""
    with _Redirecting() as origin:
        async def main():
            d = make_daemon(pkg, tmp_path, "proxyd",
                            proxy={"enabled": True})
            await d.start()
            try:
                return [await asyncio.to_thread(
                    _raw_get, d.proxy_server.port, f"{origin.base}{p}")
                    for p in ("/redirect", "/auth")]
            finally:
                await d.stop()

        (r_status, r_lines, _), (a_status, a_lines, a_body) = asyncio.run(
            asyncio.wait_for(main(), 60))
        assert origin.seen == ["/redirect", "/auth"]    # 307 not followed
    assert r_status == "HTTP/1.1 307 Temporary Redirect"
    assert ("Location", "/elsewhere") in r_lines
    assert a_status == "HTTP/1.1 401 Unauthorized"
    assert [v for k, v in a_lines if k.lower() == "www-authenticate"] == \
        ['Bearer realm="a",service="r"', 'Basic realm="b"']
    assert [v for k, v in a_lines if k.lower() == "set-cookie"] == \
        ["a=1", "b=2"]
    assert ("Connection", "close") in a_lines and a_body == b"denied"


@pytest.mark.parametrize("pkg", PKGS)
def test_a_shed_get_is_answered_429_with_both_retry_headers(tmp_path, pkg):
    """With one bulk task admitted and no queue, a second bulk GET through
    the proxy is shed by the QoS governor: 429, ``Retry-After`` in whole
    seconds rounded up, ``X-Retry-After-Ms``, ``Connection: close``; the
    first still streams whole."""
    big = _bytes(6 * MiB, 8)
    small = _bytes(1000, 9)
    names = {f"blobs/sha256:{hashlib.sha256(b).hexdigest()}": b
             for b in (big, small)}
    (big_path, small_path) = list(names)
    bulk = {"X-Dragonfly-Class": "bulk", "X-Dragonfly-Tenant": "etl"}
    with Origin(names, pace_bps=3 * MiB) as origin:
        async def main():
            d = make_daemon(pkg, tmp_path, "proxyd",
                            proxy={"enabled": True},
                            qos={"bulk_active_limit": 1, "queue_limit": 0,
                                 "shed_retry_after_ms": 2500})
            await d.start()
            try:
                port = d.proxy_server.port
                first = asyncio.ensure_future(asyncio.to_thread(
                    _forward_get, port, f"{origin.base}/{big_path}", bulk))
                while d.qos.counters["admitted"].get("bulk", 0) < 1:
                    await asyncio.sleep(0.01)
                before = counters(pkg)["shed"]
                shed = await asyncio.to_thread(
                    _raw_get_headers, port, f"{origin.base}/{small_path}",
                    bulk)
                return shed, await first, counters(pkg)["shed"] - before
            finally:
                await d.stop()

        shed, first, moved = asyncio.run(asyncio.wait_for(main(), 60))
    status, lines = shed
    assert status == "HTTP/1.1 429 Too Many Requests"
    assert lines == [("Retry-After", "3"), ("X-Retry-After-Ms", "2500"),
                     ("Connection", "close")]
    assert first == (200, big) and moved == 1


def _raw_get_headers(port: int, target: str, headers: dict):
    extra = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(f"GET {target} HTTP/1.1\r\nHost: x\r\n{extra}\r\n"
                  .encode())
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    lines = data.partition(b"\r\n\r\n")[0].decode("latin1").split("\r\n")
    return lines[0], [tuple(x.strip() for x in line.split(":", 1))
                      for line in lines[1:]]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("proxy", [
    {"enabled": True},
    {"enabled": True, "hijack": True,
     "hijack_hosts": [r"^registry\.example$"]}],
    ids=["hijack-off", "no-hijack-match"])
def test_an_unhijacked_connect_is_a_blind_tunnel(tmp_path, pkg, proxy):
    """The client trusts only the registry's own CA: the handshake reaches
    the registry through the tunnel, and the blob comes from it, not from
    the mesh."""
    blob = _bytes(2 * MiB, 10)
    digest = oci_digest(blob)
    with Registry(tmp_path, {digest: blob}) as reg:
        async def main():
            d = make_daemon(pkg, tmp_path, "proxyd", proxy=proxy,
                            source_ca=reg.reg.ca_path)
            await d.start()
            try:
                before = counters(pkg)
                client = OCIClient("connect",
                                   ("127.0.0.1", d.proxy_server.port),
                                   reg.url, ca=reg.reg.ca_path)
                got = await asyncio.to_thread(fetch, client,
                                              f"/v2/repo/blobs/{digest}")
                after = counters(pkg)
                return got, {k: after[k] - before[k] for k in after}, \
                    d.proxy_server.ca_cert_path
            finally:
                await d.stop()

        (status, body, sans), moved, ca = asyncio.run(
            asyncio.wait_for(main(), 60))
        served = reg.served(digest)
    assert (status, body, sans) == (200, blob, [["127.0.0.1"]])
    assert moved == {"hijack": 0, "tunnel": 1, "p2p": 0, "shed": 0,
                     "direct": 0}
    assert served == len(blob)
    assert bool(ca) == bool(proxy.get("hijack"))


def test_a_callers_accept_and_user_agent_go_out_once():
    """The port's HTTP client sends its default ``User-Agent`` and
    ``Accept`` only when the caller gives none, as aiohttp does: the P2P
    route's back-source carries the client's ``Accept`` (a registry
    negotiates a manifest's type on it) once."""
    from dragonfly2_tpu_torch.source.http_client import HTTPSourceClient

    seen = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:
            pass

        def do_GET(self) -> None:
            seen.append([(k.lower(), v) for k, v in self.headers.items()
                         if k.lower() in ("accept", "user-agent")])
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/x"

    async def main():
        client = HTTPSourceClient()
        for headers in ({}, {"Accept": MEDIA_MANIFEST, "User-Agent": "c/1"}):
            resp = await client.request("GET", url, headers)
            assert await resp.read() == b"ok"
        await client.close()

    try:
        asyncio.run(asyncio.wait_for(main(), 30))
    finally:
        server.shutdown()
        server.server_close()
    assert seen == [[("user-agent", "dragonfly2-tpu-torch"),
                     ("accept", "*/*")],
                    [("accept", MEDIA_MANIFEST), ("user-agent", "c/1")]]


def test_stop_closes_an_idle_client_connection(tmp_path):
    """The port's difference: a client holding a connection open and
    idle does not hold the daemon's stop."""
    async def main():
        d = make_daemon("port", tmp_path, "proxyd", proxy={"enabled": True})
        await d.start()
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", d.proxy_server.port)
        await asyncio.sleep(0.1)
        await asyncio.wait_for(d.stop(), 10)
        got = await asyncio.wait_for(reader.read(), 5)
        writer.close()
        return got

    assert asyncio.run(main()) == b""


def test_phase_20_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_mirror`` at a 16 MB model layer and an 8 MiB
    runtime layer with a CPU client: four pulls (A's CONNECT, B's CONNECT,
    C's mirror, C's SNI port) with every invariant of the phase."""
    real_run = subprocess.run

    def run(args, *a, **kw):
        if args and args[0] == "nvidia-smi":
            return subprocess.CompletedProcess(args, 0,
                                               "CPU rehearsal, 0 W\n", "")
        return real_run(args, *a, **kw)

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    monkeypatch.setitem(chip_smoke.LLAMA3_8B, "vocab", 2000)
    monkeypatch.setattr(chip_smoke, "MIRROR_RUNTIME_BYTES", 8 * MiB)
    os.makedirs(tmp_path / "deploy")
    header, nbytes = chip_smoke.safetensors_header(chip_smoke.deploy_layout())
    with open(tmp_path / "deploy" / "model-00004-of-00004.safetensors",
              "wb") as f:
        f.write(header)
        f.write(memoryview(chip_smoke.seeded_bytes(
            np.random.default_rng(0), nbytes)))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit",
                        lambda phase, rec: lines.append((phase, rec)))
    chip_smoke.phase_mirror(str(tmp_path), 0, torch.device("cpu"))
    (phase, rec), = lines
    assert phase == "phase 20 mirror"
    assert [p["route"] for p in rec["pulls"]] == [
        "a-connect", "b-connect", "c-mirror", "c-sni"]
    assert [p["manifest_hits"] for p in rec["pulls"]] == [1, 2, 3, 4]
    assert rec["proxy"]["p2p"]["requests"] == 12
    assert rec["leaf_sans"]["c-sni"] == [[chip_smoke.MIRROR_SNI_NAME]]
    assert {k.split("/")[1] for k in rec["first_mints"]} == {
        "127.0.0.1", chip_smoke.MIRROR_SNI_NAME}


# ------------------------------------------- tests/test_churn.py, slow

def _launch(args: list[str], wait: str) -> subprocess.Popen:
    p = subprocess.Popen(
        [sys.executable, "-m", *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT, "PYTHONUNBUFFERED": "1"})
    deadline = time.monotonic() + 60
    for line in p.stdout:
        if wait in line:
            break
        assert time.monotonic() < deadline, f"no {wait!r}"
    threading.Thread(target=lambda: [None for _ in p.stdout],
                     daemon=True).start()
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_stream_survives_parent_death(tmp_path):
    """Ordered streaming through a port daemon's proxy while its parent
    dies: the byte stream arrives complete and in order (the reference's
    ``tests/test_churn.py`` case, on the port's launchers)."""
    blob = os.urandom(48 << 20)
    procs: list[subprocess.Popen] = []
    path = f"blobs/sha256:{'0' * 64}"      # blob-shaped: the P2P route

    def daemon(name: str, extra: dict) -> subprocess.Popen:
        cfg = {"workdir": str(tmp_path / name), "host_ip": "127.0.0.1",
               "listen_ip": "127.0.0.1", "hostname": name, "device": "cpu",
               "storage": {"gc_interval_s": 3600}, **extra}
        cfg_path = tmp_path / f"{name}.json"
        cfg_path.write_text(json.dumps(cfg))
        p = _launch(["dragonfly2_tpu_torch.tools.daemon", "--config",
                     str(cfg_path)], "daemon up:")
        procs.append(p)
        return p

    try:
        with Origin({path: blob}, pace_bps=4 * MiB) as origin:
            url = f"{origin.base}/{path}"
            seed_rpc, seed_up, sched_port = (_free_port() for _ in range(3))
            daemon("seed", {"is_seed": True, "rpc_port": seed_rpc,
                            "upload": {"port": seed_up}})
            sched_cfg = tmp_path / "sched.json"
            sched_cfg.write_text(json.dumps({
                "port": sched_port, "listen_ip": "127.0.0.1",
                "advertise_ip": "127.0.0.1",
                "seed_peers": [{"host_id": "seed-127.0.0.1",
                                "ip": "127.0.0.1", "rpc_port": seed_rpc,
                                "download_port": seed_up}]}))
            procs.append(_launch(["dragonfly2_tpu_torch.tools.scheduler",
                                  "--config", str(sched_cfg)],
                                 "scheduler up:"))
            sched_addr = f"127.0.0.1:{sched_port}"
            sock_a = str(tmp_path / "a.sock")
            pa = daemon("peer-a", {"unix_sock": sock_a,
                                   "scheduler": {"addresses": [sched_addr]}})
            pull_a = subprocess.Popen(
                [sys.executable, "-m", "dragonfly2_tpu_torch.tools.dfget",
                 url, "-O", str(tmp_path / "a.out"), "--daemon-sock",
                 sock_a, "--quiet"], cwd=ROOT, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                env={**os.environ, "PYTHONPATH": ROOT})
            procs.append(pull_a)
            proxy_port = _free_port()
            daemon("streamer", {"scheduler": {"addresses": [sched_addr]},
                                "proxy": {"enabled": True,
                                          "port": proxy_port}})
            time.sleep(3)
            req = urllib.request.Request(
                url, headers={"Accept": "application/octet-stream"})
            req.set_proxy(f"127.0.0.1:{proxy_port}", "http")
            got = bytearray()
            killed = False
            with urllib.request.urlopen(req, timeout=180) as resp:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    got += chunk
                    if not killed and len(got) > len(blob) // 3:
                        pa.kill()                # the parent dies
                        pull_a.kill()
                        killed = True
            assert killed, "the stream finished before the kill"
            assert bytes(got) == blob
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
