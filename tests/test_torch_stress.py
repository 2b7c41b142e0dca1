"""The stress tool in the port, against the reference's.

* The reference's ``TestStressTool`` (``tests/test_aux.py``),
  ``TestStressClassMix`` (``tests/test_qos.py``),
  ``test_debug_faults_endpoint_and_stress_chaos_arm`` and
  ``test_stress_in_process_chaos_always_disarms``
  (``tests/test_faults.py``) against both packages. Stand-ins are on the
  port's ``common/httpd.py`` connection loop; each package's chaos arm
  goes to its own daemon.
* Deterministic equality: ``run_rollout`` on one manifest against a
  stand-in that honours ``Range`` (and one that ignores it); an
  always-429 stand-in's shed accounting; ``parse_class_mix`` over a table
  of inputs; each report attachment against one live port daemon and
  scheduler; and the CLI's exit codes and ``SystemExit`` texts.
* The forward proxy: ``run_stress`` through a port daemon's proxy with an
  ``http://`` URL (absolute-form request lines) and an ``https://`` URL
  (a ``CONNECT`` tunnel), and a stalled body counted as an error within
  the read bound.
* ``chip_smoke.py`` phase 25 rehearsed on the CPU at a 66 MB file with
  a 3 s load.

Each case's load runs at most 1 s, but the rehearsal's, and every case
has a timeout.
"""

import argparse
import asyncio
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from dragonfly2_tpu.common import faultgate as ref_faultgate
from dragonfly2_tpu.daemon import config as ref_dconfig
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.tools import stress as ref_stress
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.common import faultgate as port_faultgate
from dragonfly2_tpu_torch.common import httpd
from dragonfly2_tpu_torch.common.debug_http import start_debug_server
from dragonfly2_tpu_torch.daemon.config import (DaemonConfig, ProxyConfig,
                                                StorageSection)
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.source.http_client import HTTPSourceClient
from dragonfly2_tpu_torch.tools import stress
from dragonfly2_tpu_torch.tools.scheduler import add_scheduler_routes
import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 20.0
PKGS = {"reference": (ref_stress, ref_faultgate),
        "port": (stress, port_faultgate)}


def run(coro, limit: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit))


@pytest.fixture(autouse=True)
def _disarm():
    ref_faultgate.reset()
    port_faultgate.reset()
    yield
    ref_faultgate.reset()
    port_faultgate.reset()


class StandIn:
    """An origin on ``httpd.serve_connection`` whose ``handler(method,
    target, headers, writer)`` writes each answer itself; ``tls`` takes
    a server context. ``lines`` holds every request line."""

    def __init__(self, handler, tls=None):
        self.handler = handler
        self.tls = tls
        self.lines: list[tuple[str, str]] = []
        self.port = 0
        self._server = None

    async def __aenter__(self) -> "StandIn":
        async def route(method, target, headers, writer, _body):
            self.lines.append((method, target))
            await self.handler(method, target, headers, writer)

        async def on_conn(reader, writer):
            task = asyncio.current_task()
            self._conns.add(task)
            try:
                await httpd.serve_connection(reader, writer, route)
            finally:
                self._conns.discard(task)

        self._conns: set = set()
        self._server = await asyncio.start_server(
            on_conn, "127.0.0.1", 0, ssl=self.tls, limit=httpd.HEAD_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc) -> None:
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()

    def url(self, path: str = "/blob") -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://127.0.0.1:{self.port}{path}"


async def _answer(writer, status: int, body: bytes = b"",
                  headers: dict | None = None) -> None:
    writer.write(httpd.head(status, {"Content-Length": str(len(body)),
                                     **(headers or {})}) + body)
    await writer.drain()


def _every_fifth_fails(payload: bytes):
    calls = {"n": 0}

    async def handle(method, target, headers, writer):
        calls["n"] += 1
        if calls["n"] % 5 == 0:
            await _answer(writer, 500)
        else:
            await _answer(writer, 200, payload)
    return handle


def _ranged(data: bytes, honour: bool = True):
    async def handle(method, target, headers, writer):
        rng = headers.get("range", "")
        if honour and rng.startswith("bytes="):
            a, _, b = rng[6:].partition("-")
            a, b = int(a), min(int(b), len(data) - 1)
            await _answer(writer, 206, data[a:b + 1],
                          {"Content-Range": f"bytes {a}-{b}/{len(data)}"})
        else:
            await _answer(writer, 200, data)
    return handle


# ------------------------------------------- the reference's cases, both

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_stress_reports_histogram(pkg):
    """Reference ``test/tools/stress`` parity: N workers, duration,
    request/error counts, throughput, latency percentiles."""
    mod, _ = PKGS[pkg]
    payload = b"z" * 100_000

    async def go():
        async with StandIn(_every_fifth_fails(payload)) as s:
            return await mod.run_stress(s.url(), concurrency=4,
                                        duration_s=1.0)

    out = run(go())
    assert out["requests"] > 10
    assert 0 < out["errors"] < out["requests"]
    assert out["bytes"] >= len(payload)
    assert out["bytes"] % len(payload) == 0
    assert out["latency_ms"]["p50"] > 0
    assert out["latency_ms"]["p99"] >= out["latency_ms"]["p50"]
    assert out["throughput_gbps"] > 0
    assert "classes" not in out


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_parse_and_fill(pkg):
    parse = PKGS[pkg][0].parse_class_mix
    assert parse([], 8) == [("", 8)]
    mix = parse(["critical:2", "bulk:4"], 8)
    assert mix == [("critical", 2), ("bulk", 4), ("standard", 2)]
    assert parse(["bulk"], 1) == [("bulk", 1)]
    with pytest.raises(SystemExit):
        parse(["gold:2"], 8)


MIXES = [([], 4), (["critical"], 4), (["critical:1", "bulk:2"], 4),
         (["bulk:6"], 4), (["standard:2", "standard:1"], 3),
         (["critical:0"], 2), (["gold"], 2), (["critical:1", "bronze:2"], 4),
         ([""], 1), (["bulk:x"], 2)]


def _mix(mod, specs, c):
    try:
        return mod.parse_class_mix(list(specs), c)
    except SystemExit as exc:
        return ("SystemExit", str(exc.code))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("specs,c", MIXES)
def test_parse_class_mix_equals_the_references(specs, c):
    assert _mix(stress, specs, c) == _mix(ref_stress, specs, c)


def _daemon(pkg: str, tmp_path, name: str, **kw):
    if pkg == "reference":
        cfg = ref_dconfig.DaemonConfig(
            workdir=str(tmp_path / name), host_ip="127.0.0.1", hostname=name,
            storage=ref_dconfig.StorageSection(gc_interval_s=3600))
        cfg.upload.debug_endpoints = kw.get("debug", False)
        cfg.pex.enabled = False
        return RefDaemon(cfg)
    cfg = DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                       listen_ip="127.0.0.1", host_ip="127.0.0.1",
                       device="cpu",
                       storage=StorageSection(gc_interval_s=3600))
    cfg.upload.debug_endpoints = kw.get("debug", False)
    cfg.pex.enabled = kw.get("pex", False)
    cfg.pex.interval_s = 3600.0
    if "proxy" in kw:
        cfg.proxy = kw["proxy"]
    return Daemon(cfg)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_debug_faults_endpoint_and_stress_chaos_arm(tmp_path, pkg):
    """POST/GET/DELETE /debug/faults on each package's upload port
    (behind ``upload.debug_endpoints``), driven as ``--chaos-target``
    drives it."""
    fg = PKGS[pkg][1]

    async def go():
        daemon = _daemon(pkg, tmp_path, "dbg", debug=True)
        await daemon.start()
        base = f"http://127.0.0.1:{daemon.upload_server.port}"
        client = HTTPSourceClient()
        out = {}
        try:
            for name, method, body in (
                    ("arm", "POST", b"piece.wire=delay:0.1:n=2"),
                    ("get", "GET", b""),
                    ("bad", "POST", b"bogus.site=fail"),
                    ("reset", "DELETE", b"")):
                resp = await client.request(method, f"{base}/debug/faults",
                                            body=body)
                out[name] = (resp.status, json.loads(await resp.read()))
            out["armed_after"] = fg.ARMED
            return out
        finally:
            await client.close()
            await daemon.stop()

    out = run(go())
    assert out["arm"][0] == 200
    st = out["get"][1]
    assert st["armed"]
    assert st["scripts"][0]["site"] == "piece.wire"
    assert st["scripts"][0]["remaining"] == 2
    # bad scripts are rejected, not half-armed
    assert out["bad"][0] == 400
    assert out["reset"] == (200, {"armed": False, "scripts": []})
    assert out["armed_after"] is False


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_stress_in_process_chaos_always_disarms(pkg):
    """--chaos without a target arms this process and disarms after the
    run, even when the run errors."""
    mod, fg = PKGS[pkg]
    args = argparse.Namespace(
        url="http://127.0.0.1:9/none", proxy="", concurrency=1,
        duration_s=0.0, duration=0.1, chaos="rpc.unary=fail:n=-1",
        chaos_target="", tenant="", priority=[])
    err = io.StringIO()
    with redirect_stderr(err):
        result = run(mod._run_with_chaos(args))
    assert result["requests"] == result["errors"] > 0   # origin is dead
    assert not fg.ARMED                                  # always disarmed
    assert "arms faults in this process only" in err.getvalue()


# ------------------------------------------------- deterministic equality

def _manifest(tmp_path, sizes: list[int]) -> tuple[str, int]:
    shards, off = [], 0
    for i, n in enumerate(sizes):
        shards.append({"name": f"s{i}", "range_start": off,
                       "range_size": n})
        off += n
    path = tmp_path / "manifest.json"
    path.write_text(json.dumps({"shards": shards}))
    return str(path), off


ROLLOUT_KEYS = ("shards", "shards_ready", "errors", "bytes",
                "rollout_workers", "url")


@pytest.mark.parametrize("honour", [True, False])
def test_rollout_equals_the_references(tmp_path, honour):
    path, total = _manifest(tmp_path, [70_000, 123_457, 1, 4096, 99_999,
                                       65_536, 31_337])
    data = bytes(range(256)) * (total // 256 + 1)

    async def go():
        async with StandIn(_ranged(data[:total], honour)) as s:
            return {name: await mod.run_rollout(s.url(), workers=3,
                                                manifest_path=path)
                    for name, (mod, _) in PKGS.items()}

    got = run(go())
    port, ref = got["port"], got["reference"]
    assert {k: port[k] for k in ROLLOUT_KEYS} \
        == {k: ref[k] for k in ROLLOUT_KEYS}
    assert port["per_worker_shards"] == ref["per_worker_shards"]
    assert list(port) == list(ref)
    if honour:
        assert (port["shards_ready"], port["errors"], port["bytes"]) \
            == (7, 0, total)
    else:
        assert port["errors"] == port["shards"] == 7
        assert port["shards_ready"] == 0 and port["makespan_s"] == 0.0


def test_always_429_shed_accounting_equals_the_references():
    async def shed(method, target, headers, writer):
        await _answer(writer, 429, b"slow down", {"Retry-After": "1"})

    async def go():
        async with StandIn(shed) as s:
            out = {}
            for name, (mod, _) in PKGS.items():
                t0 = time.monotonic()
                r = await mod.run_stress(
                    s.url(), concurrency=3, duration_s=0.3, tenant="batch",
                    class_mix=[("bulk", 2), ("critical", 1)])
                out[name] = (r, time.monotonic() - t0)
            return out

    got = run(go())
    keep = ("concurrency", "requests", "errors", "shed", "bytes",
            "latency_ms", "tenant", "classes", "throughput_gbps")
    port, ref = got["port"][0], got["reference"][0]
    assert {k: port[k] for k in keep} == {k: ref[k] for k in keep}
    assert list(port) == list(ref)
    assert port["shed"] == port["requests"] == 3 and port["errors"] == 0
    assert port["classes"]["bulk"]["shed"] == 2
    # Retry-After is honoured, capped at the run's end
    assert 0.25 < got["port"][1] < 0.9


@pytest.fixture(scope="module")
def live_pod(tmp_path_factory):
    """A port scheduler (its debug routes mounted as the launcher mounts
    them), a seed and a leecher that pulled a 5 MiB file through it, left
    quiet: no announce or gossip ticks while the readers run."""
    tmp = tmp_path_factory.mktemp("stresspod")
    origin = tmp / "origin.bin"
    origin.write_bytes(os.urandom((5 << 20) + 17))
    holder: dict = {}
    ready = threading.Event()
    stop = threading.Event()

    def cfg(name: str, addr: str, **kw) -> DaemonConfig:
        c = DaemonConfig(workdir=str(tmp / name), hostname=name,
                         listen_ip="127.0.0.1", host_ip="127.0.0.1",
                         device="cpu",
                         storage=StorageSection(gc_interval_s=3600),
                         scheduler=DaemonSched(addresses=[addr]), **kw)
        c.announce_interval_s = 3600.0
        c.probe_enabled = False
        c.pex.interval_s = 3600.0
        return c

    async def pod():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        addr = f"127.0.0.1:{port}"
        seed = Daemon(cfg("seed", addr, is_seed=True))
        await seed.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", port=port,
            seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await sched.start()
        debug = await start_debug_server(
            "127.0.0.1", 0,
            extra_routes=lambda router: add_scheduler_routes(router, sched))
        leech = Daemon(cfg("leech", addr))
        await leech.start()
        try:
            async for _ in leech.ptm.start_file_task(
                    port_msg.DownloadRequest(
                        url=f"file://{origin}", output=str(tmp / "out"),
                        disable_back_source=True, timeout_s=30.0)):
                pass
            await asyncio.sleep(0.5)     # the peer result lands
            holder.update(
                sched=f"127.0.0.1:{debug.port}",
                pod=",".join(f"127.0.0.1:{d.upload_server.port}"
                             for d in (seed, leech)),
                leech=f"http://127.0.0.1:{leech.upload_server.port}")
            ready.set()
            while not stop.is_set():
                await asyncio.sleep(0.05)
        finally:
            await leech.stop()
            await debug.stop()
            await sched.stop()
            await seed.stop()

    t = threading.Thread(target=lambda: asyncio.run(pod()), daemon=True)
    t.start()
    assert ready.wait(60), "the pod did not come up"
    yield holder
    stop.set()
    t.join(30)


ATTACHMENTS = ("verdicts", "fleet", "ctrl", "podscope", "pex")


def _attach(mod, name: str, pod: dict):
    if name == "verdicts":
        return mod._verdict_report(pod["pod"])
    if name == "fleet":
        return mod._fleet_report(pod["sched"])
    if name == "ctrl":
        return mod._ctrl_report(pod["sched"])
    if name == "podscope":
        return mod._pod_report(pod["pod"])
    return asyncio.run(mod._fetch_pex(pod["leech"]))


@pytest.mark.parametrize("name", ATTACHMENTS)
def test_each_attachment_equals_the_references_on_a_live_pod(live_pod,
                                                             name):
    got = _attach(stress, name, live_pod)
    assert "error" not in got, got
    assert got == _attach(ref_stress, name, live_pod)
    if name == "podscope":
        assert got["tasks"] and not got["unreachable"]
    if name == "verdicts":
        assert set(got) == set(live_pod["pod"].split(","))


def test_attachment_errors_come_out_as_the_references():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{sock.getsockname()[1]}"

    async def text_pex(method, target, headers, writer):
        await _answer(writer, 200, b"not json",
                      {"Content-Type": "text/plain; charset=utf-8"})

    async def go():
        async with StandIn(text_pex) as s:
            base = f"http://127.0.0.1:{s.port}"
            return (await stress._fetch_pex(base),
                    await ref_stress._fetch_pex(base))

    port_pex, ref_pex = run(go())
    assert port_pex == ref_pex
    assert list(port_pex) == ["error"]
    assert "unexpected mimetype: text/plain" in port_pex["error"]
    assert stress._verdict_report("") == ref_stress._verdict_report("")
    assert stress._verdict_report(dead) == ref_stress._verdict_report(dead)
    assert list(stress._verdict_report(dead)[dead]) == ["error"]
    for fn in ("_fleet_report", "_ctrl_report"):
        got = getattr(stress, fn)(dead)
        assert list(got) == ["error"]
        assert got == getattr(ref_stress, fn)(dead)
    got = stress._pod_report(dead)
    assert got == ref_stress._pod_report(dead)
    assert list(got["unreachable"]) == [dead]


def _cli(mod, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            rc = mod.main(argv)
        except SystemExit as exc:
            rc = exc.code
    report = json.loads(out.getvalue()) if out.getvalue() else None
    return rc, report


def test_cli_refusals_and_exit_codes_equal_the_references(tmp_path):
    dead = "http://127.0.0.1:9/none"
    no_target = ["--url", dead, "-d", "0.1", "--byzantine"]
    rollout = ["--url", dead, "--rollout", "2"]
    quiet = ["--url", dead, "-d", "0.1", "-c", "1", "--byzantine", "0"]
    got = {name: (_cli(stress, argv), _cli(ref_stress, argv))
           for name, argv in (("no_target", no_target),
                              ("rollout", rollout), ("quiet", quiet))}
    for name, (port, ref) in got.items():
        assert port[0] == ref[0], name
    assert got["no_target"][0][0] == (
        "stress: --byzantine needs --chaos-target http://daemon:upload_port "
        "(the daemon that will serve corrupt bytes)")
    assert got["rollout"][0][0] == "stress: --rollout needs --shard-manifest"
    # --byzantine 0 arms no clause: every request errors, exit 1
    port, ref = got["quiet"]
    assert port[0] == ref[0] == 1
    assert "byzantine" not in port[1] and "chaos" not in port[1]
    assert set(port[1]) == set(ref[1])

    async def refused(pkg):
        daemon = _daemon(pkg, tmp_path, f"byz-{pkg}", debug=True)
        await daemon.start()
        target = f"http://127.0.0.1:{daemon.upload_server.port}"
        try:
            return await asyncio.to_thread(
                _cli, PKGS[pkg][0], ["--url", dead, "-d", "0.1",
                                     "--byzantine", "101",
                                     "--chaos-target", target])
        finally:
            await daemon.stop()

    texts = {pkg: run(refused(pkg))[0] for pkg in PKGS}
    assert texts["port"] == texts["reference"] == (
        'chaos arm failed: HTTP 400 {"error": "pct must be 1-100, got '
        '101"} (is upload.debug_endpoints on?)')


def test_a_byzantine_run_arms_reports_and_disarms_a_live_daemon(tmp_path):
    """``main`` with ``--byzantine 30`` against a port daemon: the clause
    is armed during the run, the report carries ``chaos``, ``pex`` and
    ``byzantine``, and the daemon is disarmed after. ``main`` runs its
    event loop twice (the load, then ``--pex-dump``)."""
    payload = b"q" * 50_000
    seen: list = []

    async def handle(method, target, headers, writer):
        seen.append(port_faultgate.status()["armed"])
        await _answer(writer, 200, payload,
                      {"Content-Type": "application/octet-stream"})

    holder: dict = {}

    async def go():
        d = _daemon("port", tmp_path, "byz", debug=True, pex=True)
        await d.start()
        base = f"http://127.0.0.1:{d.upload_server.port}"
        try:
            async with StandIn(handle) as s:
                holder["out"] = await asyncio.to_thread(
                    _cli, stress, ["--url", s.url(), "-c", "2", "-d", "0.3",
                                   "--priority", "critical:1",
                                   "--byzantine", "--chaos-target", base,
                                   "--pex-dump", base,
                                   "--pod-report",
                                   base.removeprefix("http://")])
            return port_faultgate.status()
        finally:
            await d.stop()

    after = run(go())
    rc, report = holder["out"]
    assert rc == 0
    assert all(seen) and seen
    assert report["chaos"] == "upload.serve=corrupt:pct=30:n=-1"
    assert report["byzantine"]["pct"] == 30
    assert report["pex"] and "error" not in report["pex"]
    assert set(report["classes"]) == {"critical", "standard"}
    assert report["bytes"] % len(payload) == 0 and report["errors"] == 0
    assert after == {"armed": False, "scripts": []}


# ------------------------------------------------- the proxy and read_s

def test_run_stress_through_a_port_daemons_proxy(tmp_path, monkeypatch):
    """``run_stress`` through a port daemon's forward proxy: an
    ``http://`` URL arrives at the proxy as absolute-form request lines
    (one per request, each reaching the origin); an ``https://`` URL opens
    ``CONNECT`` tunnels to the TLS origin, which sees origin-form lines."""
    from dragonfly2_tpu_torch.common.certs import CertIssuer
    issuer = CertIssuer(str(tmp_path / "ca"))
    monkeypatch.setenv("SSL_CERT_FILE", issuer.ca_cert_path)
    payload = os.urandom(70_000)

    async def handle(method, target, headers, writer):
        await _answer(writer, 200, payload)

    async def go():
        d = _daemon("port", tmp_path, "px",
                    proxy=ProxyConfig(enabled=True))
        await d.start()
        seen: list = []
        px = d.proxy_server
        real_handle, real_tunnel = px._handle_request, px._tunnel

        async def handle_request(method, target, *a, **kw):
            seen.append((method, target))
            return await real_handle(method, target, *a, **kw)

        async def tunnel(target, *a):
            seen.append(("CONNECT", target))
            return await real_tunnel(target, *a)

        px._handle_request, px._tunnel = handle_request, tunnel
        proxy = f"http://127.0.0.1:{px.port}"
        out = {}
        try:
            async with StandIn(handle) as plain, \
                    StandIn(handle, issuer.server_context("127.0.0.1")) as tls:
                for name, s in (("http", plain), ("https", tls)):
                    seen.clear()
                    r = await stress.run_stress(s.url(), proxy=proxy,
                                                concurrency=2,
                                                duration_s=0.5)
                    out[name] = (r, list(seen), list(s.lines), s.url())
                    s.lines.clear()
            return out
        finally:
            await d.stop()

    out = run(go())
    r, seen, lines, url = out["http"]
    assert r["errors"] == 0 and r["requests"] >= 2
    assert r["bytes"] == r["requests"] * len(payload)
    assert seen == [("GET", url)] * r["requests"]
    assert lines == [("GET", "/blob")] * r["requests"]
    r, seen, lines, url = out["https"]
    assert r["errors"] == 0 and r["requests"] >= 2
    assert r["bytes"] == r["requests"] * len(payload)
    authority = url.removeprefix("https://").removesuffix("/blob")
    assert seen and set(seen) == {("CONNECT", authority)}
    assert len(seen) <= r["requests"]
    assert lines == [("GET", "/blob")] * r["requests"]


def test_a_stalled_body_counts_an_error_within_read_s(monkeypatch):
    """A stand-in that sends half its body and stalls: each request ends
    as an error once a read waits ``read_s``, so the run ends on time.
    ``run_stress`` asks for ``max(duration_s, 10)``; the test clamps that
    to 0.3 s to stay short, and checks what was asked."""
    asked: list = []

    class Clamped(HTTPSourceClient):
        async def request(self, *a, read_s=None, **kw):
            asked.append(read_s)
            return await super().request(*a, read_s=0.3, **kw)

    monkeypatch.setattr(stress, "HTTPSourceClient", Clamped)

    async def stall(method, target, headers, writer):
        writer.write(httpd.head(200, {"Content-Length": "100000"})
                     + b"x" * 50_000)
        await writer.drain()
        await asyncio.sleep(30)

    async def go():
        async with StandIn(stall) as s:
            t0 = time.monotonic()
            r = await stress.run_stress(s.url(), concurrency=2,
                                        duration_s=0.2)
            return r, time.monotonic() - t0

    r, took = run(go())
    assert r["errors"] == r["requests"] == 2 and r["bytes"] == 0
    assert set(asked) == {10.0}
    assert 0.25 < took < 1.5


# ------------------------------------------------------ phase 25 on the CPU

def test_phase_25_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_stress`` at a 66 MB weights file (16 pieces),
    the origin unpaced, a 3 s load and a CPU sink: the CLI through X's
    proxy with ``--byzantine 30`` against P and every attachment, L's pull
    inside the load, with every check of the phase."""
    real_run = subprocess.run

    def fake_run(args, *a, **kw):
        if args and args[0] == "nvidia-smi":
            return subprocess.CompletedProcess(args, 0,
                                               "CPU rehearsal, 0 W\n", "")
        return real_run(args, *a, **kw)

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    monkeypatch.setitem(chip_smoke.LLAMA3_8B, "vocab", 8000)
    monkeypatch.setattr(chip_smoke, "CHAIN_PACE_BPS", 0)
    monkeypatch.setattr(chip_smoke, "STRESS_DURATION_S", 3.0)
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
    chip_smoke.phase_stress(str(tmp_path), torch.device("cpu"))
    (phase, rec), = lines
    assert phase == "phase 25 stress"
    assert rec["file_bytes"] == len(header) + nbytes
    assert rec["bytes"] % rec["file_bytes"] == 0
    assert 0 < rec["injected"] < rec["served"]
    assert set(rec["class_latency_ms"]) == {"critical", "bulk", "standard"}
    assert rec["card"] == "CPU rehearsal, 0 W"
    assert not os.path.exists(tmp_path / "stress")
