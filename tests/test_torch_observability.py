"""The port's observability plane on the CPU, against the JAX package's.

The reference's cases from ``tests/test_tracing.py``, ``test_health.py``,
``test_phasetimer.py`` and the debug routes of ``test_observability.py``,
run through both packages wherever both take the input, and compared:

* tracing: the traceparent round trip, span nesting, the JSONL rows and
  the OTLP/HTTP-JSON payload (a standard-library collector on loopback);
* the health plane: ``SLOEngine.annotate`` / ``observe_summary`` on one
  summary, the watchdog's overrun and breach counts, the loop-lag stall
  event, the await-chain dump;
* the ruling profiler: snapshots under a fake clock, the disarmed-overhead
  bound (under 10 us per call, as ``test_phasetimer.py:58-66``);
* ``deep_sizeof`` on plain containers, the ``ClusterView`` snapshot and
  the ``/debug/decisions`` JSON after the same reports and rulings;
* the debug surfaces over HTTP: the launchers' debug server, the daemon's
  ``/debug/health`` and its ``--debug-endpoints``-gated routes;
* an in-process pod (seed, scheduler, leecher, sink on
  ``torch.device("cpu")``) whose one trace id spans register, offer,
  fetch, serve and the sink;
* the launchers started as processes with the flags, serving the routes.

Every test restores the process's tracer and the profiler's armed state
(the autouse fixture), so later tests inherit no spans and no armed
profiler. Tolerances are exact.
"""

import asyncio
import http.server
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dragonfly2_tpu.common import health as ref_health
from dragonfly2_tpu.common import phasetimer as ref_phasetimer
from dragonfly2_tpu.common import sizeof as ref_sizeof
from dragonfly2_tpu.common import tracing as ref_tracing
from dragonfly2_tpu.idl import messages as ref_msg
from dragonfly2_tpu.scheduler import cluster_view as ref_cluster_view
from dragonfly2_tpu.scheduler import decision_ledger as ref_ledger
from dragonfly2_tpu.scheduler import resource as ref_resource
from dragonfly2_tpu_torch.common import (debug_http, faultgate, health,
                                         phasetimer, sizeof, tracing)
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.config import TracingConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl import messages as port_msg
from dragonfly2_tpu_torch.scheduler import cluster_view, decision_ledger
from dragonfly2_tpu_torch.scheduler import resource as port_resource
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.ctrl_debug import (CtrlObservatory,
                                                       add_ctrl_routes)
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from test_torch_deploy import Service, free_port

MiB = 1 << 20
LIMIT_S = 60.0
TRACINGS = {"ref": ref_tracing, "port": tracing}
PHASETIMERS = {"ref": ref_phasetimer, "port": phasetimer}


@pytest.fixture(autouse=True)
def _fresh_planes():
    """A fresh tracer in both packages, both profilers reset and no fault
    armed; everything restored afterwards."""
    olds = {k: m.TRACER for k, m in TRACINGS.items()}
    for m in TRACINGS.values():
        m.TRACER = m.Tracer()
        m.configure = m.TRACER.configure
    for p in PHASETIMERS.values():
        p.reset()
    faultgate.reset()
    yield
    for k, m in TRACINGS.items():
        m.TRACER.flush()
        m.TRACER = olds[k]
        m.configure = olds[k].configure
    for p in PHASETIMERS.values():
        p.reset()
    faultgate.reset()


def _get(url: str, timeout: float = 10.0) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _send(url: str, method: str, body: bytes = b"") -> tuple[int, bytes]:
    req = urllib.request.Request(url, data=body or None, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


# ---------------------------------------------------------------- tracing

@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_traceparent_roundtrip(pkg):
    tr = TRACINGS[pkg]
    header = f"00-{'a' * 32}-{'b' * 16}-01"
    assert tr.from_traceparent(header) == tr.SpanContext("a" * 32, "b" * 16,
                                                         sampled=True)
    for bad in ("garbage", "", f"00-{'g' * 32}-{'b' * 16}-01",
                f"00-{'a' * 31}-{'b' * 16}-01", f"00-{'a' * 32}-{'b' * 16}-zz"):
        assert tr.from_traceparent(bad) is None
    assert not tr.from_traceparent(f"00-{'a' * 32}-{'b' * 16}-00").sampled
    with tr.span("x"):
        assert tr.traceparent() == ""        # off: no context, no header


def _spans_jsonl(tr, path: str) -> list[dict]:
    tr.configure(service="test", jsonl_path=path)
    with tr.span("outer", kind="task") as outer:
        header = tr.traceparent()
        assert outer.ctx.trace_id in header and outer.ctx.span_id in header
        with tr.span("inner", n=3) as inner:
            assert inner.ctx.trace_id == outer.ctx.trace_id
            assert inner.parent_span_id == outer.ctx.span_id
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("nope")
    remote = tr.from_traceparent(f"00-{'c' * 32}-{'d' * 16}-01")
    with tr.span("joined", parent=remote) as sp:
        assert sp.ctx.trace_id == "c" * 32 and sp.parent_span_id == "d" * 16
    tr.TRACER.flush()
    with open(path) as f:
        return [json.loads(ln) for ln in f]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_span_nesting_and_jsonl_export(pkg, tmp_path):
    rows = _spans_jsonl(TRACINGS[pkg], str(tmp_path / "t.jsonl"))
    by = {r["name"]: r for r in rows}
    assert sorted(by) == ["boom", "inner", "joined", "outer"]
    assert by["inner"]["trace_id"] == by["outer"]["trace_id"]
    assert by["inner"]["parent_span_id"] == by["outer"]["span_id"]
    assert by["boom"]["status"] == "error"
    assert "nope" in by["boom"]["attributes"]["error.message"]
    assert by["inner"]["attributes"] == {"n": 3}
    assert all(r["duration_ms"] >= 0 for r in rows)


def test_jsonl_rows_have_the_reference_shape(tmp_path):
    ref_rows = _spans_jsonl(ref_tracing, str(tmp_path / "r.jsonl"))
    port_rows = _spans_jsonl(tracing, str(tmp_path / "p.jsonl"))
    varying = ("trace_id", "span_id", "parent_span_id", "start_ns", "end_ns",
               "duration_ms")
    for a, b in zip(ref_rows, port_rows):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k not in varying} == \
            {k: v for k, v in b.items() if k not in varying}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_disabled_tracer_is_silent(pkg, tmp_path):
    tr = TRACINGS[pkg]
    with tr.span("x") as sp:
        assert not sp.ctx.sampled
    tr.TRACER.flush()
    assert os.listdir(tmp_path) == []
    assert not tr.TRACER.enabled


class _Collector(http.server.BaseHTTPRequestHandler):
    got: list = []

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        type(self).got.append((self.path, json.loads(self.rfile.read(n))))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *_a):
        pass


def _otlp_payload(tr) -> tuple[str, dict]:
    _Collector.got = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Collector)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        tr.configure(service="otlp-test",
                     otlp_endpoint=f"http://127.0.0.1:{srv.server_port}")
        with tr.span("exported", foo="bar"):
            pass
        tr.TRACER.flush()
        deadline = time.monotonic() + 10
        while not _Collector.got and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        srv.shutdown()
        srv.server_close()
    assert _Collector.got, "no OTLP payload arrived"
    return _Collector.got[0]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_otlp_export_shape(pkg):
    path, payload = _otlp_payload(TRACINGS[pkg])
    assert path == "/v1/traces"
    rs = payload["resourceSpans"][0]
    assert rs["resource"]["attributes"][0]["value"]["stringValue"] == \
        "otlp-test"
    sp = rs["scopeSpans"][0]["spans"][0]
    assert sp["name"] == "exported" and len(sp["traceId"]) == 32
    assert sp["attributes"] == [{"key": "foo",
                                 "value": {"stringValue": "bar"}}]


def test_otlp_payloads_match_the_reference():
    _, a = _otlp_payload(ref_tracing)
    _, b = _otlp_payload(tracing)
    for p in (a, b):
        sp = p["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
        for k in ("traceId", "spanId", "startTimeUnixNano",
                  "endTimeUnixNano"):
            sp[k] = ""
    assert a == b


# ---------------------------------------------------------------- health

SLO_ROWS = [
    {"piece": 0, "queue_ms": 1.0, "ttfb_ms": 2.0, "wire_ms": 5.0,
     "hbm_ms": 0.5, "total_ms": 8.5},
    {"piece": 1, "queue_ms": 1.0, "ttfb_ms": 900.0, "wire_ms": 4000.0,
     "hbm_ms": 0.5, "total_ms": 4901.5},
    {"piece": 2, "queue_ms": 1200.0, "ttfb_ms": 2.0, "wire_ms": 700.0,
     "hbm_ms": 1500.0, "total_ms": 3402.0},
]
BUDGETS = [
    None,
    {"schedule": 100.0, "first_byte": 500.0, "wire": 600.0, "hbm": 100.0},
    {"schedule": 0.0, "first_byte": 0.0, "wire": 600.0, "hbm": 0.0},
]


@pytest.mark.parametrize("budgets", BUDGETS, ids=["default", "tight",
                                                  "wire-only"])
@pytest.mark.parametrize("cls", ["", "critical", "bulk"])
def test_slo_annotate_and_observe_equal_the_reference(budgets, cls):
    def run(mod):
        slo = mod.SLOEngine(budgets)
        summary = {"piece_rows": [dict(r) for r in SLO_ROWS],
                   "served_rung": "back_source", "qos_class": cls}
        annotated = dict(slo.annotate(summary))
        counted = slo.observe_summary(summary)
        return annotated, counted, slo.snapshot()
    assert run(health) == run(ref_health)


def test_disabled_slo_engine_neither_counts_nor_annotates():
    for mod in (ref_health, health):
        slo = mod.SLOEngine({"wire": 600.0}, enabled=False)
        summary = {"piece_rows": [dict(r) for r in SLO_ROWS]}
        assert slo.annotate(summary) is summary
        assert "slo_breaches" not in summary
        assert slo.observe_summary(summary) == {}


def _watchdog_counts(mod, shape: str) -> dict:
    """One watchdog section of ``shape`` on a fresh plane of ``mod``: the
    overrun events, breach count, open sections and the dump."""
    async def go():
        plane = mod.HealthPlane()
        plane.acquire(mod.HealthConfig(sample_interval_s=0.03))

        async def wedged():
            with plane.watchdog.section(f"t.{shape}", 0.1, stage="wire"):
                if shape == "failed":
                    await asyncio.wait_for(asyncio.sleep(30.0), 0.4)
                else:
                    await asyncio.sleep(0.3 if shape == "late" else 0.01)
        try:
            try:
                await wedged()
            except asyncio.TimeoutError:
                pass
            await asyncio.sleep(0.08)
            snap = plane.snapshot()
            ev = [e for e in snap["events"] if e["kind"] == "section_overrun"]
            return {"overruns": len(ev),
                    "stacks_name_the_task": bool(ev) and "wedged" in
                    ev[-1]["stacks"],
                    "breaches": snap["slo"]["breaches"],
                    "open": snap["watchdog"]["active_sections"]}
        finally:
            plane.release()
    return asyncio.run(go())


@pytest.mark.parametrize("shape,overruns,breaches", [
    ("failed", 1, [{"stage": "wire", "rung": "p2p", "count": 1}]),
    ("late", 1, []), ("in-time", 0, [])])
def test_watchdog_overrun_and_breach_counts(shape, overruns, breaches):
    port = _watchdog_counts(health, shape)
    assert port == _watchdog_counts(ref_health, shape)
    assert port["overruns"] == overruns and port["breaches"] == breaches
    assert port["stacks_name_the_task"] == bool(overruns)
    assert port["open"] == []


def test_loop_stall_is_an_event_and_the_monitor_is_refcounted():
    async def go():
        plane = health.HealthPlane()
        plane.acquire(health.HealthConfig(sample_interval_s=0.05,
                                          stall_threshold_s=0.3))
        plane.acquire()
        try:
            await asyncio.sleep(0.12)
            assert plane.samples >= 1 and plane.max_lag_s < 0.3
            time.sleep(0.5)                    # block the loop: a stall
            await asyncio.sleep(0.1)
            snap = plane.snapshot()
            assert plane.stalls >= 1 and snap["status"] == "stalled"
            assert "loop_stall" in [e["kind"] for e in snap["events"]]
            assert set(snap) == set(ref_health.PLANE.snapshot())
            plane.release()
            assert plane.active            # the second holder keeps it
        finally:
            plane.release()
        assert not plane.active
        off = health.HealthPlane()
        off.acquire(health.HealthConfig(enabled=False))
        with off.watchdog.section("piece.wire", 1.0, stage="wire"):
            pass
        assert not off.active
        assert off.watchdog.snapshot()["active_sections"] == []
        off.release()
    asyncio.run(go())


def test_format_stacks_walks_the_await_chain():
    async def go():
        async def inner():
            await asyncio.sleep(0.2)

        async def outer():
            await inner()

        t = asyncio.get_running_loop().create_task(outer(), name="deep-task")
        await asyncio.sleep(0.05)
        text = health.format_stacks()
        t.cancel()
        assert "outer" in text and "inner" in text and "deep-task" in text
    asyncio.run(go())


# ---------------------------------------------------------------- phasetimer

class _TickClock:
    """A ``perf_counter`` that advances exactly 1.0 s per call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _profile(pt, monkeypatch, script: str) -> dict:
    pt.reset()
    pt.arm()
    monkeypatch.setattr(time, "perf_counter", _TickClock())
    try:
        if script == "nested":
            with pt.ruling("find"):
                with pt.phase("filter"):
                    with pt.phase("dag-walk"):
                        pass
                with pt.phase("score"):
                    pass
                with pt.phase("emit"):
                    pass
        elif script == "record":
            with pt.ruling("refresh"):
                pt.record("exclusion", 2.0)
        elif script == "raises":
            with pytest.raises(RuntimeError):
                with pt.ruling("find"):
                    with pt.phase("filter"):
                        raise RuntimeError("boom")
        else:
            with pt.ruling("shard", queue_wait_s=0.25):
                pass
            pt.note_queue_wait(-5.0)
    finally:
        monkeypatch.undo()
    snap = pt.snapshot()
    pt.reset()
    for k in ("since",):
        snap.pop(k)
    snap["rulings"].pop("per_sec_60s")
    return snap


@pytest.mark.parametrize("script", ["nested", "record", "raises", "wait"])
def test_phasetimer_snapshots_equal_the_reference(script, monkeypatch):
    port = _profile(phasetimer, monkeypatch, script)
    assert port == _profile(ref_phasetimer, monkeypatch, script)
    if script == "nested":
        assert port["phases"]["dag-walk"]["self_ms"] == 1000.0
        assert port["phases"]["filter"]["self_ms"] == 2000.0
        assert port["rulings"]["by_kind"]["find"]["total_ms"] == 9000.0


def test_disarmed_phase_costs_under_10us_a_call():
    assert phasetimer.phase("filter") is phasetimer.ruling("find")
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        with phasetimer.phase("filter"):
            pass
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 10e-6, f"disarmed phase() cost {per_call * 1e9:.0f}ns"
    assert phasetimer.snapshot()["rulings"]["total"] == 0


def test_phasetimer_vocabularies_and_validation_are_the_reference():
    assert phasetimer.PHASES == ref_phasetimer.PHASES
    assert phasetimer.RULING_KINDS == ref_phasetimer.RULING_KINDS
    phasetimer.arm()
    with pytest.raises(ValueError, match="unknown phase"):
        phasetimer.phase("warpspeed")
    with pytest.raises(ValueError, match="unknown ruling kind"):
        phasetimer.ruling("decree")


def test_phasetimer_isolates_asyncio_tasks():
    phasetimer.arm()

    async def ruling(kind):
        with phasetimer.ruling(kind):
            with phasetimer.phase("score"):
                await asyncio.sleep(0.02)

    async def go():
        await asyncio.gather(ruling("find"), ruling("refresh"))
    asyncio.run(go())
    snap = phasetimer.snapshot()
    assert snap["rulings"]["total"] == 2
    assert snap["phases"]["score"]["count"] == 2
    assert snap["phases"]["score"]["total_ms"] < 2 * sum(
        r["total_ms"] for r in snap["rulings"]["by_kind"].values())


# ---------------------------------------------------------------- sizeof

class _Slots:
    __slots__ = ("a", "b")

    def __init__(self):
        self.a = [1.5, "x" * 40]
        self.b = {"k": (1, 2, 3)}


def _sizeof_cases():
    big = ["x" * 1024] * 32
    cyc: dict = {}
    cyc["self"] = {"back": cyc}
    return {"list": [1, 2.0, "three", b"four"], "shared": [big, big],
            "copied": [big, list(big)], "nested": {"a": {"b": [set([1, 2])]}},
            "cycle": cyc, "slots": _Slots(), "code": [len, deep_fn, _Slots]}


def deep_fn():
    return 0


@pytest.mark.parametrize("case", sorted(_sizeof_cases()))
def test_deep_sizeof_equals_the_reference(case):
    obj = _sizeof_cases()[case]
    assert sizeof.deep_sizeof(obj) == ref_sizeof.deep_sizeof(obj) > 0
    seen: set = set()
    sizeof.deep_sizeof(obj, seen)
    assert sizeof.deep_sizeof(obj, seen) == 0


# ---------------------------------------------------------------- cluster view

def _cluster_snapshot(pkg) -> dict:
    res_mod, view_mod, msg = ((ref_resource, ref_cluster_view, ref_msg)
                              if pkg == "ref" else
                              (port_resource, cluster_view, port_msg))
    res = res_mod.Resource()
    task = res.get_or_create_task("t" * 64, "u")

    def peer(pid, hid):
        host = res.store_host(msg.Host(id=hid, ip="127.0.0.1", port=1,
                                       download_port=2))
        return res.get_or_create_peer(pid, task, host)

    def result(dst, size=MiB, cost=10, ok=True):
        return msg.PieceResult(task_id=task.id, src_peer_id="child",
                               dst_peer_id=dst, success=ok,
                               piece_info=msg.PieceInfo(
                                   piece_num=0, range_size=size,
                                   download_cost_ms=cost))
    child = peer("child", "h-child")
    peer("fast", "h-fast")
    peer("slow", "h-slow")
    view = view_mod.ClusterView(ledger=None)
    for _ in range(8):
        view.on_piece(child, result("fast", cost=10))
        view.on_piece(child, result("slow", cost=500))
    view.on_piece(child, result("", size=2 * MiB, cost=50))
    view.on_piece(child, result("fast", ok=False))
    view.on_flight(child, {"task_id": task.id, "state": "success",
                           "pieces": 17, "bytes_p2p": 16 * MiB,
                           "bytes_source": 2 * MiB,
                           "back_to_source_ratio": 0.11,
                           "tail_ms": {"p50": 10}, "extra": 1})
    snap = view.snapshot()
    snap.pop("since")
    for h in snap["hosts"].values():
        h.pop("last_seen")
    return snap


def test_cluster_view_snapshot_equals_the_reference():
    port = _cluster_snapshot("port")
    assert port == _cluster_snapshot("ref")
    assert {s["host_id"] for s in port["stragglers"]} == {"h-slow"}
    assert port["hosts"]["h-fast"]["pieces_served"] == 8


DECISION_ROWS = [
    {"kind": "decision", "decision_id": f"d{i:08d}.peer{i % 3}",
     "decision_kind": ("find", "refresh", "shard")[i % 3],
     "task_id": ("aa" if i % 2 else "bb") + "t" * 62,
     "peer_id": f"peer{i % 3}", "created_at": 1000.0 + i,
     "candidates": [], "chosen": [f"p{i}"],
     "excluded": [{"peer_id": "x", "host_id": "h",
                   "reason": ("cycle", "no-slots")[i % 2]}]}
    for i in range(12)]


@pytest.mark.parametrize("query", ["", "?limit=3", "?task=aa", "?peer=peer1",
                                   "?task=bb&peer=peer0&limit=2"])
def test_debug_decisions_json_equals_the_reference(query):
    ref = ref_ledger.DecisionLedger()
    port = decision_ledger.DecisionLedger()
    for row in DECISION_ROWS:
        ref.on_decision(dict(row))
        port.on_decision(dict(row))
    q = dict(p.split("=") for p in query.lstrip("?").split("&") if p)
    want = ref.snapshot(task_id=q.get("task", ""),
                        peer_id=q.get("peer", ""),
                        limit=int(q.get("limit", "64")))

    async def go():
        srv = await debug_http.start_debug_server(
            "127.0.0.1", 0, extra_routes=lambda r:
            decision_ledger.add_decision_routes(r, port))
        try:
            return await asyncio.to_thread(
                _get, f"http://127.0.0.1:{srv.port}/debug/decisions{query}")
        finally:
            await srv.stop()
    status, body = asyncio.run(go())
    assert status == 200 and json.loads(body) == want
    assert port.state_bytes() == ref.state_bytes() > 0


# ---------------------------------------------------------------- debug HTTP

def test_debug_server_routes():
    """``/debug/stacks``, ``/debug/profile`` (one at a time, 409 while one
    runs, 400 for a bad window), ``/metrics``, ``/debug/health`` and
    ``/debug/ctrl`` with its live arm switch."""
    class _Comp:
        tasks: dict = {}

        def state_bytes(self):
            return 4096

    async def go():
        plane = health.PLANE
        plane.acquire()
        obs = CtrlObservatory(resource=_Comp(), ttl_s=0.0)
        srv = await debug_http.start_debug_server(
            "127.0.0.1", 0, extra_routes=lambda r: add_ctrl_routes(r, obs))
        base = f"http://127.0.0.1:{srv.port}"
        try:
            stacks = await asyncio.to_thread(_get, f"{base}/debug/stacks")
            prof = asyncio.ensure_future(asyncio.to_thread(
                _get, f"{base}/debug/profile?seconds=1"))
            await asyncio.sleep(0.3)
            busy = await asyncio.to_thread(_get,
                                           f"{base}/debug/profile?seconds=1")
            profile = await prof
            bad = await asyncio.to_thread(_get,
                                          f"{base}/debug/profile?seconds=x")
            metrics = await asyncio.to_thread(_get, f"{base}/metrics")
            hs = await asyncio.to_thread(_get, f"{base}/debug/health")
            dump = await asyncio.to_thread(_get, f"{base}/debug/health?dump=1")
            armed = await asyncio.to_thread(_get, f"{base}/debug/ctrl?arm=1")
            with phasetimer.ruling("find"):
                pass
            live = await asyncio.to_thread(_get, f"{base}/debug/ctrl")
            off = await asyncio.to_thread(_get, f"{base}/debug/ctrl?arm=0")
            missing = await asyncio.to_thread(_get, f"{base}/nope")
        finally:
            await srv.stop()
            plane.release()
        return (stacks, profile, busy, bad, metrics, hs, dump, armed, live,
                off, missing)
    (stacks, profile, busy, bad, metrics, hs, dump, armed, live, off,
     missing) = asyncio.run(go())
    assert stacks[0] == 200 and b"--- asyncio tasks ---" in stacks[1]
    assert profile[0] == 200 and b"function calls" in profile[1]
    assert busy[0] == 409 and bad[0] == 400
    assert metrics[0] == 200 and b"df_loop_lag_seconds" in metrics[1]
    snap = json.loads(hs[1])
    assert hs[0] == 200 and set(snap) == set(ref_health.PLANE.snapshot())
    assert dump[0] == 200 and b"--- thread" in dump[1]
    assert json.loads(armed[1])["armed"] is True
    live = json.loads(live[1])
    assert live["rulings"]["total"] == 1
    assert live["state_bytes"]["components"] == {"resource": 4096}
    assert json.loads(off[1])["armed"] is False and not phasetimer.ARMED
    assert missing[0] == 404


@pytest.mark.parametrize("debug_endpoints", [False, True])
def test_upload_server_debug_surface(tmp_path, debug_endpoints):
    """``/debug/health`` always; ``/debug/stacks``, ``/debug/profile`` and
    ``/debug/faults`` only with ``upload.debug_endpoints``."""
    cfg = DaemonConfig(workdir=str(tmp_path / "d"), hostname="d",
                       listen_ip="127.0.0.1", host_ip="127.0.0.1",
                       device="cpu")
    cfg.upload.debug_endpoints = debug_endpoints
    cfg.pex.enabled = False

    async def go():
        d = Daemon(cfg)
        await d.start()
        base = f"http://127.0.0.1:{d.upload_server.port}"
        try:
            out = {"health": await asyncio.to_thread(
                _get, f"{base}/debug/health"),
                "stacks": await asyncio.to_thread(_get,
                                                  f"{base}/debug/stacks"),
                "faults": await asyncio.to_thread(_get,
                                                  f"{base}/debug/faults")}
            if debug_endpoints:
                out["arm"] = await asyncio.to_thread(
                    _send, f"{base}/debug/faults", "POST",
                    b"piece.wire@abc=hang:2")
                out["armed"] = await asyncio.to_thread(
                    _get, f"{base}/debug/faults")
                out["bad"] = await asyncio.to_thread(
                    _send, f"{base}/debug/faults", "POST", b"nope=fail")
                out["reset"] = await asyncio.to_thread(
                    _send, f"{base}/debug/faults", "DELETE")
            return out
        finally:
            await d.stop()
    out = asyncio.run(go())
    status, body = out["health"]
    assert status == 200 and json.loads(body)["active"] is True
    if not debug_endpoints:
        assert out["stacks"][0] == 404 and out["faults"][0] == 404
        return
    assert out["stacks"][0] == 200
    assert json.loads(out["faults"][1]) == {"armed": False, "scripts": []}
    assert out["arm"][0] == 200
    armed = json.loads(out["armed"][1])
    assert armed["armed"] is True
    assert armed["scripts"][0]["site"] == "piece.wire"
    assert armed["scripts"][0]["remaining"] == 2
    assert set(armed["scripts"][0]) == {
        "site", "kind", "key", "remaining", "fired", "attempts", "pct",
        "code", "after_ms", "delay_s"}
    assert out["bad"][0] == 400
    assert json.loads(out["reset"][1]) == {"armed": False, "scripts": []}


# ---------------------------------------------------------------- one trace

def test_one_trace_spans_register_offer_fetch_serve_and_the_sink(tmp_path):
    """A seed, a scheduler (tracing to JSONL) and a leecher (tracing on) in
    one process: the leecher's ``peertask`` trace id covers the
    scheduler's ``sched.register`` / ``sched.offer`` (over the RPC
    metadata), its ``piece.download`` spans, the seed's ``upload.serve``
    (over the piece request's header) and ``hbm.ingest``; the flight
    summary reaches the cluster view with its SLO keys."""
    data = np.random.default_rng(5).integers(
        0, 256, 10 * MiB + 777, dtype=np.uint8).tobytes()
    origin = tmp_path / "w.bin"
    origin.write_bytes(data)
    url = f"file://{origin}"
    trace_path = str(tmp_path / "traces.jsonl")

    def dcfg(name, **kw):
        c = DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                         listen_ip="127.0.0.1", host_ip="127.0.0.1",
                         device="cpu", **kw)
        c.pex.enabled = False
        return c

    async def go():
        seed = Daemon(dcfg("seed", is_seed=True))
        await seed.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", tracing_jsonl=trace_path,
            seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await sched.start()
        leech = Daemon(dcfg(
            "leech", scheduler=DaemonSched(addresses=[sched.address]),
            tracing=TracingConfig(enabled=True, jsonl_path=trace_path)))
        await leech.start()
        try:
            task_id = None
            async for r in leech.ptm.start_file_task(port_msg.DownloadRequest(
                    url=url, disable_back_source=True, timeout_s=LIMIT_S,
                    device_sink=port_msg.DeviceSink(enabled=True))):
                task_id = r.task_id or task_id
            c = leech.ptm.conductor(task_id)
            got = c.device_ingest.result(10)
            flat = got.reshape(-1) if isinstance(got, torch.Tensor) else \
                torch.cat([t.reshape(-1) for t in got])
            assert flat.view(torch.uint8).numpy().tobytes() == data
            assert c.traffic_p2p == len(data) and c.traffic_source == 0
            summary = c.flight.summarize()
            assert "slo_breaches" in summary and summary["slo_budgets_ms"]
            for _ in range(100):
                host = sched.service.cluster.snapshot()["hosts"].get(
                    leech.host_info().id)
                if host is not None and host["flights"] > 0:
                    break
                await asyncio.sleep(0.05)
            assert host is not None and host["flights"] == 1
            assert host["last_flight"]["task_id"] == task_id
        finally:
            tracing.TRACER.flush()
            await leech.stop()
            await sched.stop()
            await seed.stop()
    asyncio.run(asyncio.wait_for(go(), LIMIT_S))
    with open(trace_path) as f:
        rows = [json.loads(ln) for ln in f]
    by_name: dict[str, list] = {}
    for r in rows:
        by_name.setdefault(r["name"], []).append(r)
    task_traces = {r["trace_id"] for r in by_name["peertask"]}
    for name in ("sched.register", "sched.offer", "piece.download",
                 "upload.serve", "hbm.ingest"):
        assert name in by_name, (name, sorted(by_name))
        assert {r["trace_id"] for r in by_name[name]} & task_traces, name


# ---------------------------------------------------------------- launchers

def _launch(name, tmp_path, *args):
    extra = []
    if name in ("trainer", "daemon"):
        cfg = tmp_path / f"{name}.json"
        body = {"device": "cpu"}
        if name == "daemon":
            body.update(host_ip="127.0.0.1", listen_ip="127.0.0.1",
                        hostname="dbg", workdir=str(tmp_path / "dw"))
        cfg.write_text(json.dumps(body))
        extra = ["--config", str(cfg)]
    if name == "trainer":
        extra += ["--listen-ip", "127.0.0.1", "--data-dir",
                  str(tmp_path / "td")]
    if name == "scheduler":
        extra += ["--listen-ip", "127.0.0.1", "--port", str(free_port())]
    if name == "manager":
        extra += ["--listen-ip", "127.0.0.1"]
    return Service(name, *extra, *args, workdir=tmp_path)


@pytest.mark.parametrize("name,routes", [
    ("scheduler", ["/debug/cluster", "/debug/decisions", "/debug/ctrl"]),
    ("manager", []), ("trainer", [])])
def test_launcher_debug_port_serves_the_routes(name, routes, tmp_path):
    trace = str(tmp_path / "t.jsonl")
    args = ["--debug-port", "-1"]
    if name == "scheduler":
        args += ["--tracing-jsonl", trace]
    svc = _launch(name, tmp_path, *args)
    try:
        line = svc.wait_line("debug on :")
        svc.wait_line(f"{name} up:")
        base = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        for path in ["/debug/stacks", "/debug/profile?seconds=0.2",
                     "/metrics", "/debug/health"] + routes:
            status, body = _get(base + path)
            assert status == 200, (path, body[:200])
        ctrl = json.loads(_get(base + "/debug/ctrl?arm=1")[1]) \
            if routes else None
    finally:
        assert svc.stop() == 0, svc.text()
    if ctrl is not None:
        assert ctrl["armed"] is True
        # the default scheduler arms the quarantine registry; federation
        # is off, and a disabled component is skipped
        assert set(ctrl["state_bytes"]["components"]) == {
            "resource", "ledger", "quarantine", "shard_affinity"}


def test_daemon_launcher_serves_its_debug_endpoints_and_traces(tmp_path):
    trace = str(tmp_path / "daemon-traces.jsonl")
    svc = _launch("daemon", tmp_path, "--debug-endpoints", "--tracing-jsonl",
                  trace)
    try:
        svc.wait_line("daemon up:")
        line = svc.wait_line("upload server on")
        base = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        for path in ("/debug/health", "/debug/stacks",
                     "/debug/profile?seconds=0.2", "/debug/faults"):
            status, body = _get(base + path)
            assert status == 200, (path, body[:200])
    finally:
        assert svc.stop() == 0, svc.text()


@pytest.mark.parametrize("argv,names", [
    (["--auth"], "REST auth"),
    (["--auth", "--debug-port", "-1"], "REST auth")])
def test_auth_and_issue_certs_still_exit_2(argv, names, tmp_path):
    """``--auth`` (``names``; it exited 2 until REST auth was ported)
    starts a manager, beside its debug port when one is asked for: the
    public ``/healthy`` and ``/metrics`` answer 200 and a route without
    credentials 401."""
    svc = _launch("manager", tmp_path, "--workdir", str(tmp_path / "mw"),
                  *argv)
    try:
        debug = None
        if "--debug-port" in argv:
            line = svc.wait_line("debug on :")
            debug = _get(f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
                         "/debug/health")[0]
        rest = int(svc.wait_line(" rest=:").rsplit(":", 1)[1])
        base = f"http://127.0.0.1:{rest}"
        got = [_get(base + p)[0]
               for p in ("/healthy", "/metrics", "/api/v1/schedulers")]
    finally:
        assert svc.stop() == 0, svc.text()
    assert got == [200, 200, 401], (names, got)
    assert debug == (200 if "--debug-port" in argv else None)
    assert "not ported" not in svc.text()


def test_issue_certs_starts_a_manager_with_its_debug_port(tmp_path):
    """``--issue-certs`` (it exited 2 until fleet mTLS was ported) starts
    a manager beside its debug port; the CA and the issuance token land
    in the workdir, the token at mode 0600."""
    svc = _launch("manager", tmp_path, "--issue-certs", "--workdir",
                  str(tmp_path / "mw"), "--debug-port", "-1")
    try:
        line = svc.wait_line("debug on :")
        svc.wait_line("manager up:")
        base = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        status, _ = _get(base + "/debug/health")
    finally:
        assert svc.stop() == 0, svc.text()
    assert status == 200
    assert "not ported" not in svc.text()
    assert (tmp_path / "mw" / "manager-ca" / "proxy-ca.crt").exists()
    assert os.stat(tmp_path / "mw" / "issuer.token").st_mode & 0o777 == 0o600
