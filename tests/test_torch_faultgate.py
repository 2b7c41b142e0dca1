"""The port's faultgate against the reference's, whole.

* The reference's ``TestFaultgate`` cases (``tests/test_faults.py``) run on
  both packages.
* Seeded script sequences with ``pct`` in {1, 25, 30, 33, 99, 100} and
  1,000 interleaved ``fire`` / ``corrupt`` / ``peek`` calls give equal
  fire patterns and equal ``describe()`` rows in both.
* ``after_ms`` becomes the raised error's ``retry_after_ms``, and a port
  daemon's back-source waits at least that long after an injected origin
  503 (the reference's ``TestOriginRetryAfter`` case).
* The two RPC sites through a real port RPC server: ``rpc.unary=fail:n=2``
  succeeds on the third attempt, ``n=-1`` ends ``UNAVAILABLE``, ``hang``
  under a timeout is ``DEADLINE_EXCEEDED`` with the reference's text, and
  an ``rpc.stream.read`` script ends a server stream and leaves unary
  calls untouched.
* A script with a bad clause: the reference arms the clauses before it,
  the port arms none (ROADMAP known difference 70).
"""

import asyncio
import os
import sys
import time

import numpy as np
import pytest

from dragonfly2_tpu.common import faultgate as ref_faultgate
from dragonfly2_tpu.common.errors import Code as RefCode
from dragonfly2_tpu.common.errors import DFError as RefDFError
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.common import faultgate as port_faultgate
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.rpc import (Channel, RPCServer, ServiceClient,
                                      ServiceDef)

sys.path.insert(0, os.path.dirname(__file__))
from torch_origin import Origin  # noqa: E402

LIMIT_S = 20.0
GATES = {"reference": (ref_faultgate, RefCode, RefDFError),
         "port": (port_faultgate, Code, DFError)}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


@pytest.fixture(autouse=True)
def _disarm():
    ref_faultgate.reset()
    port_faultgate.reset()
    yield
    ref_faultgate.reset()
    port_faultgate.reset()


# ------------------------------------------------ the reference's cases

@pytest.mark.parametrize("pkg", sorted(GATES))
class TestFaultgate:
    def test_unknown_site_and_kind_rejected(self, pkg):
        fg, _, _ = GATES[pkg]
        with pytest.raises(ValueError, match="unknown faultgate site"):
            fg.arm("nope.nope", "fail")
        with pytest.raises(ValueError, match="unknown fault kind"):
            fg.arm("rpc.unary", "explode")
        with pytest.raises(ValueError, match="bad faultgate clause"):
            fg.arm_script("rpc.unary")

    def test_fail_n_then_succeed(self, pkg):
        fg, code, err = GATES[pkg]
        script = fg.arm_script("rpc.unary=fail:n=2")[0]
        assert fg.ARMED

        async def go():
            for _ in range(2):
                with pytest.raises(err) as ei:
                    await fg.fire("rpc.unary", key="any")
                assert ei.value.code == code.UNAVAILABLE
            await fg.fire("rpc.unary", key="any")   # exhausted: no-op

        run(go())
        assert script.fired == 2
        assert not fg.ARMED

    def test_key_scoping(self, pkg):
        fg, _, err = GATES[pkg]
        fg.arm("sched.register", "fail", key="127.0.0.1:9000", n=-1)

        async def go():
            await fg.fire("sched.register", key="127.0.0.1:9001")
            with pytest.raises(err):
                await fg.fire("sched.register", key="127.0.0.1:9000")

        run(go())

    def test_error_carries_retry_hint(self, pkg):
        fg, code, err = GATES[pkg]
        fg.arm_script("source.fetch=error:code=SOURCE_ERROR:after_ms=400")

        async def go():
            with pytest.raises(err) as ei:
                await fg.fire("source.fetch", key="http://x/y")
            assert ei.value.code == code.SOURCE_ERROR
            assert ei.value.retry_after_ms == 400

        run(go())

    def test_corrupt_flips_then_passthrough(self, pkg):
        fg, _, _ = GATES[pkg]
        fg.arm("piece.wire", "corrupt", n=1)
        data = b"\x00\x01\x02"
        flipped = fg.corrupt("piece.wire", data)
        assert flipped != data and flipped[1:] == data[1:]
        assert fg.corrupt("piece.wire", data) == data   # consumed

    def test_fire_sync_raises(self, pkg):
        fg, code, err = GATES[pkg]
        fg.arm("hbm.ingest", "fail", code=code.INTERNAL)
        with pytest.raises(err) as ei:
            fg.fire_sync("hbm.ingest")
        assert ei.value.code == code.INTERNAL

    def test_reset_disarms(self, pkg):
        fg, _, _ = GATES[pkg]
        fg.arm("rpc.unary", "fail")
        assert fg.ARMED
        fg.reset()
        assert not fg.ARMED
        assert fg.status() == {"armed": False, "scripts": []}


def test_the_two_packages_know_the_same_sites_and_kinds():
    assert port_faultgate.SITES == ref_faultgate.SITES
    assert port_faultgate.KINDS == ref_faultgate.KINDS
    assert len(port_faultgate.SITES) == 10


@pytest.mark.parametrize("pct", [0, 101, -5])
def test_pct_outside_1_to_100_is_the_references_error(pct):
    texts = []
    for fg in (ref_faultgate, port_faultgate):
        with pytest.raises(ValueError) as ei:
            fg.arm_script(f"upload.serve=corrupt:pct={pct}:n=-1")
        texts.append(str(ei.value))
    assert texts[0] == texts[1] == f"pct must be 1-100, got {pct!r}"
    assert not port_faultgate.ARMED


# --------------------------------------------- seeded script sequences

_SITES = ("upload.serve", "piece.wire", "pex.gossip")
_KEYS = ("", "h1", "h2|t9")


def _script_text(rng: np.random.Generator, pct: int) -> str:
    """Four to six clauses on three sites, some key-scoped, raising or
    corrupting, with a fire budget or forever; every clause at ``pct``
    except one at 100 so scripts of two strides interleave."""
    clauses = []
    for i in range(int(rng.integers(4, 7))):
        site = _SITES[int(rng.integers(len(_SITES)))]
        key = _KEYS[int(rng.integers(len(_KEYS)))]
        kind = ("corrupt", "fail", "error")[int(rng.integers(3))]
        n = int(rng.choice([-1, 1, 3, 40]))
        p = 100 if i == 0 else pct
        head = f"{site}@{key}" if key else site
        clauses.append(f"{head}={kind}:n={n}:pct={p}"
                       + (":after_ms=250" if kind == "error" else ""))
    return ";".join(clauses)


async def _drive(fg, rng: np.random.Generator, calls: int) -> list:
    out = []
    for _ in range(calls):
        op = int(rng.integers(3))
        site = _SITES[int(rng.integers(len(_SITES)))]
        key = ("h1|t9", "h2|t9", "h3|t1")[int(rng.integers(3))]
        if op == 0:
            try:
                await fg.fire(site, key=key)
                out.append(("fire", None))
            except Exception as exc:  # noqa: BLE001 - the DFError's fields
                out.append(("fire", int(exc.code),
                            getattr(exc, "retry_after_ms", None), str(exc)))
        elif op == 1:
            got = fg.corrupt(site, b"\x10\x20", key=key)
            out.append(("corrupt", got))
        else:
            out.append(("peek", fg.peek(site, key)))
    return out


@pytest.mark.parametrize("pct", [1, 25, 30, 33, 99, 100])
def test_seeded_sequences_fire_alike(pct):
    seed = 1000 + pct
    text = _script_text(np.random.default_rng(seed), pct)
    got = {}
    for name, (fg, _, _) in GATES.items():
        fg.reset()
        fg.arm_script(text)
        pattern = run(_drive(fg, np.random.default_rng(seed + 1), 1000))
        got[name] = (pattern, fg.status())
        fg.reset()
    assert got["port"] == got["reference"]
    rows = got["port"][1]["scripts"]
    assert sum(r["attempts"] for r in rows) > 0
    if pct < 100:
        # the stride held some attempts back
        assert any(r["attempts"] > r["fired"] for r in rows)


def test_pct_stride_is_the_formula():
    for pct in (1, 25, 30, 33, 99):
        s = port_faultgate.arm("upload.serve", "corrupt", n=-1, pct=pct)
        fires = [bool(port_faultgate.corrupt("upload.serve", b"x") != b"x")
                 for _ in range(300)]
        want = [(k * pct) // 100 > ((k - 1) * pct) // 100
                for k in range(1, 301)]
        assert fires == want
        assert s.fired == sum(want) and s.attempts == 300
        port_faultgate.reset()


def test_peek_neither_fires_nor_strides():
    s = port_faultgate.arm("upload.serve", "corrupt", n=-1, pct=30)
    for _ in range(50):
        assert port_faultgate.peek("upload.serve", "h|t")
    assert (s.attempts, s.fired) == (0, 0)


def test_corrupt_counts_an_empty_serve():
    """The counter moves for a claimed script even when there is no byte
    to flip, as the reference's does."""
    def count() -> float:
        return port_faultgate._injected.value("piece.wire", "corrupt")

    before = count()
    port_faultgate.arm("piece.wire", "corrupt", n=1)
    assert port_faultgate.corrupt("piece.wire", b"") == b""
    assert count() == before + 1
    assert not port_faultgate.ARMED


# ------------------------------------------------ after_ms -> the hint

@pytest.mark.parametrize("pkg", sorted(GATES))
def test_after_ms_rides_sync_and_async_fires(pkg):
    fg, code, err = GATES[pkg]
    fg.arm_script("hbm.ingest=fail:after_ms=700;"
                  "source.fetch=error:code=SOURCE_ERROR:after_ms=400")
    with pytest.raises(err) as ei:
        fg.fire_sync("hbm.ingest")
    assert ei.value.retry_after_ms == 700

    async def go():
        with pytest.raises(err) as ei:
            await fg.fire("source.fetch", key="http://x/y")
        return ei.value

    e = run(go())
    assert (e.code, e.retry_after_ms) == (code.SOURCE_ERROR, 400)
    rows = fg.status()["scripts"]
    assert [r["after_ms"] for r in rows] == [700, 400]
    fg.arm("rpc.unary", "fail")

    async def bare():
        with pytest.raises(err) as ei:
            await fg.fire("rpc.unary")
        return ei.value

    assert not hasattr(run(bare()), "retry_after_ms")


def test_origin_503_retry_after_honored(tmp_path):
    """The reference's ``TestOriginRetryAfter`` case on a port daemon: an
    injected origin failure with ``after_ms=400`` makes the back-source
    wait at least the hint before its retry succeeds."""
    data = os.urandom(300_000)

    async def go():
        d = Daemon(DaemonConfig(workdir=str(tmp_path / "ra"), hostname="ra",
                                listen_ip="127.0.0.1", host_ip="127.0.0.1",
                                device="cpu"))
        d.cfg.pex.enabled = False
        await d.start()
        script = port_faultgate.arm("source.fetch", "error",
                                    code=Code.SOURCE_ERROR, after_ms=400,
                                    n=1)
        try:
            with Origin({"f.bin": data}) as o:
                url = f"{o.base}/f.bin"
                t0 = time.monotonic()
                task_id = None
                async for resp in d.ptm.start_file_task(
                        port_msg.DownloadRequest(
                            url=url, output=str(tmp_path / "o.bin"),
                            timeout_s=LIMIT_S)):
                    task_id = resp.task_id or task_id
                elapsed = time.monotonic() - t0
            c = d.ptm.conductor(task_id)
            return elapsed, script.fired, c.state, c.SUCCESS
        finally:
            await d.stop()

    elapsed, fired, state, success = run(go())
    assert (tmp_path / "o.bin").read_bytes() == data
    assert fired == 1 and state == success
    assert elapsed >= 0.35, f"Retry-After hint not honored: {elapsed:.3f}s"


# ---------------------------------------------------- the two RPC sites

def _service(calls: list) -> ServiceDef:
    svc = ServiceDef("test.Gate")

    async def unary(req, ctx):
        calls.append(req.piece_num)
        return port_msg.PieceInfo(piece_num=req.piece_num + 1)

    async def stream(req, ctx):
        for i in range(req.piece_num):
            yield port_msg.PieceInfo(piece_num=i)
            await asyncio.sleep(0)

    svc.unary_unary("Unary", unary)
    svc.unary_stream("Stream", stream)
    return svc


async def _with_server(fn):
    calls: list = []
    srv = RPCServer("127.0.0.1:0")
    srv.register(_service(calls))
    await srv.start()
    ch = Channel(f"127.0.0.1:{srv.port}")
    try:
        return await fn(ch, calls)
    finally:
        await ch.close()
        await srv.stop()


def test_rpc_unary_fail_twice_then_the_retry_ladder_succeeds():
    async def go(ch, calls):
        script = port_faultgate.arm_script("rpc.unary=fail:n=2")[0]
        c = ServiceClient(ch, "test.Gate", base_backoff=0.01)
        got = await c.unary("Unary", port_msg.PieceInfo(piece_num=4))
        return got.piece_num, script.fired, list(calls)

    assert run(_with_server(go)) == (5, 2, [4])
    assert not port_faultgate.ARMED


def test_rpc_unary_forever_ends_unavailable():
    async def go(ch, calls):
        script = port_faultgate.arm_script("rpc.unary=fail:n=-1")[0]
        c = ServiceClient(ch, "test.Gate", base_backoff=0.01)
        with pytest.raises(DFError) as ei:
            await c.unary("Unary", port_msg.PieceInfo(piece_num=4))
        return ei.value.code, script.fired, list(calls)

    assert run(_with_server(go)) == (Code.UNAVAILABLE, 3, [])


def test_rpc_unary_hang_under_a_timeout_is_the_deadline():
    async def go(ch, calls):
        port_faultgate.arm_script(f"rpc.unary@{ch.address}=hang:n=1")
        c = ServiceClient(ch, "test.Gate", max_attempts=1)
        t0 = time.monotonic()
        with pytest.raises(DFError) as ei:
            await c.unary("Unary", port_msg.PieceInfo(piece_num=1),
                          timeout=0.2)
        return ei.value, time.monotonic() - t0, ch.address

    err, took, addr = run(_with_server(go))
    assert err.code == Code.DEADLINE_EXCEEDED
    assert err.message == (f"{addr}/test.Gate/Unary: deadline during "
                           "injected fault")
    assert took < 2.0


def test_rpc_stream_read_ends_a_stream_and_spares_unary_calls():
    async def go(ch, calls):
        script = port_faultgate.arm_script("rpc.stream.read=fail:n=-1")[0]
        c = ServiceClient(ch, "test.Gate")
        # unary calls read through the call's own read: never the site
        got = [(await c.unary("Unary", port_msg.PieceInfo(piece_num=i)))
               .piece_num for i in range(3)]
        fired_after_unary = script.fired
        stream = c.unary_stream("Stream", port_msg.PieceInfo(piece_num=5))
        with pytest.raises(DFError) as ei:
            await stream.read()
        fired = script.fired
        port_faultgate.reset()
        nums = [m.piece_num async for m in c.unary_stream(
            "Stream", port_msg.PieceInfo(piece_num=3))]
        return got, fired_after_unary, ei.value.code, fired, nums

    got, before, code, fired, nums = run(_with_server(go))
    assert got == [1, 2, 3] and before == 0
    assert code == Code.UNAVAILABLE and fired == 1
    assert nums == [0, 1, 2]


def test_an_injected_stream_read_failure_ends_the_port_call():
    """Known difference 72: the port cancels a stream call whose read an
    ``rpc.stream.read`` script failed (its connection is released, as a
    transport failure releases it), so the next read of that stream
    raises; the reference leaves its grpc call open."""
    async def go(ch, calls):
        port_faultgate.arm_script("rpc.stream.read=fail:n=1")
        c = ServiceClient(ch, "test.Gate")
        stream = c.unary_stream("Stream", port_msg.PieceInfo(piece_num=5))
        with pytest.raises(DFError) as first:
            await stream.read()
        assert not port_faultgate.ARMED
        with pytest.raises(DFError) as second:
            await stream.read()
        return first.value.code, second.value, stream.call._cancelled

    code, second, cancelled = run(_with_server(go))
    assert code == Code.UNAVAILABLE and cancelled
    assert second.code == Code.CLIENT_CONTEXT_CANCELED
    assert second.message.endswith("/test.Gate/Stream: call cancelled")


# --------------------------------------------------------- the half-arm

HALF = "piece.wire=delay:0.1:n=1;bogus.site=fail"


def test_a_bad_clause_arms_nothing_in_the_port():
    """The reference arms clause by clause and keeps the first clause of
    ``HALF`` armed when the second raises; the port parses every clause
    first and arms none. Both raise the same error."""
    texts = {}
    for name, (fg, _, _) in GATES.items():
        with pytest.raises(ValueError) as ei:
            fg.arm_script(HALF)
        texts[name] = str(ei.value)
    assert texts["port"] == texts["reference"]
    assert [r["site"] for r in ref_faultgate.status()["scripts"]] \
        == ["piece.wire"]
    assert port_faultgate.status() == {"armed": False, "scripts": []}


def test_debug_faults_refuses_a_bad_script_whole(tmp_path):
    import json
    import urllib.error
    import urllib.request

    def post(url: str, body: bytes) -> tuple[int, dict]:
        req = urllib.request.Request(url, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    async def go():
        cfg = DaemonConfig(workdir=str(tmp_path / "dbg"), hostname="dbg",
                           listen_ip="127.0.0.1", host_ip="127.0.0.1",
                           device="cpu")
        cfg.upload.debug_endpoints = True
        cfg.pex.enabled = False
        d = Daemon(cfg)
        await d.start()
        base = f"http://127.0.0.1:{d.upload_server.port}/debug/faults"
        try:
            bad = await asyncio.to_thread(post, base, HALF.encode())
            good = await asyncio.to_thread(
                post, base, b"upload.serve=corrupt:pct=30:n=-1")
            return bad, good, port_faultgate.status()
        finally:
            await d.stop()

    bad, good, status = run(go())
    assert bad[0] == 400 and "unknown faultgate site" in bad[1]["error"]
    assert good[0] == 200
    assert [(r["site"], r["pct"], r["remaining"]) for r in status["scripts"]] \
        == [("upload.serve", 30, -1)]
