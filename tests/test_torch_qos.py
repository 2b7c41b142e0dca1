"""The multi-tenant QoS plane on the port, against the reference's.

The reference's ``tests/test_qos.py`` classes that this slice ports, each
run as one script through the reference's class and the port's, with the
results compared: the token bucket's edges and ``class_shares``, the
traffic shaper's class split, the governor's ladder (normal, brownout
queue, shed with retry-after) and its snapshot, the upload server's
class-aware gate, the class threading (``UrlMeta`` -> conductor -> shaper
-> piece GET ``?cls=``, through the pex rung's synthetic session), the
scheduler's class resolution, tenant quotas, bulk preemption with its
decision row and the per-class fan-out caps, the manager's tenant table
(``TenantEntry`` and ``ListTenantsResponse`` compared byte for byte), and
dfdiag's ``--qos`` verdict. ``TestClassSloBudgets`` and
``TestClassWeightedEviction`` cover parts ported earlier; the reference's
``tests/test_priority.py`` (priority resolution, the back-source budget,
LEVEL1/LEVEL2, priority-ordered GC) is held here too.

Tolerances: exact, except the token bucket's waits (wall-clock: within
0.05 s of the reference's) and the governor's ``state_since_s``, which
is left out.
"""

import asyncio
import json
import random
import socket
import time

import pytest

from dragonfly2_tpu.common import rate as ref_rate
from dragonfly2_tpu.common.errors import DFError as RefDFError
from dragonfly2_tpu.daemon import qos as ref_qos
from dragonfly2_tpu.daemon import traffic_shaper as ref_shaper
from dragonfly2_tpu.idl import messages as ref_msgs
from dragonfly2_tpu.idl.base import dumps as ref_dumps
from dragonfly2_tpu.tools import dfdiag as ref_dfdiag
from dragonfly2_tpu_torch.common import rate
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.daemon import qos, traffic_shaper
from dragonfly2_tpu_torch.idl import messages as msgs
from dragonfly2_tpu_torch.idl.base import dumps
from dragonfly2_tpu_torch.tools import dfdiag

BOTH = [pytest.param("ref", id="reference"), pytest.param("port", id="port")]


def _run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# common/rate.py: the token bucket's edges and the class split
# ---------------------------------------------------------------------------

def _bucket_script(mod) -> list:
    """The reference's ``TestTokenBucketEdges`` cases as one script;
    returns what each step observed."""
    TB = mod.TokenBucket
    out = [TB(10).burst, TB(0.5).burst]
    b = TB(0)
    out += [b.try_acquire(1 << 40), b.reserve(1 << 40)]
    b.refund(1 << 40)
    out.append(b.reserve(1))
    b = TB(100, burst=100)
    out += [b.reserve(100), b.reserve(50)]
    b = TB(100, burst=100)
    b.reserve(100)
    out.append(b.reserve(100))
    b.refund(100)
    out.append(b.reserve(100))
    b.refund(100)
    b.refund(100)
    out += [b._tokens <= b.burst + 1e-9, b.reserve(100)]
    b = TB(100, burst=10)
    b._unreserve(1000)
    out.append(b._tokens)
    b = TB(1000, burst=1000)
    b.reserve(1000)
    b.reserve(500)
    b.set_rate(50)
    out += [b.burst, b.reserve(0)]
    b.refund(5000)
    out.append(b._tokens <= b.burst + 1e-9)

    async def cancelled():
        b = TB(100, burst=1)
        await b.acquire(1)
        t = asyncio.create_task(b.acquire(200))
        await asyncio.sleep(0.01)
        t.cancel()
        try:
            await t
        except asyncio.CancelledError:
            pass
        return b.reserve(0)
    out.append(_run(cancelled()))
    return out


class TestTokenBucketEdges:
    def test_the_edges_match_the_reference(self):
        got, want = _bucket_script(rate), _bucket_script(ref_rate)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, bool):
                assert g is w
            else:
                assert g == pytest.approx(w, abs=0.05)

    @pytest.mark.parametrize("impl", BOTH)
    def test_the_reference_assertions_hold(self, impl):
        got = _bucket_script(ref_rate if impl == "ref" else rate)
        assert got[:2] == [10.0, 1.0]
        assert got[2] is True and got[3] == 0.0 and got[4] == 0.0
        assert got[5] == 0.0 and got[6] == pytest.approx(0.5, rel=0.05)
        assert got[7] == pytest.approx(1.0, rel=0.05)
        assert got[8] == pytest.approx(1.0, rel=0.05)
        assert got[9] is True and got[10] == pytest.approx(0.0, abs=0.01)
        assert got[11] == 10.0
        assert got[12] == 50.0 and got[13] == pytest.approx(10.0, rel=0.1)
        assert got[14] is True and got[15] <= 0.05

    def test_refund_at_rate_zero_is_the_references(self):
        """The port's refund returned early at rate 0; it now clamps at
        the burst as the reference's ``_unreserve`` does."""
        for mod in (rate, ref_rate):
            b = mod.TokenBucket(0)
            b.refund(5)
            assert b._tokens == b.burst == 1.0
        b = rate.TokenBucket(0)
        b.refund(5)
        b.set_rate(100)
        r = ref_rate.TokenBucket(0)
        r.refund(5)
        r.set_rate(100)
        assert b._tokens == r._tokens and b.burst == r.burst


class TestClassShares:
    WEIGHTS = {"critical": 8.0, "standard": 3.0, "bulk": 1.0}

    def test_seeded_demands_split_as_the_reference(self):
        rng = random.Random(11)
        classes = list(self.WEIGHTS)
        for _ in range(300):
            total = rng.choice([0.0, 90.0, 1.5e9, rng.uniform(0, 1e10)])
            demand = {c: rng.choice([0.0, 1.0, rng.uniform(0, 1e6)])
                      for c in rng.sample(classes, rng.randint(0, 3))}
            assert rate.class_shares(total, self.WEIGHTS, demand) \
                == ref_rate.class_shares(total, self.WEIGHTS, demand)

    def test_the_reference_cases(self):
        s = rate.class_shares(90.0, self.WEIGHTS, {"bulk": 5.0})
        assert s["bulk"] == 90.0 and s["critical"] == 0.0
        s = rate.class_shares(90.0, self.WEIGHTS,
                              {"critical": 1.0, "bulk": 1.0})
        assert s["critical"] == pytest.approx(80.0)
        assert s["bulk"] == pytest.approx(10.0)
        assert all(v == 0.0 for v in rate.class_shares(
            0.0, self.WEIGHTS, {"bulk": 1.0}).values())
        assert all(v == 0.0 for v in rate.class_shares(
            90.0, self.WEIGHTS, {}).values())


# ---------------------------------------------------------------------------
# the traffic shaper's class split
# ---------------------------------------------------------------------------

def _shaper_script(mod, seed: int, kind: str) -> list:
    """Seeded registers, records, retunes and unregisters; returns each
    task's rate after every retune and the class snapshots."""
    rng = random.Random(seed)
    sh = mod.TrafficShaper(total_rate_bps=9e6, kind=kind)
    live: list[str] = []
    out = []
    for step in range(60):
        op = rng.random()
        if op < 0.35 or not live:
            tid = f"t{step:03d}".ljust(64, "0")
            sh.register(tid, qos_class=rng.choice(
                ["critical", "standard", "bulk", "", "gold"]),
                tenant=rng.choice(["", "svc", "batch"]))
            live.append(tid)
        elif op < 0.75:
            sh.record(rng.choice(live), rng.randint(1, 1 << 22))
        elif op < 0.85:
            sh.unregister(live.pop(rng.randrange(len(live))))
        else:
            sh._retune()
        out.append({tid: (e.cls, e.tenant, e.rate, e.consumed)
                    for tid, e in sorted(sh._tasks.items())})
    out.append(sh.class_snapshot())
    return out


class TestShaperClassSplit:
    @pytest.mark.parametrize("kind", ["sampling", "plain"])
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_seeded_script_matches_the_reference(self, kind, seed):
        assert _shaper_script(traffic_shaper, seed, kind) \
            == _shaper_script(ref_shaper, seed, kind)

    def test_weights_and_constants_are_the_references(self):
        assert traffic_shaper.CLASS_WEIGHTS == ref_shaper.CLASS_WEIGHTS
        assert traffic_shaper.SAMPLE_INTERVAL_S \
            == ref_shaper.SAMPLE_INTERVAL_S
        assert traffic_shaper.MIN_SHARE_RATIO == ref_shaper.MIN_SHARE_RATIO

    def test_critical_out_earns_bulk_under_contention(self):
        sh = traffic_shaper.TrafficShaper(total_rate_bps=9e6)
        sh.register("c" * 8, qos_class="critical", tenant="svc")
        sh.register("b" * 8, qos_class="bulk", tenant="batch")
        sh.record("c" * 8, 1 << 20)
        sh.record("b" * 8, 1 << 20)
        sh._retune()
        crit, bulk = sh._tasks["c" * 8].rate, sh._tasks["b" * 8].rate
        assert crit > 5 * bulk
        assert crit + bulk == pytest.approx(9e6, rel=0.01)
        sh.unregister("c" * 8)
        sh.record("b" * 8, 1 << 20)
        sh._retune()
        assert sh._tasks["b" * 8].rate == pytest.approx(9e6, rel=0.01)
        # the task's bucket is the one the conductor paces with
        assert sh._tasks["b" * 8].bucket.rate == sh._tasks["b" * 8].rate

    def test_retune_loop_runs_only_with_a_budget(self):
        async def main():
            idle = traffic_shaper.TrafficShaper(total_rate_bps=0)
            idle.start()
            busy = traffic_shaper.TrafficShaper(total_rate_bps=1e6)
            busy.start()
            try:
                return idle._loop_task, busy._loop_task is not None
            finally:
                await idle.stop()
                await busy.stop()
        assert _run(main()) == (None, True)


# ---------------------------------------------------------------------------
# the admission governor's ladder
# ---------------------------------------------------------------------------

def _snap(g) -> dict:
    s = g.snapshot()
    s.pop("state_since_s")
    return s


async def _governor_script(mod, err_cls) -> list:
    """The reference's ``TestGovernor`` cases in one script; returns the
    rulings, errors and snapshots seen."""
    out = []
    G, S = mod.QosGovernor, mod.QosSection
    g = G(S(bulk_active_limit=1))
    for _ in range(3):
        out.append(await g.admit("critical", "svc"))
    out.append(await g.admit("gold"))
    out.append(_snap(g))
    for _ in range(3):
        g.release("critical")
    g.release("gold")
    out.append(_snap(g))
    # brownout queue, then admit on release
    g = G(S(bulk_active_limit=1, queue_wait_s=5.0))
    out.append(await g.admit("bulk", "t1"))
    waiter = asyncio.create_task(g.admit("bulk", "t2"))
    await asyncio.sleep(0.02)
    out.append((g.state, waiter.done()))
    g.release("bulk")
    out.append(await asyncio.wait_for(waiter, 1.0))
    g.release("bulk")
    out.append(_snap(g))
    # foreground pressure; several waiters woken by one release
    g = G(S(bulk_active_limit=8, queue_wait_s=5.0))
    await g.admit("critical", "svc")
    waiters = [asyncio.create_task(g.admit("bulk", f"t{i}"))
               for i in range(4)]
    await asyncio.sleep(0.02)
    out.append((g.state, [w.done() for w in waiters]))
    g.release("critical")
    out.append(await asyncio.wait_for(asyncio.gather(*waiters), 1.0))
    out.append(_snap(g))
    for _ in range(4):
        g.release("bulk")
    out.append(_snap(g))
    # shed on queue timeout, with the retry-after hint
    g = G(S(bulk_active_limit=1, queue_wait_s=0.05, shed_retry_after_ms=1234))
    await g.admit("bulk")
    try:
        await g.admit("bulk", "noisy")
        out.append("admitted")
    except err_cls as exc:
        out.append((int(exc.code), exc.retry_after_ms, g.state))
    g.release("bulk")
    out.append(_snap(g))
    # shed at once when the queue is full
    g = G(S(bulk_active_limit=1, queue_limit=0, queue_wait_s=5.0))
    await g.admit("bulk")
    try:
        await g.admit("bulk")
        out.append("admitted")
    except err_cls as exc:
        out.append((int(exc.code), exc.retry_after_ms, g.state))
    out.append(_snap(g))
    # a cancelled waiter never strands a wake
    g = G(S(bulk_active_limit=1, queue_wait_s=5.0))
    await g.admit("bulk")
    w1 = asyncio.create_task(g.admit("bulk", "a"))
    w2 = asyncio.create_task(g.admit("bulk", "b"))
    await asyncio.sleep(0.02)
    w1.cancel()
    try:
        await w1
    except asyncio.CancelledError:
        out.append("cancelled")
    g.release("bulk")
    out.append(await asyncio.wait_for(w2, 1.0))
    g.release("bulk")
    out.append(_snap(g))
    # disabled: admits everything
    g = G(S(enabled=False, bulk_active_limit=0))
    for _ in range(5):
        out.append(await g.admit("bulk"))
    out.append(_snap(g))
    return out


class TestGovernor:
    def test_script_matches_the_reference(self):
        got = _run(_governor_script(qos, DFError))
        want = _run(_governor_script(ref_qos, RefDFError))
        assert got == want

    def test_the_reference_assertions_hold(self):
        got = _run(_governor_script(qos, DFError))
        assert got[:4] == [("critical", "ok")] * 3 + [("standard", "ok")]
        assert got[4]["active"]["critical"] == 3
        assert got[5]["active"] == {"critical": 0, "standard": 0, "bulk": 0}
        assert got[6] == ("bulk", "ok")
        assert got[7] == ("brownout", False)
        assert got[8] == ("bulk", "queued")
        assert got[9]["state"] == "normal" and got[9]["queued_total"] == 1
        assert got[10] == ("brownout", [False] * 4)
        assert got[11] == [("bulk", "queued")] * 4
        assert got[12]["active"]["bulk"] == 4
        assert got[13]["state"] == "normal"
        assert got[14] == (int(Code.RESOURCE_EXHAUSTED), 1234, "shed")
        assert got[15]["state"] == "normal"
        assert got[15]["tenants"]["noisy"]["shed"] == 1
        assert got[16][:2] == (int(Code.RESOURCE_EXHAUSTED), 2000)
        assert got[17]["shed"]["bulk"] == 1
        assert got[18] == "cancelled" and got[19] == ("bulk", "queued")
        assert got[20]["active"]["bulk"] == 0
        assert got[20]["state"] == "normal"
        assert got[21:26] == [("bulk", "ok")] * 5

    def test_section_defaults_are_the_references(self):
        import dataclasses
        assert dataclasses.asdict(qos.QosSection()) \
            == dataclasses.asdict(ref_qos.QosSection())
        assert qos.STATES == ref_qos.STATES

    def test_snapshot_carries_the_shapers_classes(self):
        async def main(mod, sh_mod):
            sh = sh_mod.TrafficShaper(total_rate_bps=1e6)
            g = mod.QosGovernor(mod.QosSection(), shaper=sh)
            await g.admit("critical", "svc")
            sh.register("a" * 8, qos_class="bulk", tenant="noisy")
            sh.record("a" * 8, 4096)
            return _snap(g)
        got = _run(main(qos, traffic_shaper))
        assert got == _run(main(ref_qos, ref_shaper))
        assert got["classes"]["bulk"]["tenants"]["noisy"] == {
            "tasks": 1, "consumed_bytes": 4096}

    def test_debug_qos_route_serves_the_snapshot(self):
        from dragonfly2_tpu_torch.common import httpd
        router = httpd.Router()
        g = qos.QosGovernor()
        qos.add_qos_routes(router, g)
        handler, params = router.match("GET", "/debug/qos")
        status, body = _run(handler(params, {}))
        assert status == 200 and body["state"] == "normal"
        assert set(body) == set(g.snapshot())


# ---------------------------------------------------------------------------
# the upload server's class-aware gate
# ---------------------------------------------------------------------------

SIZE = 32 << 10
TASK = "q" * 32


def _store(mod_root: str, tmp_path):
    if mod_root == "ref":
        from dragonfly2_tpu.storage.manager import (StorageConfig,
                                                    StorageManager)
        from dragonfly2_tpu.storage.metadata import TaskMetadata
    else:
        from dragonfly2_tpu_torch.storage.manager import (StorageConfig,
                                                          StorageManager)
        from dragonfly2_tpu_torch.storage.metadata import TaskMetadata
    mgr = StorageManager(StorageConfig(data_dir=str(tmp_path / mod_root)))
    md = TaskMetadata(task_id=TASK, url="http://o/x", content_length=SIZE,
                      total_piece_count=1, piece_size=SIZE)
    ts = mgr.register_task(md)
    ts.write_piece(0, 0, b"z" * SIZE)
    return mgr


async def _get(port: int, cls: str | None) -> tuple[int, bool, bytes]:
    """(status, has X-Retry-After-Ms, body) of one piece GET."""
    q = "?peerId=p" + (f"&cls={cls}" if cls is not None else "")
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write((f"GET /download/qqq/{TASK}{q} HTTP/1.1\r\nHost: x\r\n"
             f"Range: bytes=0-{SIZE - 1}\r\nConnection: close\r\n\r\n")
            .encode())
    await w.drain()
    raw = await r.read()
    w.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    hint = any(ln.lower().startswith("x-retry-after-ms:") for ln in lines)
    return status, hint, body


async def _gate_script(impl: str, tmp_path) -> list:
    if impl == "ref":
        from dragonfly2_tpu.daemon.upload_server import UploadServer, _Slot
    else:
        from dragonfly2_tpu_torch.daemon.upload_server import (UploadServer,
                                                               _Slot)
    srv = UploadServer(_store(impl, tmp_path), host="127.0.0.1",
                       concurrent_limit=4, bulk_concurrent_limit=1)
    await srv.start()
    out = []
    try:
        held = _Slot(srv, cls="bulk")             # the bulk cap is taken
        for cls in ("bulk", "standard", None, "critical", "gold"):
            status, hint, body = await _get(srv.port, cls)
            out.append((cls, status, hint, body == b"z" * SIZE))
        out.append(dict(srv._active_cls))
        held.release()
        status, _, body = await _get(srv.port, "bulk")
        out.append(("bulk-after", status, body == b"z" * SIZE))
        out.append((srv._active, srv._active_cls.get("bulk", 0),
                    srv.bulk_limit))
    finally:
        await srv.stop()
    return out


class TestUploadClassGate:
    def test_bulk_capped_below_total_standard_still_served(self, tmp_path):
        got = _run(_gate_script("port", tmp_path))
        assert got == _run(_gate_script("ref", tmp_path))
        assert got[0] == ("bulk", 503, True, False)
        assert got[1] == ("standard", 206, False, True)
        assert got[2] == (None, 206, False, True)
        assert got[-2] == ("bulk-after", 206, True)
        assert got[-1] == (0, 0, 1)

    @pytest.mark.parametrize("impl", BOTH)
    def test_pass_on_slot_wakes_non_bulk_first(self, impl):
        if impl == "ref":
            from dragonfly2_tpu.daemon.upload_server import UploadServer
        else:
            from dragonfly2_tpu_torch.daemon.upload_server import \
                UploadServer

        class _Mgr:
            castore = None

            def get(self, _tid):
                return None

        async def main():
            srv = UploadServer(_Mgr(), concurrent_limit=2,
                               bulk_concurrent_limit=2)
            srv._active = 2
            loop = asyncio.get_running_loop()
            bulk_fut, std_fut = loop.create_future(), loop.create_future()
            srv._bulk_waiters.append(bulk_fut)
            srv._slot_waiters.append(std_fut)
            srv._pass_on_slot()
            out = [std_fut.done(), bulk_fut.done()]
            srv._pass_on_slot()
            out.append(bulk_fut.done())
            srv._active = 2
            srv._active_cls["bulk"] = 2
            parked = loop.create_future()
            srv._bulk_waiters.append(parked)
            srv._pass_on_slot()
            out += [parked.done(), srv._active]
            parked.cancel()
            return out
        assert _run(main()) == [True, False, True, False, 1]

    def test_two_releases_before_a_woken_bulk_waiter_resumes(self):
        """Known difference 49: the reference counts a bulk waiter's class
        when the waiter resumes, so a second release landing first sees
        the bulk cap with room and wakes a second bulk waiter: two bulk
        transfers under a cap of one. The port counts the class at the
        handoff. The reference's waiter code is inline in its aiohttp
        handler; its two lines (wake, then ``_Slot(adopted=True)`` on
        resume) are played here as written."""
        from dragonfly2_tpu.daemon.upload_server import \
            UploadServer as RefServer
        from dragonfly2_tpu.daemon.upload_server import _Slot as RefSlot
        from dragonfly2_tpu_torch.daemon.upload_server import (UploadServer,
                                                               _Slot)

        class _Mgr:
            castore = None

        async def port_script():
            srv = UploadServer(_Mgr(), concurrent_limit=2,
                               bulk_concurrent_limit=1)
            held_bulk, held_std = _Slot(srv, cls="bulk"), _Slot(srv)
            waiters = [asyncio.create_task(srv._acquire_slot("bulk"))
                       for _ in range(2)]
            await asyncio.sleep(0.01)
            held_bulk.release()
            held_std.release()
            seen = []
            for w in waiters:
                try:
                    await w
                except Exception:  # noqa: BLE001 - the 503 of the gate
                    pass
                seen.append(srv._active_cls.get("bulk", 0))
            return max(seen)

        async def ref_script():
            srv = RefServer(_Mgr(), concurrent_limit=2,
                            bulk_concurrent_limit=1)
            held_bulk, held_std = RefSlot(srv, cls="bulk"), RefSlot(srv)
            loop = asyncio.get_running_loop()
            futs = [loop.create_future() for _ in range(2)]
            srv._bulk_waiters.extend(futs)
            held_bulk.release()
            held_std.release()
            slots = [RefSlot(srv, adopted=True, cls="bulk")
                     for f in futs if f.done()]
            return srv._active_cls.get("bulk", 0), len(slots)

        assert _run(ref_script()) == (2, 2)
        assert _run(port_script()) == 1

    @pytest.mark.parametrize("limit,want", [(0, 4), (3, 3), (1, 1)])
    def test_bulk_limit_defaults_as_the_reference(self, limit, want):
        from dragonfly2_tpu.daemon.upload_server import \
            UploadServer as RefServer
        from dragonfly2_tpu_torch.daemon.upload_server import UploadServer
        port = UploadServer(None, concurrent_limit=6,
                            bulk_concurrent_limit=limit)
        ref = RefServer(None, concurrent_limit=6,
                        bulk_concurrent_limit=limit)
        assert port.bulk_limit == ref.bulk_limit == want


# ---------------------------------------------------------------------------
# class threading end to end
# ---------------------------------------------------------------------------

class TestClassPropagation:
    @pytest.mark.parametrize("cls,tenant", [
        ("bulk", "batch"), ("critical", "svc"), ("gold", ""), ("", "t")])
    def test_conductor_resolves_and_registers_class(self, tmp_path, cls,
                                                    tenant):
        from dragonfly2_tpu.daemon.conductor import \
            PeerTaskConductor as RefConductor
        from dragonfly2_tpu.storage.manager import \
            StorageConfig as RefStorageConfig
        from dragonfly2_tpu.storage.manager import \
            StorageManager as RefStorageManager
        from dragonfly2_tpu_torch.daemon.conductor import PeerTaskConductor
        from dragonfly2_tpu_torch.storage.manager import (StorageConfig,
                                                          StorageManager)

        def observe(conductor_cls, meta_cls, shaper_mod, mgr):
            c = conductor_cls(
                task_id="t" * 64, peer_id="p1", url="http://o/x",
                url_meta=meta_cls(qos_class=cls, tenant=tenant),
                storage_mgr=mgr, piece_mgr=None)
            sh = shaper_mod.TrafficShaper(total_rate_bps=1e6)
            c.attach_shaper(sh)
            entry = sh._tasks["t" * 64]
            c.set_content_info(1 << 16)
            return (c.qos_class, c.tenant, entry.cls, entry.tenant,
                    c.rate_limiter is entry.bucket,
                    c.storage.md.qos_class)

        async def main():
            got = observe(PeerTaskConductor, msgs.UrlMeta, traffic_shaper,
                          StorageManager(StorageConfig(
                              data_dir=str(tmp_path / "port"))))
            want = observe(RefConductor, ref_msgs.UrlMeta, ref_shaper,
                           RefStorageManager(RefStorageConfig(
                               data_dir=str(tmp_path / "ref"))))
            return got, want
        got, want = _run(main())
        assert got == want
        assert got[0] == (cls if cls in msgs.PRIORITY_CLASSES
                          else "standard")

    @pytest.mark.parametrize("cls", ["critical", "bulk", ""])
    def test_piece_get_carries_cls_param(self, cls):
        """The wire half: a span GET stamps ``?cls=`` so the parent's
        gate sees the requester's class; a classless caller adds none."""
        from dragonfly2_tpu_torch.common.bufpool import POOL
        from dragonfly2_tpu_torch.daemon.piece_downloader import \
            PieceDownloader
        seen = {}

        async def main():
            async def handler(reader, writer):
                head = await reader.readuntil(b"\r\n\r\n")
                seen["line"] = head.split(b"\r\n")[0].decode()
                writer.write(b"HTTP/1.1 206 Partial Content\r\n"
                             b"Content-Length: 16\r\n\r\n" + b"x" * 16)
                await writer.drain()
                writer.close()
            server = await asyncio.start_server(handler, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            dl = PieceDownloader(timeout_s=5.0)
            try:
                buf, _ = await dl.download_span(
                    dst_addr=f"127.0.0.1:{port}", task_id="t" * 64,
                    src_peer_id="me",
                    pieces=[msgs.PieceInfo(piece_num=0, range_start=0,
                                           range_size=16)],
                    qos_class=cls)
                POOL.release(buf)
            finally:
                await dl.close()
                server.close()
                await server.wait_closed()
        _run(main())
        from urllib.parse import parse_qs, urlsplit
        query = parse_qs(urlsplit(seen["line"].split()[1]).query)
        assert query.get("peerId") == ["me"]
        assert query.get("cls", [""]) == [cls] if cls else "cls" not in query

    def test_engine_paces_with_the_tasks_bucket_and_sends_its_class(self):
        """The piece engine acquires the shaper's per-task bucket before
        each P2P transfer and hands the conductor's class to the
        downloader, as the reference's does."""
        import inspect

        from dragonfly2_tpu.daemon import piece_engine as ref_engine
        from dragonfly2_tpu_torch.daemon import piece_engine
        for mod in (piece_engine, ref_engine):
            src = inspect.getsource(mod.PieceEngine._download_one)
            assert "rate_limiter" in src and ".acquire(" in src
            assert 'qos_class=getattr(conductor, "qos_class", "")' in src

    @pytest.mark.parametrize("impl", BOTH)
    def test_pex_synthetic_session_preserves_class(self, impl):
        """The pex rung swaps the scheduler session for a synthetic one
        and a fresh engine; the class rides the conductor through it."""
        if impl == "ref":
            from dragonfly2_tpu.daemon.pex import PexGossiper
            from dragonfly2_tpu.daemon.swarm_index import (SwarmEntry,
                                                           SwarmIndex)
            host_cls = ref_msgs.Host
        else:
            from dragonfly2_tpu_torch.daemon.pex import PexGossiper
            from dragonfly2_tpu_torch.daemon.swarm_index import (SwarmEntry,
                                                                 SwarmIndex)
            host_cls = msgs.Host
        captured = {}

        class _Engine:
            async def pull(self, conductor, session):
                captured["cls"] = conductor.qos_class
                captured["tenant"] = conductor.tenant
                captured["session"] = type(session).__name__
                return True

        class _Conductor:
            task_id = "t" * 64
            peer_id = "me"
            qos_class = "bulk"
            tenant = "batch"
            flight = None
            ready: set = set()
            needed_pieces = None
            total_pieces = -1

            class log:
                info = staticmethod(lambda *a, **k: None)

        async def main():
            index = SwarmIndex(ttl_s=60.0)
            index.update("t" * 64, SwarmEntry(
                host_id="h1", ip="127.0.0.1", rpc_port=7, download_port=8,
                done=True, total_pieces=4, content_length=1 << 16,
                piece_size=1 << 14, expires_at=time.monotonic() + 60.0))
            pex = PexGossiper(
                storage_mgr=None,
                host_info=lambda: host_cls(id="me-host", ip="127.0.0.1"),
                index=index, engine_factory=_Engine)
            return await pex.try_pull(_Conductor())
        assert _run(main()) is True
        assert captured == {"cls": "bulk", "tenant": "batch",
                            "session": "_PexSession"}


# ---------------------------------------------------------------------------
# the scheduler: class resolution, quotas, preemption, fan-out caps
# ---------------------------------------------------------------------------

def _service(impl: str, **cfg_kw):
    if impl == "ref":
        from dragonfly2_tpu.scheduler.config import SchedulerConfig
        from dragonfly2_tpu.scheduler.evaluator import Evaluator
        from dragonfly2_tpu.scheduler.resource import Resource
        from dragonfly2_tpu.scheduler.scheduling import Scheduling
        from dragonfly2_tpu.scheduler.seed_client import SeedPeerClient
        from dragonfly2_tpu.scheduler.service import SchedulerService
        from dragonfly2_tpu.scheduler.topology_store import TopologyStore
        cfg = SchedulerConfig(**cfg_kw)
        res = Resource()
        return SchedulerService(cfg, res, Scheduling(cfg, Evaluator()),
                                SeedPeerClient(res, []), TopologyStore())
    from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
    from dragonfly2_tpu_torch.scheduler.evaluator import Evaluator
    from dragonfly2_tpu_torch.scheduler.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
    from dragonfly2_tpu_torch.scheduler.seed_client import SeedPeerClient
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.topology_store import TopologyStore
    cfg = SchedulerConfig(**cfg_kw)
    res = Resource()
    sched = Scheduling(Evaluator(), relay_fanout=cfg.relay_fanout,
                       class_fanout_caps=cfg.class_fanout_caps,
                       qos_preemption=cfg.qos_preemption)
    return SchedulerService(res, sched, SeedPeerClient(res, []),
                            TopologyStore(), cfg=cfg)


def _m(impl: str):
    return ref_msgs if impl == "ref" else msgs


def _req(impl: str, task_no: int, peer_no: int, meta, host_id: str = ""):
    m = _m(impl)
    return m.RegisterPeerTaskRequest(
        task_id=f"{task_no:064d}", url=f"http://o/f{task_no}",
        peer_id=f"peer-{task_no}-{peer_no}", url_meta=meta,
        peer_host=m.Host(id=host_id or f"h{task_no}-{peer_no}",
                         ip="127.0.0.1", port=1, download_port=2,
                         type=m.HostType.NORMAL))


def _err(exc) -> tuple:
    return (int(exc.code), getattr(exc, "retry_after_ms", None))


class TestSchedulerClassResolution:
    async def _script(self, impl):
        svc = _service(impl)
        m = _m(impl)
        svc.tenants = {"batch": {"qos_class": "bulk", "max_running": 0},
                       "typo": {"qos_class": "gold", "max_running": 0}}
        cases = [m.UrlMeta(qos_class="bulk", tenant="batch"),
                 m.UrlMeta(qos_class="bulk", priority=3),
                 m.UrlMeta(tenant="batch"),
                 m.UrlMeta(tenant="batch", qos_class="critical"),
                 m.UrlMeta(tenant="typo"), m.UrlMeta(qos_class="gold"),
                 m.UrlMeta(tenant="nobody"), m.UrlMeta()]
        out = []
        for i, meta in enumerate(cases, 1):
            r = await svc.register_peer_task(_req(impl, i, 1, meta), None)
            peer = svc.resource.find_peer(f"{i:064d}", f"peer-{i}-1")
            out.append((peer.qos_class, peer.tenant, peer.priority,
                        int(r.resolved_priority)))
        return out

    def test_register_stamps_class_tenant_and_priority(self):
        got = _run(self._script("port"))
        assert got == _run(self._script("ref"))
        assert got[0] == ("bulk", "batch", 6, 6)     # bulk sinks to LEVEL6
        assert got[1][2] == 3                         # explicit wins
        assert got[2][0] == "bulk"                    # the tenant's default
        assert got[3][0] == "critical"                # the request's wins
        assert got[4][0] == got[5][0] == "standard"


class TestTenantQuota:
    async def _script(self, impl):
        svc = _service(impl)
        m = _m(impl)
        svc.tenants = {"noisy": {"qos_class": "bulk", "max_running": 2,
                                 "shed_retry_after_ms": 777},
                       "dflt": {"qos_class": "", "max_running": 1}}
        meta = m.UrlMeta(tenant="noisy", qos_class="bulk")
        out = []

        async def reg(req):
            try:
                await svc.register_peer_task(req, None)
                return "ok"
            except Exception as exc:  # noqa: BLE001 - compared below
                return _err(exc)
        out.append(await reg(_req(impl, 10, 1, meta)))
        out.append(await reg(_req(impl, 11, 1, meta)))
        out.append(await reg(_req(impl, 12, 1, meta)))
        # a refused register leaves no peer behind
        out.append(svc.resource.find_peer(f"{12:064d}", "peer-12-1") is None)
        out.append(await reg(_req(impl, 13, 1, m.UrlMeta(tenant="calm"))))
        # a seed host's register is exempt
        seed = _req(impl, 14, 1, meta)
        seed.peer_host.type = m.HostType.SUPER_SEED
        out.append(await reg(seed))
        # the row without a retry hint gets the scheduler's default
        out.append(await reg(_req(impl, 15, 1, m.UrlMeta(tenant="dflt"))))
        out.append(await reg(_req(impl, 16, 1, m.UrlMeta(tenant="dflt"))))
        # a finished peer frees quota; so does a dead stream
        p = svc.resource.find_peer(f"{10:064d}", "peer-10-1")
        p.transit(type(p.state).SUCCEEDED)
        out.append(await reg(_req(impl, 12, 1, meta)))
        out.append(await reg(_req(impl, 17, 1, meta)))
        svc.resource.find_peer(f"{11:064d}", "peer-11-1").stream_gone = True
        out.append(await reg(_req(impl, 17, 1, meta)))
        return out

    def test_max_running_sheds_with_retry_after(self):
        got = _run(self._script("port"))
        assert got == _run(self._script("ref"))
        shed = (int(Code.RESOURCE_EXHAUSTED), 777)
        assert got[:4] == ["ok", "ok", shed, True]
        assert got[4:7] == ["ok", "ok", "ok"]
        assert got[7] == (int(Code.RESOURCE_EXHAUSTED), 2000)
        assert got[8:] == ["ok", shed, "ok"]

    def test_a_shed_counts_in_the_quota_metric(self):
        from dragonfly2_tpu_torch.common.metrics import REGISTRY
        svc = _service("port")
        svc.tenants = {"q1": {"qos_class": "", "max_running": 1}}

        def shed_count() -> float:
            for line in REGISTRY.expose().splitlines():
                if line.startswith('df_qos_quota_shed_total{tenant="q1"}'):
                    return float(line.split()[-1])
            return 0.0

        async def main():
            before = shed_count()
            await svc.register_peer_task(
                _req("port", 30, 1, msgs.UrlMeta(tenant="q1")), None)
            with pytest.raises(DFError):
                await svc.register_peer_task(
                    _req("port", 31, 1, msgs.UrlMeta(tenant="q1")), None)
            return shed_count() - before
        assert _run(main()) == 1.0


async def _preempt_mesh(impl: str, svc):
    """One task: a holder whose single upload slot a bulk child holds,
    and a waiting critical child (the reference's ``_mesh``)."""
    m = _m(impl)
    req = _req(impl, 20, 1, m.UrlMeta())
    req.peer_host.concurrent_upload_limit = 1
    await svc.register_peer_task(req, None)
    parent = svc.resource.find_peer(f"{20:064d}", "peer-20-1")
    parent.finished_pieces = {0, 1}
    await svc.register_peer_task(_req(
        impl, 20, 2, m.UrlMeta(qos_class="bulk", tenant="batch")), None)
    bulk = svc.resource.find_peer(f"{20:064d}", "peer-20-2")
    bulk.task.set_parents(bulk.id, [parent.id])
    bulk.last_offer_ids = {parent.id}
    await svc.register_peer_task(_req(
        impl, 20, 3, m.UrlMeta(qos_class="critical", tenant="svc")), None)
    crit = svc.resource.find_peer(f"{20:064d}", "peer-20-3")
    return parent, bulk, crit


def _strip_ids(row: dict) -> dict:
    row = dict(row)
    row.pop("decision_id", None)
    return row


class TestPreemption:
    async def _script(self, impl, **cfg):
        svc = _service(impl, **cfg)
        rows = []
        svc.scheduling.decision_sink = rows.append
        parent, bulk, crit = await _preempt_mesh(impl, svc)
        task = crit.task
        out = [parent.host.free_upload_slots(),
               [p.has_content() for p in svc.scheduling.find_parents(crit)]]
        victim = svc.scheduling.preempt_for(crit)
        out.append(victim.id if victim is not None else None)
        out.append(sorted(task.dag.parents(bulk.id)))
        out.append(parent.host.free_upload_slots())
        out.append([p.id for p in svc.scheduling.find_parents(crit)])
        out.append([_strip_ids(r) for r in rows
                    if r["decision_kind"] == "preempt"])
        return out

    def test_critical_preempts_bulk_edge_and_ruling_rides_ledger(self):
        got = _run(self._script("port"))
        assert got == _run(self._script("ref"))
        assert got[0] == 0 and not any(got[1])
        assert got[2] == "peer-20-2" and got[3] == []
        assert got[4] == 1 and "peer-20-1" in got[5]
        (row,) = got[6]
        assert row["qos_class"] == "critical" and row["tenant"] == "svc"
        assert row["preempted"] == {
            "victim_peer_id": "peer-20-2", "victim_class": "bulk",
            "victim_tenant": "batch", "parent_id": "peer-20-1",
            "victim_parents_kept": []}

    def test_preemption_can_be_disabled(self):
        got = _run(self._script("port", qos_preemption=False))
        assert got == _run(self._script("ref", qos_preemption=False))
        assert got[2] is None and got[6] == []

    @pytest.mark.parametrize("impl", BOTH)
    def test_standard_child_never_preempts(self, impl):
        async def main():
            svc = _service(impl)
            parent, bulk, crit = await _preempt_mesh(impl, svc)
            crit.qos_class = "standard"
            return (svc.scheduling.preempt_for(crit),
                    parent.id in crit.task.dag.parents(bulk.id))
        assert _run(main()) == (None, True)

    def test_preempt_is_a_profiled_ruling(self):
        from dragonfly2_tpu_torch.common import phasetimer

        async def main():
            svc = _service("port")
            _, _, crit = await _preempt_mesh("port", svc)
            phasetimer.reset()
            phasetimer.arm()
            try:
                svc.scheduling.preempt_for(crit)
                return phasetimer.snapshot()
            finally:
                phasetimer.reset()
        snap = _run(main())
        assert snap["rulings"]["by_kind"]["preempt"]["count"] == 1

    async def _patience(self, impl):
        svc = _service(impl)
        parent, bulk, crit = await _preempt_mesh(impl, svc)
        crit_sink: asyncio.Queue = asyncio.Queue()
        bulk_sink: asyncio.Queue = asyncio.Queue()
        crit.packet_sink = crit_sink
        bulk.packet_sink = bulk_sink
        await asyncio.wait_for(
            svc._schedule_with_patience(crit, crit_sink), 5.0)
        offer = crit_sink.get_nowait()
        offered = [offer.main_peer.peer_id] + [
            p.peer_id for p in (offer.candidate_peers or [])]
        shrunk = bulk_sink.get_nowait()
        ids = [p.peer_id for p in ([shrunk.main_peer]
                                   if shrunk.main_peer else [])
               + (shrunk.candidate_peers or [])]
        return offer.code, offered, ids

    def test_patience_loop_schedules_critical_via_preemption(self):
        got = _run(self._patience("port"))
        assert got == _run(self._patience("ref"))
        code, offered, ids = got
        assert code == 0 and "peer-20-1" in offered
        assert "peer-20-1" not in ids

    async def _reschedule(self, impl):
        svc = _service(impl)
        parent, bulk, crit = await _preempt_mesh(impl, svc)
        crit_sink: asyncio.Queue = asyncio.Queue()
        bulk_sink: asyncio.Queue = asyncio.Queue()
        crit.packet_sink, bulk.packet_sink = crit_sink, bulk_sink
        # the pieceless bulk sibling is blocked too: the reschedule's
        # find gives an empty offer, and only preemption frees the holder
        crit.block_parent(bulk.id)
        await svc._reschedule(crit)
        got = []
        while not crit_sink.empty():
            p = crit_sink.get_nowait()
            got.append(sorted([p.main_peer.peer_id] + [
                c.peer_id for c in (p.candidate_peers or [])]))
        return got, bulk_sink.qsize()

    def test_reschedule_preempts_as_the_reference(self):
        got = _run(self._reschedule("port"))
        assert got == _run(self._reschedule("ref"))
        # the critical child is offered the holder, the victim its shrunk set
        assert got == ([["peer-20-1"]], 1)


class TestClassFanoutCaps:
    def _script(self, impl):
        if impl == "ref":
            from dragonfly2_tpu.scheduler.config import SchedulerConfig
            from dragonfly2_tpu.scheduler.evaluator import Evaluator
            from dragonfly2_tpu.scheduler.resource import (PeerState,
                                                           Resource, Task)
            from dragonfly2_tpu.scheduler.scheduling import Scheduling
            sched = Scheduling(SchedulerConfig(relay_fanout=4), Evaluator())

            def set_caps(caps):
                sched.cfg.class_fanout_caps = caps
        else:
            from dragonfly2_tpu_torch.scheduler.evaluator import Evaluator
            from dragonfly2_tpu_torch.scheduler.resource import (PeerState,
                                                                 Resource,
                                                                 Task)
            from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
            sched = Scheduling(Evaluator(), relay_fanout=4)

            def set_caps(caps):
                sched.class_fanout_caps = caps
        m = _m(impl)
        res = Resource()
        task = Task("f" * 64, "http://o/f")
        task.set_content_info(1 << 20, 1 << 18, 4)

        def peer(name, cls="standard"):
            host = res.store_host(m.Host(
                id=f"{name}-h", ip="1.1.1.1", port=1, download_port=2))
            p = res.get_or_create_peer(name, task, host)
            p.qos_class = cls
            return p
        parent = peer("parent")
        parent.transit(PeerState.RUNNING)
        parent.finished_pieces = {0, 1, 2, 3}
        for i in range(2):
            kid = peer(f"kid{i}")
            task.set_parents(kid.id, [parent.id])
        std = peer("std-child")
        blk = peer("blk-child", cls="bulk")
        crit = peer("crit-child", cls="critical")
        out = []
        for caps in ({}, {"bulk": 4}, {"critical": 1}, {"bulk": 1,
                                                        "standard": 2}):
            set_caps(caps)
            for child in (std, blk, crit):
                shaped, note = sched._relay_shape(child, [parent])
                out.append(([p.id for p in shaped], note))
        set_caps({})
        return out

    def test_caps_and_the_half_rule_match_the_reference(self):
        got = self._script("port")
        assert got == self._script("ref")
        # no caps: a standard child is under 4, a bulk child capped at 2
        assert got[0][1] is None
        assert got[1][1]["fanout"] == 2 and "parent" in got[1][1]["capped"]
        # explicit caps win over the half rule
        assert got[4][1] is None


# ---------------------------------------------------------------------------
# the manager's tenants, and the scheduler's refresh of them
# ---------------------------------------------------------------------------

class TestManagerTenants:
    async def _script(self, impl, tmp_path):
        if impl == "ref":
            from dragonfly2_tpu.manager.service import ManagerService
            from dragonfly2_tpu.manager.store import Store
        else:
            from dragonfly2_tpu_torch.manager.service import ManagerService
            from dragonfly2_tpu_torch.manager.store import Store
        store = Store(str(tmp_path / f"{impl}.db"))
        store.upsert_tenant("batch", qos_class="bulk", max_running=8,
                            shed_retry_after_ms=500)
        store.upsert_tenant("svc", qos_class="critical")
        store.upsert_tenant("typo", qos_class="gold")
        store.upsert_tenant("batch", qos_class="bulk", max_running=4,
                            shed_retry_after_ms=500)
        resp = await ManagerService(store).list_tenants(None, None)
        rows = [{k: v for k, v in r.items()
                 if k not in ("created_at", "updated_at")}
                for r in store.tenants()]
        return resp, rows

    def test_store_roundtrip_and_list_rpc(self, tmp_path):
        got, rows = _run(self._script("port", tmp_path))
        want, ref_rows = _run(self._script("ref", tmp_path))
        assert rows == ref_rows
        assert dumps(got) == ref_dumps(want)
        by = {t.name: t for t in got.tenants}
        assert (by["batch"].max_running, by["batch"].qos_class,
                by["batch"].shed_retry_after_ms) == (4, "bulk", 500)
        assert by["svc"].qos_class == "critical"
        assert by["typo"].qos_class == ""

    @pytest.mark.parametrize("fields", [
        {}, {"name": "a"}, {"name": "b", "qos_class": "bulk",
                            "max_running": 3, "shed_retry_after_ms": 9},
        {"qos_class": "critical", "max_running": 1 << 40}])
    def test_messages_are_byte_equal(self, fields):
        port = msgs.ListTenantsResponse(
            tenants=[msgs.TenantEntry(**fields), msgs.TenantEntry()])
        ref = ref_msgs.ListTenantsResponse(
            tenants=[ref_msgs.TenantEntry(**fields), ref_msgs.TenantEntry()])
        assert dumps(port) == ref_dumps(ref)
        assert dumps(msgs.TenantEntry(**fields)) \
            == ref_dumps(ref_msgs.TenantEntry(**fields))
        assert dumps(msgs.ListTenantsResponse()) \
            == ref_dumps(ref_msgs.ListTenantsResponse())

    def test_rest_tenants_route_as_the_reference(self, tmp_path):
        """``GET``/``POST /api/v1/tenants``: the class is checked against
        the vocabulary at the write (400), a good row answers 201 and
        lists back."""
        from dragonfly2_tpu_torch.manager.rest import RestAPI
        from dragonfly2_tpu_torch.manager.store import Store

        async def call(port, method, path, body=None):
            raw = json.dumps(body).encode() if body is not None else b""
            r, w = await asyncio.open_connection("127.0.0.1", port)
            w.write((f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                     f"Content-Length: {len(raw)}\r\n"
                     f"Connection: close\r\n\r\n").encode() + raw)
            await w.drain()
            data = await r.read()
            w.close()
            head, _, payload = data.partition(b"\r\n\r\n")
            return int(head.split()[1]), json.loads(payload or b"null")

        async def main():
            api = RestAPI(Store(str(tmp_path / "m.db")), host="127.0.0.1")
            await api.start()
            try:
                out = [await call(api.port, "POST", "/api/v1/tenants",
                                  {"qos_class": "bulk"}),
                       await call(api.port, "POST", "/api/v1/tenants",
                                  {"name": "x", "qos_class": "gold"}),
                       await call(api.port, "POST", "/api/v1/tenants",
                                  {"name": "batch", "qos_class": "bulk",
                                   "max_running": 2}),
                       await call(api.port, "GET", "/api/v1/tenants")]
            finally:
                await api.stop()
            return out
        out = _run(main())
        assert out[0] == (400, {"error": "name required"})
        assert out[1][0] == 400 and "unknown qos_class 'gold'" \
            in out[1][1]["error"]
        assert out[2] == (201, {"id": 1})
        status, rows = out[3]
        assert status == 200 and [(r["name"], r["qos_class"],
                                   r["max_running"]) for r in rows] \
            == [("batch", "bulk", 2)]

    def test_scheduler_refreshes_and_persists_the_tenant_table(self,
                                                               tmp_path):
        """The scheduler pulls the manager's table with its applications
        (``ListTenants``), enforces it, and the state store's ``tenants``
        component exports and restores it."""
        from dragonfly2_tpu_torch.manager.server import (Manager,
                                                         ManagerConfig)
        from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
        from dragonfly2_tpu_torch.scheduler.server import Scheduler

        async def main():
            mgr = Manager(ManagerConfig(
                db_path=str(tmp_path / "m.db"), listen_ip="127.0.0.1"))
            await mgr.start()
            mgr.store.upsert_tenant("batch", qos_class="bulk",
                                    max_running=1, shed_retry_after_ms=55)
            cfg = SchedulerConfig(
                listen_ip="127.0.0.1", advertise_ip="127.0.0.1", port=0,
                manager_addresses=[mgr.address],
                statestore_dir=str(tmp_path / "state"))
            sched = Scheduler(cfg)
            await sched.start()
            try:
                for _ in range(100):
                    if sched.service.tenants:
                        break
                    await asyncio.sleep(0.05)
                table = dict(sched.service.tenants)
                exported = sched.statestore._exports["tenants"]()
            finally:
                await sched.stop()
                await mgr.stop()
            reborn = Scheduler(cfg)
            await asyncio.to_thread(reborn.statestore.restore)
            return table, exported, reborn.service.tenants
        table, exported, restored = _run(main())
        row = {"qos_class": "bulk", "max_running": 1,
               "shed_retry_after_ms": 55}
        assert table == {"batch": row}
        assert exported["tenants"] == {"batch": row}
        assert restored == {"batch": row}


# ---------------------------------------------------------------------------
# dfdiag --qos
# ---------------------------------------------------------------------------

def _diag_snap(**kw):
    snap = {"state": "brownout", "queued_now": 3, "state_since_s": 12.5,
            "enabled": True,
            "active": {"critical": 2, "standard": 0, "bulk": 0},
            "shed": {"critical": 0, "standard": 0, "bulk": 5},
            "admitted": {"critical": 2, "standard": 0, "bulk": 1},
            "classes": {"critical": {"tenants": {
                "svc": {"consumed_bytes": 999}}}},
            "tenants": {"svc": {"admitted": 2, "queued": 0, "shed": 0},
                        "batch": {"admitted": 1, "queued": 4, "shed": 5}}}
    snap.update(kw)
    return snap


DIAG_SNAPS = {
    "bulk-browned-out": _diag_snap(),
    "foreground-starved": _diag_snap(
        active={"critical": 0, "standard": 0, "bulk": 4},
        shed={"critical": 2, "standard": 0, "bulk": 0},
        classes={"bulk": {"tenants": {"batch": {"consumed_bytes": 777}},
                          "rate_bps": 5e6, "consumed_bytes": 777,
                          "tasks": 4}}),
    "healthy": {"state": "normal", "queued_now": 0, "active": {},
                "shed": {}, "classes": {}},
    "historic-shed": _diag_snap(state="normal", queued_now=0),
    "standard-starved": _diag_snap(
        active={"critical": 1, "standard": 0, "bulk": 2},
        shed={"critical": 0, "standard": 3, "bulk": 0}),
}


class TestDfdiagQosVerdict:
    @pytest.mark.parametrize("name", sorted(DIAG_SNAPS))
    def test_verdict_and_render_match_the_reference(self, name):
        snap = DIAG_SNAPS[name]
        assert dfdiag.qos_verdict(snap) == ref_dfdiag.qos_verdict(snap)
        assert dfdiag.render_qos(snap) == ref_dfdiag.render_qos(snap)

    def test_names_starved_class_and_offending_tenant(self):
        text, breach = dfdiag.qos_verdict(DIAG_SNAPS["bulk-browned-out"])
        assert "'bulk'" in text and "shed" in text and "'svc'" in text
        assert breach is False
        text, breach = dfdiag.qos_verdict(DIAG_SNAPS["foreground-starved"])
        assert breach is True
        assert "'critical'" in text and "'batch'" in text
        text, breach = dfdiag.qos_verdict(DIAG_SNAPS["healthy"])
        assert breach is False and "no class is starved" in text

    def test_cli_reads_a_live_daemon(self, tmp_path):
        """``dfdiag --qos`` against a port daemon's upload port prints the
        render of ``/debug/qos`` (``--json``: the snapshot) and exits as
        the verdict says."""
        import contextlib
        import io

        from dragonfly2_tpu_torch.common.config import from_dict
        from dragonfly2_tpu_torch.daemon.config import DaemonConfig
        from dragonfly2_tpu_torch.daemon.daemon import Daemon

        async def main():
            d = Daemon(from_dict(DaemonConfig, {
                "workdir": str(tmp_path), "device": "cpu",
                "host_ip": "127.0.0.1", "listen_ip": "127.0.0.1",
                "pex": {"enabled": False}}))
            await d.start()
            try:
                await d.qos.admit("critical", "svc")
                addr = f"127.0.0.1:{d.upload_server.port}"
                outs = []
                for extra in ([], ["--json"]):
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        rc = await asyncio.to_thread(
                            dfdiag.main, ["--daemon", addr, "--qos"] + extra)
                    outs.append((rc, buf.getvalue()))
                snap = d.qos.snapshot()
            finally:
                await d.stop()
            return outs, snap
        outs, snap = _run(main())
        (rc, text), (rc_json, raw) = outs
        assert rc == rc_json == 0
        got = json.loads(raw)
        got.pop("state_since_s")
        snap.pop("state_since_s")
        assert got == json.loads(json.dumps(snap))
        assert got["active"]["critical"] == 1
        assert text.startswith("qos: state=normal")
        assert "no class is starved" in text


# ---------------------------------------------------------------------------
# parts ported earlier: per-class SLO budgets, class-weighted eviction
# ---------------------------------------------------------------------------

class TestClassSloBudgets:
    @pytest.mark.parametrize("cls,wire_ms", [
        ("", 150.0), ("bulk", 150.0), ("critical", 60.0),
        ("standard", 99.0), ("bulk", 401.0)])
    def test_budgets_scale_by_class_as_the_reference(self, cls, wire_ms):
        from dragonfly2_tpu.common.health import SLOEngine as RefSLO
        from dragonfly2_tpu_torch.common.health import SLOEngine
        row = {"queue_ms": 0.0, "ttfb_ms": 0.0, "wire_ms": wire_ms,
               "hbm_ms": 0.0}

        def summary():
            s = {"piece_rows": [dict(row)]}
            if cls:
                s["qos_class"] = cls
            return s
        got = SLOEngine({"wire": 100.0}).annotate(summary())
        want = RefSLO({"wire": 100.0}).annotate(summary())
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))

    def test_flight_summary_carries_class(self):
        from dragonfly2_tpu_torch.daemon.flight_recorder import TaskFlight
        s = TaskFlight("t" * 64, "p1", qos_class="critical",
                       tenant="svc").summarize()
        assert s["qos_class"] == "critical" and s["tenant"] == "svc"


class TestClassWeightedEviction:
    @pytest.mark.parametrize("impl", BOTH)
    def test_popular_bulk_loses_to_less_popular_critical(self, impl,
                                                         tmp_path):
        if impl == "ref":
            from dragonfly2_tpu.storage.manager import (StorageConfig,
                                                        StorageManager)
            from dragonfly2_tpu.storage.metadata import TaskMetadata
        else:
            from dragonfly2_tpu_torch.storage.manager import (StorageConfig,
                                                              StorageManager)
            from dragonfly2_tpu_torch.storage.metadata import TaskMetadata
        mgr = StorageManager(StorageConfig(
            data_dir=str(tmp_path), capacity_bytes=3_000_000,
            disk_gc_high_ratio=0.5, disk_gc_low_ratio=0.4,
            task_ttl_s=3600))
        for i, cls in enumerate(["critical", "bulk"]):
            payload = bytes([ord("a") + i]) * 1_000_000
            ts = mgr.register_task(TaskMetadata(
                task_id=f"{i:064x}", url=f"http://o/{i}",
                content_length=len(payload), total_piece_count=1,
                piece_size=len(payload), priority=0, qos_class=cls))
            ts.write_piece(0, 0, payload)
            ts.mark_done(success=True)
        mgr.castore.record_serve(f"{1:064x}", 4_000_000)
        mgr.castore.record_serve(f"{0:064x}", 1_000_000)
        assert mgr.try_gc() >= 1
        kept = [ts.md.qos_class for ts in mgr.tasks()]
        assert "critical" in kept and "bulk" not in kept, kept


# ---------------------------------------------------------------------------
# the reference's tests/test_priority.py
# ---------------------------------------------------------------------------

class TestPriority:
    async def _script(self, impl):
        m = _m(impl)
        svc = _service(impl, back_source_total=1, back_source_concurrent=4)
        svc.applications = {"batch": 6, "critical": 0}
        out = [svc._resolve_priority(m.UrlMeta(priority=m.Priority.LEVEL2,
                                               application="batch")),
               svc._resolve_priority(m.UrlMeta(application="batch")),
               svc._resolve_priority(m.UrlMeta(application="nope")),
               svc._resolve_priority(m.UrlMeta())]
        for i, app in ((1, "batch"), (2, "batch"), (3, "critical")):
            r = await svc.register_peer_task(
                _req(impl, i, 1, m.UrlMeta(application=app)), None)
            peer = svc.resource.find_peer(r.task_id, f"peer-{i}-1")
            pkt = svc._rule_back_source(peer)
            out.append((peer.priority, int(r.resolved_priority),
                        pkt.code, peer.state.name))
        try:
            await svc.register_peer_task(_req(
                impl, 4, 1, m.UrlMeta(priority=m.Priority.LEVEL1)), None)
            out.append("registered")
        except Exception as exc:  # noqa: BLE001 - compared below
            out.append(_err(exc))
        svc = _service(impl)          # a fresh back-source budget
        await svc.register_peer_task(_req(
            impl, 5, 1, m.UrlMeta(priority=m.Priority.LEVEL2)), None)
        peer = svc.resource.find_peer(f"{5:064d}", "peer-5-1")
        sink: asyncio.Queue = asyncio.Queue()
        peer.packet_sink = sink
        await asyncio.wait_for(svc._schedule_with_patience(peer, sink), 1.0)
        out.append(sink.get_nowait().code)
        return out

    def test_resolution_arbitration_and_levels_match_the_reference(self):
        got = _run(self._script("port"))
        assert got == _run(self._script("ref"))
        assert got[:4] == [2, 6, 0, 0]
        assert got[4][:3] == (6, 6, int(Code.SCHED_NEED_BACK_SOURCE))
        assert got[5][2] == int(Code.SCHED_TASK_STATUS_ERROR)
        assert got[6][:3] == (0, 0, int(Code.SCHED_NEED_BACK_SOURCE))
        assert got[7] == (int(Code.SCHED_FORBIDDEN), None)
        assert got[8] == int(Code.SCHED_NEED_BACK_SOURCE)

    def test_low_priority_evicted_first(self, tmp_path):
        from dragonfly2_tpu_torch.storage.manager import (StorageConfig,
                                                          StorageManager)
        from dragonfly2_tpu_torch.storage.metadata import TaskMetadata
        mgr = StorageManager(StorageConfig(
            data_dir=str(tmp_path), capacity_bytes=3_000_000,
            disk_gc_high_ratio=0.5, disk_gc_low_ratio=0.4, task_ttl_s=3600))
        for i, prio in enumerate([0, 6]):
            payload = bytes([ord("a") + i]) * 1_000_000
            ts = mgr.register_task(TaskMetadata(
                task_id=f"{i:064x}", url=f"http://o/{i}",
                content_length=len(payload), total_piece_count=1,
                piece_size=len(payload), priority=prio))
            ts.write_piece(0, 0, payload)
            ts.mark_done(success=True)
        assert mgr.try_gc() >= 1
        kept = [ts.md.priority for ts in mgr.tasks()]
        assert 0 in kept and 6 not in kept


# ---------------------------------------------------------------------------
# the plane in a running daemon (known differences 42 and 46 removed)
# ---------------------------------------------------------------------------

def test_total_rate_limit_paces_p2p_fetches(tmp_path):
    """Known difference 42 is gone: ``download.total_rate_limit_bps`` is
    the traffic shaper's budget, and its per-task bucket paces the piece
    engine's P2P fetches, not only back-source reads. A 20 MiB pull from
    a seed at 8 MiB/s (the bucket holds one second) takes at least the
    excess over one second; every byte comes from the peer."""
    from dragonfly2_tpu_torch.common import ids
    from dragonfly2_tpu_torch.daemon.config import DaemonConfig
    from dragonfly2_tpu_torch.daemon.config import \
        SchedulerConfig as DaemonSched
    from dragonfly2_tpu_torch.daemon.daemon import Daemon
    from dragonfly2_tpu_torch.scheduler.config import (SchedulerConfig,
                                                       SeedPeerAddr)
    from dragonfly2_tpu_torch.scheduler.server import Scheduler
    from test_torch_p2p import _origin, _pull

    url, data, _ = _origin(tmp_path)
    rate = 8 << 20

    async def main():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]

        def cfg(name, **kw):
            return DaemonConfig(
                workdir=str(tmp_path / name), hostname=name,
                listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
                scheduler=DaemonSched(addresses=[f"127.0.0.1:{port}"]),
                **kw)
        seed = Daemon(cfg("seed", is_seed=True))
        await seed.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", port=port, seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await sched.start()
        c = cfg("leech")
        c.download.total_rate_limit_bps = rate
        leech = Daemon(c)
        await leech.start()
        try:
            t0 = time.monotonic()
            await _pull(leech, msgs, url, [], sink=False)
            took = time.monotonic() - t0
            cond = leech.ptm.conductor(ids.task_id(url))
            # the last frame comes before the run ends and unregisters
            await asyncio.wait_for(cond._run_task, 10)
            return (took, cond.traffic_p2p, cond.traffic_source,
                    cond.rate_limiter.rate, dict(leech.shaper._tasks))
        finally:
            await leech.stop()
            await sched.stop()
            await seed.stop()

    took, p2p, source, bucket_rate, left = _run(
        asyncio.wait_for(main(), 60))
    assert (p2p, source) == (len(data), 0)
    assert bucket_rate == pytest.approx(rate) and left == {}
    assert took >= (len(data) - rate) / rate


def test_pulse_carries_the_governors_state_and_sheds(tmp_path):
    """Known difference 46 is gone: a port daemon has a governor, so its
    pulse's ``qos_state`` and ``qos_shed`` are the governor's, and the
    pulse's bytes are those the reference's ``build_pulse`` writes for
    the same counters."""
    from types import SimpleNamespace

    from dragonfly2_tpu.daemon import pulse as ref_pulse
    from dragonfly2_tpu_torch.common.config import from_dict
    from dragonfly2_tpu_torch.daemon import pulse
    from dragonfly2_tpu_torch.daemon.config import DaemonConfig
    from dragonfly2_tpu_torch.daemon.daemon import Daemon

    async def main():
        d = Daemon(from_dict(DaemonConfig, {
            "workdir": str(tmp_path), "device": "cpu",
            "qos": {"bulk_active_limit": 1, "queue_limit": 0}}))
        await d.qos.admit("bulk", "batch")
        with pytest.raises(DFError):
            await d.qos.admit("bulk", "batch")
        return d
    d = _run(main())
    got = pulse.build_pulse(d, 7)
    assert (got.qos_state, got.qos_shed) == ("shed", 1)
    twin = SimpleNamespace(qos=SimpleNamespace(
        state=d.qos.state, counters=d.qos.counters))
    assert (ref_pulse.build_pulse(twin, 7).qos_state,
            ref_pulse.build_pulse(twin, 7).qos_shed) == ("shed", 1)
    assert (pulse.build_pulse(twin, 7).qos_state,
            pulse.build_pulse(twin, 7).qos_shed) == ("shed", 1)
