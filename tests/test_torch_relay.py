"""The cut-through relay through the port, against the reference.

* The reference's ``tests/test_relay.py`` cases, run through the port with
  no aiohttp on its side (a standard-library origin, a raw HTTP client):
  ``TestRelayHub`` (4), ``TestStreamingRange`` (6), ``TestCutThroughChain``
  (origin -> seed -> r1 -> r2: r2's first byte of a piece lands before r1
  finishes it), ``TestRelayStallChaos`` (a parent whose watermark stops
  does not wedge its child) and ``TestCorruptRelayedPiece`` (a corrupt
  transfer is caught at the child, requeued, never served onward).
* Parity: one seeded sequence of ``open_span`` / ``advance`` / ``retire``
  / ``pulse`` calls gives equal ``available_end``, ``read_span``,
  ``progress`` and ``inflight_infos`` in both hubs; a ``PiecePacket``
  with ``relay_nums`` from both rpcservers has the same bytes; on a staged
  64-host cluster with ``relay_fanout=2`` the decision rows (their
  ``relay`` notes included) and the parent order equal the reference's.
* The buffer rule: a relay read, from the hub or through the upload
  server, leaves the pooled buffer reusable.

Tolerances are exact. Every test runs under ``asyncio.wait_for``.
"""

import asyncio
import random
import time
import types

import numpy as np
import pytest

from dragonfly2_tpu.common import digest as ref_digest
from dragonfly2_tpu.daemon.relay import RelayHub as RefRelayHub
from dragonfly2_tpu.daemon.rpcserver import DaemonService as RefDaemonService
from dragonfly2_tpu.idl import base as ref_base
import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.scheduler import config as ref_config
from dragonfly2_tpu.scheduler.evaluator import Evaluator as RefEvaluator
from dragonfly2_tpu.scheduler.scheduling import Scheduling as RefScheduling
from dragonfly2_tpu.storage import manager as ref_storage
from dragonfly2_tpu.storage.metadata import TaskMetadata as RefTaskMetadata
from dragonfly2_tpu_torch.common import digest as digestlib
from dragonfly2_tpu_torch.common import faultgate
from dragonfly2_tpu_torch.common.bufpool import POOL
from dragonfly2_tpu_torch.daemon import flight_recorder as fr
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.daemon.relay import RelayHub
from dragonfly2_tpu_torch.daemon.rpcserver import DaemonService
from dragonfly2_tpu_torch.daemon.upload_server import (UploadServer,
                                                       _relay_stalls)
from dragonfly2_tpu_torch.idl import base as port_base
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.idl.messages import (DownloadRequest, PeerAddr,
                                               PeerPacket, PieceInfo,
                                               PieceTaskRequest,
                                               RegisterResult, SizeScope,
                                               UrlMeta)
from dragonfly2_tpu_torch.scheduler.evaluator import Evaluator
from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
from dragonfly2_tpu_torch.storage.manager import StorageConfig, StorageManager
from dragonfly2_tpu_torch.storage.metadata import TaskMetadata
from test_torch_native import ref_native_lib  # noqa: F401 - fixture
from test_torch_probes import _cluster, frozen_clock  # noqa: F401 - fixture
from torch_origin import Origin

LIMIT_S = 30.0
E2E_LIMIT_S = 60.0
TASK = "r" * 64
PIECE = 256 * 1024
TOTAL = 4 * PIECE
MiB = 1 << 20


@pytest.fixture(autouse=True)
def _disarm():
    faultgate.reset()
    yield
    faultgate.reset()


def run(coro, limit: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit))


def make_task(tmp_path, pkg: str = "port"):
    if pkg == "port":
        mgr = StorageManager(StorageConfig(data_dir=str(tmp_path / "data")))
        md = TaskMetadata
    else:
        mgr = ref_storage.StorageManager(ref_storage.StorageConfig(
            data_dir=str(tmp_path / "ref-data")))
        md = RefTaskMetadata
    ts = mgr.register_task(md(task_id=TASK, url="http://o/blob",
                              content_length=TOTAL, total_piece_count=4,
                              piece_size=PIECE))
    return mgr, ts


def info(num: int, data: bytes) -> PieceInfo:
    return PieceInfo(piece_num=num, range_start=num * PIECE,
                     range_size=len(data),
                     digest=digestlib.for_bytes("crc32c", data))


def seeded(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


async def http_get(port: int, path: str, headers: dict) -> dict:
    """One GET over a fresh connection: status, lowercase headers, the
    body as far as it came, when its first byte came, and whether the body
    reached its ``Content-Length``."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        lines = [f"GET {path} HTTP/1.1", f"Host: 127.0.0.1:{port}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
        head = await reader.readuntil(b"\r\n\r\n")
        text = head[:-4].decode("latin-1").split("\r\n")
        status = int(text[0].split(" ")[1])
        got = {}
        for line in text[1:]:
            k, _, v = line.partition(":")
            got[k.strip().lower()] = v.strip()
        want = int(got.get("content-length", "-1"))
        body = bytearray()
        first_byte_at = None
        while len(body) < want:
            chunk = await reader.read(1 << 20)
            if not chunk:
                break
            if first_byte_at is None:
                first_byte_at = time.monotonic()
            body += chunk
        return {"status": status, "headers": got, "body": bytes(body),
                "first_byte_at": first_byte_at,
                "complete": len(body) == want}
    finally:
        writer.close()


# ---------------------------------------------------------------- hub


class TestRelayHub:
    def test_covered_prefix_walks_contiguous_pieces(self, tmp_path):
        _mgr, ts = make_task(tmp_path)
        a, b = seeded(PIECE, 1), seeded(PIECE, 2)
        ts.write_piece(0, 0, a)
        ts.write_piece(2, 2 * PIECE, b)     # gap at piece 1
        assert ts.covered_prefix(0, TOTAL) == PIECE
        assert ts.covered_prefix(PIECE, TOTAL) == PIECE      # hole
        assert ts.covered_prefix(2 * PIECE, TOTAL) == 3 * PIECE
        assert ts.covered_prefix(5, PIECE - 5) == PIECE - 5  # clipped

    def test_available_end_combines_storage_and_span(self, tmp_path):
        _mgr, ts = make_task(tmp_path)
        ts.write_piece(0, 0, seeded(PIECE, 3))
        hub = RelayHub()
        hub.track(TASK, total_pieces=4)
        buf = bytearray(PIECE)
        span = hub.open_span(TASK, PIECE, PIECE, buf,
                             [PieceInfo(piece_num=1, range_start=PIECE,
                                        range_size=PIECE)])
        assert hub.available_end(TASK, ts, 0, TOTAL) == PIECE
        span.advance(1000)
        # the frontier runs through the landed piece into the live span
        assert hub.available_end(TASK, ts, 0, TOTAL) == PIECE + 1000
        assert hub.read_span(TASK, PIECE, 4096) == bytes(buf[:1000])
        hub.retire(span)
        assert hub.read_span(TASK, PIECE, 4096) is None
        assert hub.available_end(TASK, ts, 0, TOTAL) == PIECE

    def test_wait_progress_pulse_and_untrack_wake(self):
        hub = RelayHub()
        hub.track(TASK)

        async def go():
            async def waiter():
                return await hub.wait_progress(TASK, 5.0)
            t = asyncio.create_task(waiter())
            await asyncio.sleep(0.01)
            hub.pulse(TASK)
            assert await t is True
            t2 = asyncio.create_task(waiter())
            await asyncio.sleep(0.01)
            hub.untrack(TASK)          # the final wake: conductor finished
            assert await t2 is True
            assert not hub.active(TASK)
            assert await hub.wait_progress(TASK, 0.1) is False
        run(go())

    def test_inflight_infos_and_on_open_hook(self):
        hub = RelayHub()
        opened = []
        hub.track(TASK, on_open=opened.append)
        pi = PieceInfo(piece_num=3, range_start=3 * PIECE, range_size=PIECE)
        span = hub.open_span(TASK, 3 * PIECE, PIECE, bytearray(4), [pi])
        assert [i.piece_num for i in hub.inflight_infos(TASK)] == [3]
        assert opened == [span]
        hub.retire(span)
        assert hub.inflight_infos(TASK) == []


# ------------------------------------------------- streaming range path


async def start_server(mgr, hub, **kw):
    srv = UploadServer(mgr, host="127.0.0.1", relay=hub,
                       relay_stall_s=kw.pop("relay_stall_s", 0.4), **kw)
    await srv.start()
    return srv


PATH = f"/download/{TASK[:3]}/{TASK}"


class TestStreamingRange:
    def test_read_at_watermark_serves_live_span_bytes(self, tmp_path):
        """The stored piece from disk, the in-flight piece off the live
        span: no 416, served before the piece exists on disk."""
        async def go():
            mgr, ts = make_task(tmp_path)
            p0, p1 = seeded(PIECE, 4), seeded(PIECE, 5)
            ts.write_piece(0, 0, p0)
            hub = RelayHub()
            hub.track(TASK, total_pieces=4)
            buf = bytearray(p1)                     # fully arrived...
            span = hub.open_span(TASK, PIECE, PIECE, buf, [info(1, p1)])
            span.advance(PIECE)                     # ...but not landed
            srv = await start_server(mgr, hub)
            try:
                r = await http_get(srv.port, PATH, {
                    "Range": f"bytes=0-{2 * PIECE - 1}"})
                assert r["status"] == 206
                assert r["headers"].get("x-df-relay") == "1"
                assert r["headers"].get("x-df-piece-progress") == "1/4"
                assert r["body"] == p0 + p1
                assert srv.relay_serves["ok"] == 1
                assert srv.relay_bytes == {"storage": PIECE, "span": PIECE}
            finally:
                await srv.stop()
        run(go())

    def test_await_past_watermark_until_bytes_arrive(self, tmp_path):
        """The serve parks past the watermark and resumes as the span
        advances: the first byte leaves while the piece is arriving."""
        async def go():
            mgr, ts = make_task(tmp_path)
            p0, p1 = seeded(PIECE, 6), seeded(PIECE, 7)
            ts.write_piece(0, 0, p0)
            hub = RelayHub()
            hub.track(TASK, total_pieces=4)
            buf = bytearray(PIECE)
            span = hub.open_span(TASK, PIECE, PIECE, buf, [info(1, p1)])
            srv = await start_server(mgr, hub)

            async def feed():
                for lo in range(0, PIECE, PIECE // 4):
                    await asyncio.sleep(0.05)
                    hi = lo + PIECE // 4
                    buf[lo:hi] = p1[lo:hi]
                    span.advance(hi)
                ts.write_piece(1, PIECE, p1)
                hub.retire(span)
            feeder = asyncio.create_task(feed())
            try:
                t0 = time.monotonic()
                r = await http_get(srv.port, PATH, {
                    "Range": f"bytes=0-{2 * PIECE - 1}"})
                await feeder
                assert r["status"] == 206 and r["body"] == p0 + p1
                # the first byte flowed while the span was still filling
                # (the feeder takes about 0.2 s)
                assert r["first_byte_at"] - t0 < 0.15
            finally:
                feeder.cancel()
                await srv.stop()
        run(go())

    def test_deadline_expiry_503_with_stall_counter(self, tmp_path):
        """No progress past relay_stall_s and nothing sent: a clean 503
        with a retry hint, the stall counter moves, the slot comes
        back."""
        async def go():
            mgr, ts = make_task(tmp_path)
            ts.write_piece(0, 0, seeded(PIECE, 8))
            hub = RelayHub()
            hub.track(TASK, total_pieces=4)
            srv = await start_server(mgr, hub, relay_stall_s=0.2)
            before = _relay_stalls.value()
            try:
                r = await http_get(srv.port, PATH, {
                    "Range": f"bytes={2 * PIECE}-{3 * PIECE - 1}"})
                assert r["status"] == 503
                assert "retry-after" in r["headers"]
                assert _relay_stalls.value() == before + 1
                assert srv._active == 0
            finally:
                await srv.stop()
        run(go())

    def test_stall_deadline_not_rearmed_by_unrelated_progress(
            self, tmp_path):
        """A serve parked at an offset that never advances expires in
        about relay_stall_s even while other pulses keep coming."""
        async def go():
            mgr, ts = make_task(tmp_path)
            hub = RelayHub()
            hub.track(TASK, total_pieces=4)
            srv = await start_server(mgr, hub, relay_stall_s=0.3)

            async def noisy_pulses():
                while True:
                    await asyncio.sleep(0.05)
                    hub.pulse(TASK)     # unrelated task-wide progress
            noise = asyncio.create_task(noisy_pulses())
            try:
                t0 = time.monotonic()
                r = await http_get(srv.port, PATH, {
                    "Range": f"bytes={3 * PIECE}-{4 * PIECE - 1}"})
                assert r["status"] == 503
                assert time.monotonic() - t0 < 1.5
                assert srv._active == 0
            finally:
                noise.cancel()
                await srv.stop()
        run(go())

    def test_eviction_mid_stream_charges_only_moved_bytes(self, tmp_path):
        """The task is evicted under the serve: the stream aborts
        mid-body and the limiter was charged only for bytes that moved."""
        async def go():
            mgr, ts = make_task(tmp_path)
            p0, p1 = seeded(PIECE, 9), seeded(PIECE, 10)
            ts.write_piece(0, 0, p0)
            ts.write_piece(1, PIECE, p1)
            hub = RelayHub()
            hub.track(TASK, total_pieces=4)
            srv = await start_server(mgr, hub, relay_stall_s=2.0)
            acquired, refunded = [], []

            class Recorder:
                async def acquire(self, n):
                    acquired.append(n)

                def refund(self, n):
                    refunded.append(n)
            srv.limiter = Recorder()
            # the first disk read (pieces 0-1 in one chunk) succeeds; the
            # read after piece 2 lands fails: evicted mid-stream
            real_read = ts.read_range
            reads = []

            def flaky_read(start, length):
                reads.append((start, length))
                if len(reads) > 1:
                    raise OSError("evicted")
                return real_read(start, length)
            ts.read_range = flaky_read

            async def land_piece2():
                await asyncio.sleep(0.1)
                ts.write_piece(2, 2 * PIECE, seeded(PIECE, 11))
                hub.pulse(TASK)
            lander = asyncio.create_task(land_piece2())
            try:
                r = await http_get(srv.port, PATH, {
                    "Range": f"bytes=0-{3 * PIECE - 1}"})
                await lander
                assert r["status"] == 206 and not r["complete"]
                # what came before the eviction is exact, and the limiter
                # saw exactly those bytes
                assert r["body"] == p0 + p1
                assert sum(acquired) == len(r["body"])
                assert refunded == []
                assert srv._active == 0
                assert srv.relay_serves["evicted"] == 1
            finally:
                lander.cancel()
                await srv.stop()
        run(go())

    def test_incomplete_range_still_416_when_relay_off(self, tmp_path):
        """relay=None (or an untracked task) keeps the 416."""
        async def go():
            mgr, ts = make_task(tmp_path)
            ts.write_piece(0, 0, seeded(PIECE, 12))
            for hub in (None, RelayHub()):
                srv = await start_server(mgr, hub)
                try:
                    r = await http_get(srv.port, PATH, {
                        "Range": f"bytes=0-{2 * PIECE - 1}"})
                    assert r["status"] == 416
                finally:
                    await srv.stop()
        run(go())


# ------------------------------------------------------ daemons, scripted


class ScriptedSession:
    """A scheduler session that answers register with ``result`` and
    hands the engine ``packets``; reports go nowhere."""

    def __init__(self, result: RegisterResult, packets: list):
        self.result = result
        self.packets: asyncio.Queue = asyncio.Queue()
        for p in packets:
            self.packets.put_nowait(p)

    async def report_piece(self, result) -> None:
        pass

    async def close(self, *, success: bool) -> None:
        pass


class ScriptedScheduler:
    def __init__(self, make_session):
        self.make_session = make_session

    async def register(self, conductor):
        return self.make_session(conductor)


def parent_addr(daemon, peer_id: str, *, is_seed: bool = False) -> PeerAddr:
    return PeerAddr(peer_id=peer_id, ip="127.0.0.1",
                    rpc_port=daemon.rpc.port,
                    download_port=daemon.upload_server.port,
                    is_seed=is_seed)


def scripted(parents):
    """A scheduler whose every register gets ``parents()`` (daemon,
    peer id, is_seed triples, resolved at register time)."""
    def make_session(conductor):
        addrs = [parent_addr(d, pid, is_seed=s) for d, pid, s in parents()]
        return ScriptedSession(
            RegisterResult(task_id=conductor.task_id,
                           size_scope=SizeScope.NORMAL),
            [PeerPacket(task_id=conductor.task_id,
                        src_peer_id=conductor.peer_id, main_peer=addrs[0],
                        candidate_peers=addrs[1:])])
    return ScriptedScheduler(make_session)


def daemon(tmp_path, name: str, **download) -> Daemon:
    cfg = DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                       listen_ip="127.0.0.1", host_ip="127.0.0.1",
                       device="cpu")
    for k, v in download.items():
        setattr(cfg.download, k, v)
    return Daemon(cfg)


async def drain(d: Daemon, url: str, **kw) -> DownloadRequest:
    last = None
    async for resp in d.ptm.start_file_task(DownloadRequest(
            url=url, timeout_s=E2E_LIMIT_S, **kw)):
        last = resp
    return last


async def wait_conductor(d: Daemon, task_id: str):
    for _ in range(500):
        c = d.ptm.conductor(task_id)
        if c is not None:
            return c
        await asyncio.sleep(0.01)
    raise AssertionError(f"{d.hostname}: no conductor for the task")


def mono(flight, stage: str) -> dict:
    """First ``stage`` event per piece on the monotonic clock."""
    out = {}
    for t_ms, st, piece, _p, _b, _d in list(flight.events):
        if st == stage and piece >= 0:
            out.setdefault(piece, flight._m0 + t_ms / 1000.0)
    return out


class TestCutThroughChain:
    def test_chain_first_byte_before_upstream_finishes(self, tmp_path):
        """origin -> seed -> r1 -> r2: r2's first byte of a piece lands
        before r1 finishes receiving that piece; r1 journals relayed
        serves to r2."""
        data = seeded(12 * MiB, 13)        # 3 pieces at 4 MiB

        async def go(url: str):
            # the seed takes one origin stream, so its pieces land in
            # order, paced by the trickled origin
            seed = daemon(tmp_path, "ch-seed",
                          back_source_group_min_bytes=1 << 30)
            r1, r2 = daemon(tmp_path, "ch-r1"), daemon(tmp_path, "ch-r2")
            daemons = [seed, r1, r2]
            for d in daemons:
                await d.start()
            task_id = seed.ptm._task_id(url, UrlMeta())
            r1.ptm.scheduler = scripted(lambda: [
                (seed, seed.ptm.conductor(task_id).peer_id, False)])
            r2.ptm.scheduler = scripted(lambda: [
                (r1, r1.ptm.conductor(task_id).peer_id, False)])
            try:
                pulls = [asyncio.create_task(drain(seed, url))]
                await wait_conductor(seed, task_id)
                pulls.append(asyncio.create_task(
                    drain(r1, url, disable_back_source=True)))
                await wait_conductor(r1, task_id)
                pulls.append(asyncio.create_task(
                    drain(r2, url, disable_back_source=True)))
                dones = await asyncio.gather(*pulls)
                assert all(r is not None and r.done for r in dones)
                for d in (r1, r2):
                    c = d.ptm.conductor(task_id)
                    assert c.completed_length == len(data)
                    assert c.traffic_p2p == len(data)
                    assert d.storage_mgr.get(task_id).read_range(
                        0, len(data)) == data
                f1 = r1.flight_recorder.get(task_id)
                f2 = r2.flight_recorder.get(task_id)
                r1_done = mono(f1, fr.WIRE_DONE)
                r2_first = mono(f2, fr.FIRST_BYTE)
                overlapped = [p for p in r2_first
                              if p in r1_done and r2_first[p] < r1_done[p]]
                assert overlapped, (
                    f"no cut-through: r1={r1_done} r2={r2_first}")
                ups = f1.summarize()["uploads"]
                assert any(u["relayed_pieces"] > 0 for u in ups.values()), ups
                assert r1.upload_server.relay_serves["ok"] > 0
            finally:
                for d in reversed(daemons):
                    await d.stop()

        with Origin({"w.bin": data}, pace_bps=20 * MiB) as o:
            run(go(f"{o.base}/w.bin"), E2E_LIMIT_S)
            assert o.body_bytes == len(data)


class TestRelayStallChaos:
    def test_stalled_relay_degrades_to_other_holder(self, tmp_path):
        """A parent whose watermark stops (``relay.stall`` hang) does not
        wedge its child: the piece goes to the other holder, the task
        completes on the p2p rung, and no upload slot leaks."""
        data = seeded(12 * MiB, 14)

        async def go(origin: Origin, url: str):
            b = daemon(tmp_path, "st-b")
            await b.start()
            daemons = [b]
            try:
                assert (await drain(b, url)).done
                task_id = b.ptm._task_id(url, UrlMeta())
                b_peer = b.ptm.conductor(task_id).peer_id
                # throttle B's uplink so A stays mid-download
                b.upload_server.limiter.set_rate(3 * MiB, burst=MiB)
                b.upload_server.limiter._tokens = 0.0
                a = daemon(tmp_path, "st-a", relay_stall_s=1.0)
                await a.start()
                daemons.append(a)
                a.ptm.scheduler = scripted(lambda: [(b, b_peer, False)])
                pull_a = asyncio.create_task(
                    drain(a, url, disable_back_source=True))
                a_peer = (await wait_conductor(a, task_id)).peer_id
                # every relay serve on A now hangs: its watermark "stops"
                faultgate.arm("relay.stall", "hang", key=task_id[:8], n=-1)
                c = daemon(tmp_path, "st-c")
                await c.start()
                daemons.append(c)
                c._downloader.timeout_s = 2.0     # short piece deadline
                # A first; B marked seed, so the dispatcher ranks it last
                c.ptm.scheduler = scripted(lambda: [(a, a_peer, False),
                                                    (b, b_peer, True)])
                assert (await drain(c, url, disable_back_source=True)).done
                cc = c.ptm.conductor(task_id)
                assert cc.completed_length == len(data)
                assert cc.traffic_p2p == len(data)
                summary = c.flight_recorder.get(task_id).summarize()
                assert summary["served_rung"] == "p2p"
                faultgate.reset()
                assert (await pull_a).done
                for _ in range(100):
                    if a.upload_server._active == 0:
                        break
                    await asyncio.sleep(0.05)
                assert a.upload_server._active == 0
            finally:
                faultgate.reset()
                for d in reversed(daemons):
                    await d.stop()

        with Origin({"w.bin": data}) as o:
            run(go(o, f"{o.base}/w.bin"), E2E_LIMIT_S)


class TestCorruptRelayedPiece:
    def test_corrupt_relayed_piece_requeued_never_served_onward(
            self, tmp_path):
        """A corrupt transfer from a relaying parent is caught at the
        child's landing, requeued against another holder and never
        recorded: the task still completes bit-exact."""
        data = seeded(12 * MiB, 15)

        async def go(url: str):
            b = daemon(tmp_path, "cr-b")
            await b.start()
            daemons = [b]
            try:
                assert (await drain(b, url)).done
                task_id = b.ptm._task_id(url, UrlMeta())
                b_peer = b.ptm.conductor(task_id).peer_id
                b.upload_server.limiter.set_rate(4 * MiB, burst=MiB)
                b.upload_server.limiter._tokens = 0.0
                a = daemon(tmp_path, "cr-a")
                await a.start()
                daemons.append(a)
                a.ptm.scheduler = scripted(lambda: [(b, b_peer, False)])
                pull_a = asyncio.create_task(
                    drain(a, url, disable_back_source=True))
                a_peer = (await wait_conductor(a, task_id)).peer_id
                a_addr = f"127.0.0.1:{a.upload_server.port}"
                # corrupt ONE transfer from A on C's wire
                faultgate.arm("piece.wire", "corrupt",
                              key=f"parent {a_addr}", n=1)
                c = daemon(tmp_path, "cr-c")
                await c.start()
                daemons.append(c)
                c.ptm.scheduler = scripted(lambda: [(a, a_peer, False),
                                                    (b, b_peer, True)])
                out = tmp_path / "cr.out"
                assert (await drain(c, url, output=str(out),
                                    disable_back_source=True)).done
                assert out.read_bytes() == data
                summary = c.flight_recorder.get(task_id).summarize()
                assert summary["corrupt_pieces"].get(a_peer, 0) >= 1, \
                    summary["corrupt_pieces"]
                assert summary["fail_codes"].get("corrupt", 0) >= 1
                # the corrupt copy was never recorded
                cs = c.storage_mgr.get(task_id)
                assert b"".join(cs.read_piece(p.num)
                                for p in cs.piece_infos()) == data
                faultgate.reset()
                assert (await pull_a).done
            finally:
                faultgate.reset()
                for d in reversed(daemons):
                    await d.stop()

        with Origin({"w.bin": data}) as o:
            run(go(f"{o.base}/w.bin"), E2E_LIMIT_S)


# ---------------------------------------------------------------- parity


def _infos(infos) -> list[tuple]:
    return [(i.piece_num, i.range_start, i.range_size, i.digest)
            for i in infos]


@pytest.mark.parametrize("seed", range(4))
def test_hub_sequence_matches_reference(tmp_path, seed):
    """The same seeded calls on both hubs, each over its own package's
    storage, read back the same frontier, bytes, progress and in-flight
    set after every step."""
    rng = random.Random(seed)
    _m1, ref_ts = make_task(tmp_path, "ref")
    _m2, port_ts = make_task(tmp_path, "port")
    ref_hub, port_hub = RefRelayHub(), RelayHub()
    ref_hub.track(TASK, total_pieces=4)
    port_hub.track(TASK, total_pieces=4)
    content = seeded(TOTAL, 100 + seed)
    spans: dict[int, tuple] = {}          # piece -> (ref span, port span)
    for _step in range(60):
        op = rng.choice(["open", "advance", "advance", "retire", "pulse"])
        num = rng.randrange(4)
        if op == "open" and num not in spans \
                and num not in port_ts.md.pieces:
            piece = content[num * PIECE:(num + 1) * PIECE]
            bufs = bytearray(piece), bytearray(piece)
            spans[num] = (
                ref_hub.open_span(TASK, num * PIECE, PIECE, bufs[0], [
                    ref_msg.PieceInfo(piece_num=num, range_start=num * PIECE,
                                      range_size=PIECE)]),
                port_hub.open_span(TASK, num * PIECE, PIECE, bufs[1], [
                    PieceInfo(piece_num=num, range_start=num * PIECE,
                              range_size=PIECE)]))
        elif op == "advance" and num in spans:
            mark = rng.randrange(PIECE + 1)
            for span in spans[num]:
                span.advance(mark)
        elif op == "retire" and num in spans:
            if rng.random() < 0.7:        # landed, else failed
                piece = content[num * PIECE:(num + 1) * PIECE]
                ref_ts.write_piece(num, num * PIECE, piece)
                port_ts.write_piece(num, num * PIECE, piece)
            ref_span, port_span = spans.pop(num)
            ref_hub.retire(ref_span)
            port_hub.retire(port_span)
        elif op == "pulse":
            ref_hub.pulse(TASK)
            port_hub.pulse(TASK)
        for pos in range(0, TOTAL, PIECE // 2):
            assert port_hub.available_end(TASK, port_ts, pos, TOTAL) == \
                ref_hub.available_end(TASK, ref_ts, pos, TOTAL)
            assert port_hub.read_span(TASK, pos, 4096) == \
                ref_hub.read_span(TASK, pos, 4096)
        assert port_hub.progress(TASK, port_ts) == \
            ref_hub.progress(TASK, ref_ts)
        assert _infos(port_hub.inflight_infos(TASK)) == \
            _infos(ref_hub.inflight_infos(TASK))


def test_relay_piece_packet_bytes_match_reference(tmp_path, ref_native_lib):
    """``GetPieceTasks`` on a task with landed and in-flight pieces: the
    same packet bytes (``relay_nums``, ``progress``) from both services
    (with both native libraries built, both land crc32c digests)."""
    content = seeded(TOTAL, 21)
    out = []
    for pkg in ("ref", "port"):
        mgr, ts = make_task(tmp_path, pkg)
        for num in (0, 2):
            ts.write_piece(num, num * PIECE,
                           content[num * PIECE:(num + 1) * PIECE])
        hub, msg, svc_cls, base = (
            (RefRelayHub(), ref_msg, RefDaemonService, ref_base)
            if pkg == "ref" else
            (RelayHub(), port_msg, DaemonService, port_base))
        hub.track(TASK, total_pieces=4)
        for num in (1, 3):
            piece = content[num * PIECE:(num + 1) * PIECE]
            hub.open_span(TASK, num * PIECE, PIECE, bytearray(piece), [
                msg.PieceInfo(piece_num=num, range_start=num * PIECE,
                              range_size=PIECE,
                              digest=ref_digest.for_bytes("crc32c", piece))])
        ptm = types.SimpleNamespace(storage_mgr=mgr, relay=hub,
                                    conductor=lambda _tid: None,
                                    is_seed=False)
        svc = svc_cls(ptm, upload_addr="127.0.0.1:65000")
        packet = asyncio.run(svc.get_piece_tasks(msg.PieceTaskRequest(
            task_id=TASK, src_peer_id="child", dst_peer_id="parent",
            start_num=0, limit=16), None))
        assert packet.relay_nums == [1, 3] and packet.progress == 2
        out.append(base.dumps(packet))
    assert out[0] == out[1]


def test_relay_fanout_rulings_match_reference(frozen_clock):
    """A staged 64-host cluster whose DAG gives some parents two or more
    children: with relay_fanout=2, the parents and the decision rows
    (their ``relay`` notes included) equal the reference's."""
    ref_task, port_task, _rs, _ps, ids = _cluster(11, frozen_clock)
    rng = np.random.default_rng(11)
    for i in range(1, len(ids)):
        ups = [ids[int(rng.integers(i))]]
        ref_task.set_parents(ids[i], ups)
        port_task.set_parents(ids[i], ups)
    noted = 0
    for i, cid in enumerate(ids[16:]):
        for kind in ("find_parents", "refresh_parents"):
            ref_rows, port_rows = [], []
            random.seed(500 + i)
            ref_sched = RefScheduling(
                ref_config.SchedulerConfig(relay_fanout=2), RefEvaluator())
            ref_sched.decision_sink = ref_rows.append
            ref_parents = getattr(ref_sched, kind)(ref_task.peers[cid])
            port_sched = Scheduling(Evaluator(), rng=random.Random(500 + i),
                                    relay_fanout=2)
            port_sched.decision_sink = port_rows.append
            port_parents = getattr(port_sched, kind)(port_task.peers[cid])
            assert [p.id for p in port_parents] == \
                [p.id for p in ref_parents]
            assert port_rows == ref_rows
            noted += sum("relay" in r for r in port_rows)
    assert noted > 0


# ---------------------------------------------------------------- buffers


def test_relay_reads_leave_the_pooled_buffer_reusable(tmp_path):
    """A span over a pooled buffer, read through the hub and served
    through the upload server, then retired: the buffer goes back to the
    pool and the next acquire of that size gets the same object."""
    size = 3 * PIECE + 17

    async def go():
        mgr, _ts = make_task(tmp_path)
        hub = RelayHub()
        hub.track(TASK, total_pieces=4)
        buf = POOL.acquire(size)
        buf[:] = seeded(size, 31)
        span = hub.open_span(TASK, 0, size, buf, [
            PieceInfo(piece_num=n, range_start=n * PIECE,
                      range_size=min(PIECE, size - n * PIECE))
            for n in range(4)])
        span.advance(size)
        assert hub.read_span(TASK, 100, 1000) == bytes(buf[100:1100])
        srv = await start_server(mgr, hub)
        try:
            r = await http_get(srv.port, PATH, {
                "Range": f"bytes=0-{2 * PIECE - 1}"})
            assert r["status"] == 206 and r["body"] == bytes(buf[:2 * PIECE])
        finally:
            await srv.stop()
        hub.retire(span)
        POOL.release(buf)
        assert POOL.acquire(size) is buf
    run(go())


# ----------------------------------------------------------- the chain's rule


def _staged_chain(res_mod, msg_mod, res=None):
    """seed -> L1 -> L2 with one upload slot per host, and L3 registered
    but not yet ruled (running, no piece, no parent)."""
    if res is None:
        res = res_mod.Resource(peer_upload_limit=1, seed_upload_limit=1)
    task = res.get_or_create_task("c" * 64, "http://o/w")
    task.set_content_info(8 << 20, 1 << 20, 8)
    peers = {}
    for name, kind in (("seed", msg_mod.HostType.SUPER_SEED),
                       ("l1", msg_mod.HostType.NORMAL),
                       ("l2", msg_mod.HostType.NORMAL),
                       ("l3", msg_mod.HostType.NORMAL)):
        host = res.store_host(msg_mod.Host(id=f"h-{name}", ip="127.0.0.1",
                                           hostname=name, type=kind))
        peer = res.get_or_create_peer(f"p-{name}", task, host)
        peer.transit(res_mod.PeerState.RUNNING)
        peers[name] = peer
    peers["seed"].finished_pieces.update(range(4))
    peers["l1"].finished_pieces.update(range(2))
    peers["l2"].finished_pieces.add(0)
    for child, parent in (("l1", "seed"), ("l2", "l1")):
        task.set_parents(f"p-{child}", [f"p-{parent}"])
        peers[child].last_offer_ids = {f"p-{parent}"}
        peers[child].schedule_count = 1
    return task, peers


def test_an_unruled_peer_offered_as_a_parent_is_cycle_blocked():
    """A fault shared with the reference (ROADMAP Queue 3): L3, registered
    but not yet ruled, is offered to L2's refresh as a pieceless sibling;
    L2's edge to it makes L1 and L2 L3's descendants, so L3's own first
    ruling finds nothing (cycle, and the seed's one slot is taken) until
    they finish. Both packages rule the same."""
    from dragonfly2_tpu.scheduler import resource as ref_resource
    from dragonfly2_tpu_torch.scheduler import resource as port_resource
    rulings = {}
    for pkg, res_mod, msg_mod, sched in (
            ("ref", ref_resource, ref_msg,
             RefScheduling(ref_config.SchedulerConfig(relay_fanout=1),
                           RefEvaluator())),
            ("port", port_resource, port_msg,
             Scheduling(Evaluator(), relay_fanout=1))):
        random.seed(0)
        task, peers = _staged_chain(res_mod, msg_mod)
        offer = sched.refresh_parents(peers["l2"])
        task.set_parents("p-l2", [p.id for p in offer])
        rulings[pkg] = ([p.id for p in offer],
                        [p.id for p in sched.find_parents(peers["l3"])])
    assert rulings["ref"] == rulings["port"] == (["p-l1", "p-l3"], [])


def test_first_ruling_drops_the_edges_a_refresh_gave_an_unruled_peer():
    """The port's repair of the fault above (ROADMAP Queue 3): the
    scheduler's first ruling of a peer that holds nothing drops the edges
    other peers' offers gave it, so L3 is ruled under L2 at once, and the
    upload slot the premature edge held comes back."""
    from dragonfly2_tpu_torch.scheduler import resource as port_resource
    from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
    from dragonfly2_tpu_torch.scheduler.server import Scheduler

    async def go():
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", relay_fanout=1, peer_upload_limit=1,
            seed_upload_limit=1), rng=random.Random(0))
        task, peers = _staged_chain(port_resource, port_msg, sched.resource)
        offer = sched.scheduling.refresh_parents(peers["l2"])
        task.set_parents("p-l2", [p.id for p in offer])
        assert task.dag.parents("p-l2") == {"p-l1", "p-l3"}
        assert peers["l3"].host.free_upload_slots() == 0
        sink: asyncio.Queue = asyncio.Queue()
        await sched.service._schedule_with_patience(peers["l3"], sink)
        packet = sink.get_nowait()
        assert packet.main_peer.peer_id == "p-l2"
        assert not packet.candidate_peers
        assert task.dag.parents("p-l2") == {"p-l1"}
        assert task.dag.parents("p-l3") == {"p-l2"}
        assert peers["l3"].host.free_upload_slots() == 1
        assert peers["l2"].host.free_upload_slots() == 0
    run(go())
