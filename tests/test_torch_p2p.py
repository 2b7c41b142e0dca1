"""The P2P piece path: dispatcher, upload interop and a whole pull on the
CPU, against the reference.

* Dispatcher: the reference's three ``TestPieceDispatcher`` cases
  (``tests/test_p2p.py``), on the port.
* Upload interop: the reference's ``PieceDownloader`` fetches ranges from
  the port's ``UploadServer`` and the port's from the reference's; both
  get the same bytes (the short last piece included), and both servers
  answer the same raw requests with the same status codes (206, 400
  without ``Range``, 404 for an unknown task, 416 out of range or not
  stored yet). A busy server answers 503 with a retry hint, and a
  nonzero rate limit holds the serve to its rate.
* End to end: a port scheduler, a seed and two leechers with
  ``device="cpu"`` pull a seeded 20 MiB file in manifest mode with
  back-source disabled; the second leecher, driven through its
  unix-socket ``Download`` RPC, is placed under the first.
  Every tensor equals the origin's, the origin is read once, and each
  leecher's ``traffic_p2p`` is the file size. The same pull through the
  reference's scheduler and daemons gives the same task id, piece size
  and count, per-piece digests (crc32c, with both packages' native
  libraries built) and final sha256.
* Control path: a register fails over past a dead scheduler; a leecher
  without parents fails without reading the origin; the daemon's limits
  and its advertised address are the reference's.

Tolerances are exact. Every test that starts servers runs under
``asyncio.wait_for`` with a limit of its own.
"""

import asyncio
import hashlib
import socket
import time

import numpy as np
import pytest
import torch

import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.common.errors import DFError as RefDFError
from dragonfly2_tpu.daemon import config as ref_dconfig
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.daemon.piece_downloader import (
    PieceDownloader as RefPieceDownloader)
from dragonfly2_tpu.daemon.upload_server import UploadServer as RefUploadServer
from dragonfly2_tpu.scheduler import Scheduler as RefScheduler
from dragonfly2_tpu.scheduler import SchedulerConfig as RefSchedulerConfig
from dragonfly2_tpu.scheduler.config import SeedPeerAddr as RefSeedPeerAddr
from dragonfly2_tpu.storage.manager import StorageConfig as RefStorageConfig
from dragonfly2_tpu.storage.manager import StorageManager as RefStorageManager
from dragonfly2_tpu.storage.metadata import TaskMetadata as RefTaskMetadata
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch import source as port_source
from dragonfly2_tpu_torch.common import ids
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.daemon.piece_dispatcher import PieceDispatcher
from dragonfly2_tpu_torch.daemon.piece_downloader import PieceDownloader
from dragonfly2_tpu_torch.daemon.piece_engine import (PIECE_PARALLELISM,
                                                      PIECE_TIMEOUT_S,
                                                      SCHEDULE_TIMEOUT_S)
from dragonfly2_tpu_torch.daemon.upload_server import UploadServer
from dragonfly2_tpu_torch.rpc import Channel, ServiceClient
from dragonfly2_tpu_torch.rpc.balancer import HashRing
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.source.file_client import FileSourceClient
from dragonfly2_tpu_torch.storage.manager import StorageConfig, StorageManager
from dragonfly2_tpu_torch.storage.metadata import TaskMetadata
from test_torch_native import ref_native_lib  # noqa: F401 - fixture

MiB = 1 << 20
SERVER_LIMIT_S = 8.0
E2E_LIMIT_S = 30.0


# ---------------------------------------------------------------- dispatcher

class TestPieceDispatcher:
    def test_prefers_fast_parent(self):
        async def go():
            d = PieceDispatcher(explore_ratio=0.0)
            fast = await d.add_parent("fast", "127.0.0.1:1")
            slow = await d.add_parent("slow", "127.0.0.1:2")
            fast.observe(10, 4 << 20, True)     # ~2.4 ns/B
            slow.observe(400, 4 << 20, True)    # ~95 ns/B
            await d.announce("fast", [port_msg.PieceInfo(piece_num=0,
                                                         range_size=100)])
            await d.announce("slow", [port_msg.PieceInfo(piece_num=0,
                                                         range_size=100)])
            got = await d.get(timeout=1.0)
            assert got is not None and got.parent.peer_id == "fast"
        asyncio.run(go())

    def test_failure_ejects_parent_and_rehomes(self):
        async def go():
            d = PieceDispatcher(explore_ratio=0.0)
            await d.add_parent("bad", "127.0.0.1:1")
            await d.announce("bad", [port_msg.PieceInfo(piece_num=0,
                                                        range_size=10)])
            for _ in range(3):
                disp = await d.get(timeout=1.0)
                assert disp is not None
                await d.report(disp, ok=False)
            assert not d.has_live_parent()
            # a new healthy parent announcing the same piece takes over
            await d.add_parent("good", "127.0.0.1:2")
            await d.announce("good", [port_msg.PieceInfo(piece_num=0,
                                                         range_size=10)])
            disp = await d.get(timeout=1.0)
            assert disp is not None and disp.parent.peer_id == "good"
            await d.report(disp, ok=True, cost_ms=5)
            assert d.pending_count() == 0
        asyncio.run(go())

    def test_lowest_piece_first(self):
        async def go():
            # ordered mode (stream consumers); file tasks use rarest-first
            d = PieceDispatcher(explore_ratio=0.0, ordered=True)
            await d.add_parent("p", "127.0.0.1:1")
            await d.announce("p", [port_msg.PieceInfo(piece_num=5,
                                                      range_size=10),
                                   port_msg.PieceInfo(piece_num=1,
                                                      range_size=10),
                                   port_msg.PieceInfo(piece_num=3,
                                                      range_size=10)])
            disp = await d.get(timeout=1.0)
            assert disp is not None and disp.piece.piece_num == 1
        asyncio.run(go())


# ---------------------------------------------------------------- upload

PIECE = 1 * MiB
TASK = "a" * 64
PARTIAL = "b" * 64


def _content(seed: int = 3) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, 2 * PIECE + PIECE // 2, dtype=np.uint8).tobytes()


def _fill(mgr, md_cls, data: bytes) -> None:
    """A complete 3-piece task (short last piece) and a partial one that
    holds only piece 0."""
    for task_id, nums in ((TASK, (0, 1, 2)), (PARTIAL, (0,))):
        ts = mgr.register_task(md_cls(
            task_id=task_id, url="file:///x", content_length=len(data),
            total_piece_count=3, piece_size=PIECE))
        for n in nums:
            ts.write_piece(n, n * PIECE, data[n * PIECE:(n + 1) * PIECE])
        if task_id == TASK:
            ts.mark_done(success=True)


def _infos(data: bytes) -> list:
    return [port_msg.PieceInfo(piece_num=n, range_start=n * PIECE,
                               range_size=min(PIECE, len(data) - n * PIECE))
            for n in range(3)]


async def _raw_status(port: int, path: str, headers: dict) -> tuple:
    """(status, body) of one raw HTTP/1.1 GET."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = [f"GET {path} HTTP/1.1", "Host: peer", "Connection: close"]
    head += [f"{k}: {v}" for k, v in headers.items()]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
    raw = await reader.read()
    writer.close()
    status_line, _, rest = raw.partition(b"\r\n")
    return int(status_line.split()[1]), rest.partition(b"\r\n\r\n")[2]


def test_upload_servers_interoperate(tmp_path):
    data = _content()

    async def main():
        port_mgr = StorageManager(StorageConfig(
            data_dir=str(tmp_path / "port")))
        ref_mgr = RefStorageManager(RefStorageConfig(
            data_dir=str(tmp_path / "ref"), gc_interval_s=3600))
        _fill(port_mgr, TaskMetadata, data)
        _fill(ref_mgr, RefTaskMetadata, data)
        port_srv = UploadServer(port_mgr, host="127.0.0.1")
        ref_srv = RefUploadServer(ref_mgr, host="127.0.0.1")
        await port_srv.start()
        await ref_srv.start()
        port_dl, ref_dl = PieceDownloader(timeout_s=5), RefPieceDownloader(
            timeout_s=5)
        try:
            infos = _infos(data)
            # each package's downloader against the other's server
            for dl, srv, msg in ((ref_dl, port_srv, ref_msg),
                                 (port_dl, ref_srv, port_msg)):
                addr = f"127.0.0.1:{srv.port}"
                for info in infos:
                    buf, _ = await dl.download_span(
                        dst_addr=addr, task_id=TASK, src_peer_id="peer-x",
                        pieces=[msg.PieceInfo(**info.__dict__)])
                    lo = info.range_start
                    assert bytes(buf) == data[lo:lo + info.range_size]
                buf, _ = await dl.download_span(
                    dst_addr=addr, task_id=TASK, src_peer_id="peer-x",
                    pieces=[msg.PieceInfo(**i.__dict__) for i in infos[1:]])
                assert bytes(buf) == data[PIECE:]
                for task_id, start in ((TASK, len(data) + 10),
                                       ("c" * 64, 0), (PARTIAL, PIECE)):
                    with pytest.raises((DFError, RefDFError)) as err:
                        await dl.download_span(
                            dst_addr=addr, task_id=task_id,
                            src_peer_id="peer-x", pieces=[msg.PieceInfo(
                                piece_num=1, range_start=start,
                                range_size=PIECE)])
                    assert int(err.value.code) == \
                        int(Code.CLIENT_PIECE_DOWNLOAD_FAIL)
                    assert err.value.fail_code == "refused"
            # the same raw requests get the same answers from both servers
            path = f"/download/{TASK[:3]}/{TASK}?peerId=p"
            cases = [(path, {"Range": "bytes=0-9"}),
                     (path, {"Range": f"bytes={2 * PIECE}-"}),
                     (path, {}),
                     (path, {"Range": f"bytes={len(data)}-"}),
                     (f"/download/ccc/{'c' * 64}", {"Range": "bytes=0-9"}),
                     (f"/download/{PARTIAL[:3]}/{PARTIAL}",
                      {"Range": f"bytes={PIECE}-{PIECE + 9}"}),
                     ("/healthy", {})]
            for path_, headers in cases:
                got_port = await _raw_status(port_srv.port, path_, headers)
                got_ref = await _raw_status(ref_srv.port, path_, headers)
                assert got_port[0] == got_ref[0], (path_, headers)
                if got_port[0] in (200, 206):
                    assert got_port[1] == got_ref[1]
            assert [c for c, _ in [await _raw_status(port_srv.port, p, h)
                                   for p, h in cases]] == \
                [206, 206, 400, 416, 404, 416, 200]
        finally:
            await port_dl.close()
            await ref_dl.close()
            await port_srv.stop()
            await ref_srv.stop()
    asyncio.run(asyncio.wait_for(main(), SERVER_LIMIT_S))


def test_busy_parent_answers_503_with_a_retry_hint(tmp_path):
    data = _content()

    async def main():
        mgr = StorageManager(StorageConfig(
            data_dir=str(tmp_path / "port")))
        _fill(mgr, TaskMetadata, data)
        srv = UploadServer(mgr, host="127.0.0.1", concurrent_limit=1)
        srv.SLOT_WAIT_S = 0.05
        await srv.start()
        dl = PieceDownloader(timeout_s=5)
        try:
            held = await srv._acquire_slot()          # the one slot
            with pytest.raises(DFError) as err:
                await dl.download_span(
                    dst_addr=f"127.0.0.1:{srv.port}", task_id=TASK,
                    src_peer_id="p", pieces=_infos(data)[:1])
            assert err.value.code == Code.CLIENT_PEER_BUSY
            assert err.value.retry_after_ms >= 50
            held.release()
            buf, _ = await dl.download_span(
                dst_addr=f"127.0.0.1:{srv.port}", task_id=TASK,
                src_peer_id="p", pieces=_infos(data)[:1])
            assert bytes(buf) == data[:PIECE]
            assert srv._active == 0
        finally:
            await dl.close()
            await srv.stop()
    asyncio.run(asyncio.wait_for(main(), SERVER_LIMIT_S))


# ---------------------------------------------------------------- end to end

class _CountingFileClient(FileSourceClient):
    """``file://`` origin that counts the bytes it serves."""

    def __init__(self):
        self.bytes_read = 0

    async def download(self, req):
        resp = await super().download(req)
        inner = resp.chunks

        async def counted():
            async for chunk in inner:
                self.bytes_read += len(chunk)
                yield chunk
        resp.chunks = counted()
        return resp


def _origin(tmp_path) -> tuple[str, bytes, list[dict]]:
    """A seeded 20 MiB + 12345-byte file and a manifest of four bf16
    tensors (one shaped) with a gap before the last."""
    data = np.random.default_rng(11).integers(
        0, 256, 20 * MiB + 12345, dtype=np.uint8).tobytes()
    path = tmp_path / "origin.bin"
    path.write_bytes(data)
    q = 5 * MiB
    shards = [dict(name="embed", range_start=0, range_size=q,
                   dtype="bfloat16", shape=[640, 4096]),
              dict(name="w1", range_start=q, range_size=q, dtype="bfloat16"),
              dict(name="w2", range_start=2 * q, range_size=q,
                   dtype="bfloat16"),
              dict(name="tail", range_start=3 * q + 4096,
                   range_size=q + 8192, dtype="uint8")]
    return f"file://{path}", data, shards


def _holding(daemon, task_id: str) -> dict:
    ts = daemon.storage_mgr.get(task_id)
    with open(ts.data_path(), "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    return {"task_id": task_id, "piece_size": ts.md.piece_size,
            "pieces": ts.md.total_piece_count,
            "digests": {n: p.digest for n, p in ts.md.pieces.items()},
            "sha256": sha}


async def _pull(daemon, msg, url: str, shards: list[dict], sink: bool,
                local_api: bool = False):
    """One pull; ``local_api`` sends it through the daemon's unix-socket
    ``Download`` RPC instead of calling the task manager."""
    req = msg.DownloadRequest(
        url=url, disable_back_source=True, timeout_s=E2E_LIMIT_S,
        shard_manifest=msg.ShardManifest(
            shards=[msg.ShardInfo(**s) for s in shards]),
        device_sink=msg.DeviceSink(enabled=sink))
    task_id = None
    if local_api:
        ch = Channel(f"unix:{daemon.unix_sock}")
        try:
            async for resp in ServiceClient(ch, "df.daemon.Daemon") \
                    .unary_stream("Download", req):
                task_id = resp.task_id or task_id
        finally:
            await ch.close()
        return task_id
    async for resp in daemon.ptm.start_file_task(req):
        task_id = resp.task_id or task_id
    return task_id


def test_p2p_pull_on_cpu_matches_reference(tmp_path, ref_native_lib):
    """With both native libraries built, both pods record crc32c piece
    digests, and the same ones."""
    url, data, shards = _origin(tmp_path)
    counting = _CountingFileClient()

    async def port_pod() -> list[dict]:
        seed = Daemon(DaemonConfig(workdir=str(tmp_path / "p-seed"),
                                   hostname="seed", is_seed=True,
                                   listen_ip="127.0.0.1", host_ip="127.0.0.1",
                                   device="cpu"))
        await seed.start()
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1", seed_peers=[
            SeedPeerAddr(host_id=seed.host_info().id, ip="127.0.0.1",
                         rpc_port=seed.rpc.port,
                         download_port=seed.upload_server.port)]))
        await sched.start()
        leechers = [Daemon(DaemonConfig(
            workdir=str(tmp_path / f"p-{n}"), hostname=n,
            listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
            scheduler=DaemonSched(addresses=[sched.address])))
            for n in ("a", "b")]
        out = []
        try:
            for d in leechers:
                await d.start()
            for i, d in enumerate(leechers):
                task_id = await _pull(d, port_msg, url, shards, sink=True,
                                      local_api=i == 1)
                c = d.ptm.conductor(task_id)
                tensors = c.device_ingest.result(10)
                for s in shards:
                    t = tensors[s["name"]]
                    assert t.device == torch.device("cpu")
                    want = data[s["range_start"]:
                                s["range_start"] + s["range_size"]]
                    assert t.reshape(-1).view(torch.uint8).numpy() \
                        .tobytes() == want
                assert tensors["embed"].shape == (640, 4096)
                assert tensors["embed"].dtype == torch.bfloat16
                assert c.traffic_p2p == len(data)
                assert c.traffic_source == 0
                out.append({**_holding(d, task_id),
                            "parents": dict(c.pieces_by_parent)})
            a_peer = leechers[0].ptm.conductor(out[0]["task_id"]).peer_id
            # the scheduler placed the second leecher under the first
            assert out[1]["parents"].get(a_peer, 0) > 0
        finally:
            for d in leechers:
                await d.stop()
            await sched.stop()
            await seed.stop()
        return out

    async def ref_pod() -> list[dict]:
        def cfg(name):
            return ref_dconfig.DaemonConfig(
                workdir=str(tmp_path / f"r-{name}"), host_ip="127.0.0.1",
                hostname=name,
                storage=ref_dconfig.StorageSection(gc_interval_s=3600))
        seed_cfg = cfg("seed")
        seed_cfg.is_seed = True
        seed = RefDaemon(seed_cfg)
        await seed.start()
        sched = RefScheduler(RefSchedulerConfig(seed_peers=[RefSeedPeerAddr(
            ip="127.0.0.1", rpc_port=seed.rpc.port,
            download_port=seed.upload_server.port)]))
        await sched.start()
        leechers = []
        for n in ("a", "b"):
            c = cfg(n)
            c.scheduler = ref_dconfig.SchedulerConfig(
                addresses=[sched.address], schedule_timeout_s=20.0)
            leechers.append(RefDaemon(c))
        out = []
        try:
            for d in leechers:
                await d.start()
            for d in leechers:
                task_id = await _pull(d, ref_msg, url, shards, sink=False)
                out.append(_holding(d, task_id))
        finally:
            for d in leechers:
                await d.stop()
            await sched.stop()
            await seed.stop()
        return out

    previous = port_source.client_for("file://")
    port_source.register_client("file", counting)
    try:
        got = asyncio.run(asyncio.wait_for(port_pod(), E2E_LIMIT_S))
    finally:
        port_source.register_client("file", previous)
    assert counting.bytes_read == len(data)          # origin read once
    want = asyncio.run(asyncio.wait_for(ref_pod(), E2E_LIMIT_S))
    for g, w in zip(got, want):
        g.pop("parents")
        assert g == w
        assert all(d.startswith("crc32c:") for d in g["digests"].values())
    assert got[0]["pieces"] == 6 and got[0]["piece_size"] == 4 * MiB


def test_leecher_without_parents_fails_without_origin(tmp_path):
    """No seed, no holder: the scheduler rules back-source, and with
    back-source disabled the task fails with CLIENT_BACK_SOURCE_ERROR
    without reading the origin."""
    url, _, shards = _origin(tmp_path)
    counting = _CountingFileClient()

    async def main():
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1"))
        await sched.start()
        d = Daemon(DaemonConfig(
            workdir=str(tmp_path / "lonely"), hostname="lonely",
            listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
            scheduler=DaemonSched(addresses=[sched.address])))
        await d.start()
        try:
            with pytest.raises(DFError) as err:
                await _pull(d, port_msg, url, shards, sink=False)
            assert err.value.code == Code.CLIENT_BACK_SOURCE_ERROR
        finally:
            await d.stop()
            await sched.stop()

    previous = port_source.client_for("file://")
    port_source.register_client("file", counting)
    try:
        asyncio.run(asyncio.wait_for(main(), SERVER_LIMIT_S))
    finally:
        port_source.register_client("file", previous)
    assert counting.bytes_read == 0


def test_register_fails_over_past_a_dead_scheduler(tmp_path):
    """With the hashed scheduler dead (a bound port that refuses), the
    register moves to the next ring member, which answers; the dead one
    is demoted and the live one's verdict comes back."""
    url, _, _ = _origin(tmp_path)
    task_id = ids.task_id(url)
    dead_socks = []

    async def main():
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1"))
        await sched.start()
        # a dead member that the ring ranks first for this task
        while True:
            sock = socket.socket()
            sock.bind(("127.0.0.1", 0))
            dead_socks.append(sock)
            dead = f"127.0.0.1:{sock.getsockname()[1]}"
            if HashRing([dead, sched.address]).pick_n(
                    task_id, DaemonSched().failover_n)[0] == dead:
                break
        d = Daemon(DaemonConfig(
            workdir=str(tmp_path / "fo"), hostname="fo",
            listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
            scheduler=DaemonSched(addresses=[dead, sched.address])))
        await d.start()
        try:
            with pytest.raises(DFError) as err:
                await _pull(d, port_msg, url, [], sink=False)
            assert err.value.code == Code.CLIENT_BACK_SOURCE_ERROR
            assert list(d.scheduler._demoted) == [dead]
        finally:
            await d.stop()
            await sched.stop()

    try:
        asyncio.run(asyncio.wait_for(main(), SERVER_LIMIT_S))
    finally:
        for sock in dead_socks:
            sock.close()


def test_register_failover_journals_the_rung_and_marks_a_replay(tmp_path):
    """The hashed scheduler's register is faulted dead (``sched.register``)
    and the next ring member answers: in both packages the flight's rungs
    are ``ring_failover`` then ``p2p``, the task is served P2P without
    origin bytes, the connector holds the answering scheduler's epoch,
    the dead member is demoted and a content replay is marked
    (``reconcile_event``; the announcer, which would drain it, is
    stopped first)."""
    from dragonfly2_tpu.common import faultgate as ref_faultgate
    from dragonfly2_tpu_torch.common import faultgate

    url, data, _ = _origin(tmp_path)
    task_id = ids.task_id(url)

    async def pod(pkg: str) -> dict:
        if pkg == "port":
            gate, make_daemon, make_sched = faultgate, Daemon, Scheduler
            cfg = lambda name, **kw: DaemonConfig(  # noqa: E731
                workdir=str(tmp_path / f"{pkg}-{name}"), hostname=name,
                listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
                **kw)
            sched_cfg = lambda seeds: SchedulerConfig(  # noqa: E731
                listen_ip="127.0.0.1", seed_peers=seeds)
            seed_addr, sched_c, msg = SeedPeerAddr, DaemonSched, port_msg
        else:
            gate, make_daemon, make_sched = (ref_faultgate, RefDaemon,
                                             RefScheduler)
            cfg = lambda name, **kw: ref_dconfig.DaemonConfig(  # noqa: E731
                workdir=str(tmp_path / f"{pkg}-{name}"), hostname=name,
                host_ip="127.0.0.1",
                storage=ref_dconfig.StorageSection(gc_interval_s=3600), **kw)
            sched_cfg = lambda seeds: RefSchedulerConfig(  # noqa: E731
                seed_peers=seeds)
            seed_addr, sched_c, msg = (RefSeedPeerAddr,
                                       ref_dconfig.SchedulerConfig, ref_msg)
        seed = make_daemon(cfg("seed", is_seed=True))
        await seed.start()
        seeds = [seed_addr(host_id=seed.host_info().id, ip="127.0.0.1",
                           rpc_port=seed.rpc.port,
                           download_port=seed.upload_server.port)]
        scheds = [make_sched(sched_cfg(seeds)) for _ in range(2)]
        for sc in scheds:
            await sc.start()
        leech = make_daemon(cfg("leech", scheduler=sched_c(
            addresses=[sc.address for sc in scheds],
            schedule_timeout_s=20.0, demote_s=60.0)))
        await leech.start()
        await leech.announcer.stop()
        dead = leech.scheduler._candidates(task_id)[0]
        live = next(sc for sc in scheds if sc.address != dead)
        script = gate.arm("sched.register", "fail", key=dead, n=-1)
        try:
            async for _ in leech.ptm.start_file_task(msg.DownloadRequest(
                    url=url, output=str(tmp_path / f"{pkg}-out"),
                    disable_back_source=True, timeout_s=E2E_LIMIT_S)):
                pass
            c = leech.ptm.conductor(task_id)
            return {"rungs": c.flight.summarize()["rungs"],
                    "served": c.flight.summarize()["served_rung"],
                    "p2p": c.traffic_p2p, "source": c.traffic_source,
                    "fired": script.fired,
                    "epoch": leech.scheduler._epoch == live.service.epoch,
                    "replay": leech.scheduler.reconcile_event.is_set(),
                    "demoted": sorted(leech.scheduler.demoted()) == [dead],
                    "bytes": (tmp_path / f"{pkg}-out").read_bytes() == data}
        finally:
            gate.reset()
            await leech.stop()
            for sc in scheds:
                await sc.stop()
            await seed.stop()

    got = asyncio.run(asyncio.wait_for(pod("port"), E2E_LIMIT_S))
    want = asyncio.run(asyncio.wait_for(pod("ref"), E2E_LIMIT_S))
    assert got == want
    assert got == {"rungs": ["ring_failover", "p2p"], "served": "p2p",
                   "p2p": len(data), "source": 0, "fired": 1, "epoch": True,
                   "replay": True, "demoted": True, "bytes": True}


def test_a_seed_that_knows_its_scheduler_serves_its_first_leecher(
        tmp_path):
    """The seed's ``ObtainSeeds`` download does not register with the
    scheduler: registered, it was offered its first leecher (running,
    pieceless) as a parent while that leecher waited on it, and the pull
    failed after the scheduler's patience in both packages. The seed now
    back-sources at once, and the leecher is served P2P."""
    url, data, _ = _origin(tmp_path)
    task_id = ids.task_id(url)

    async def main():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        addr = f"127.0.0.1:{port}"

        def cfg(name, **kw):
            return DaemonConfig(
                workdir=str(tmp_path / name), hostname=name,
                listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
                scheduler=DaemonSched(addresses=[addr]), **kw)
        seed = Daemon(cfg("seed", is_seed=True))
        await seed.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", port=port, seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await sched.start()
        leech = Daemon(cfg("leech"))
        await leech.start()
        try:
            await _pull(leech, port_msg, url, [], sink=False)
            c = leech.ptm.conductor(task_id)
            assert (c.traffic_p2p, c.traffic_source) == (len(data), 0)
            seeded = seed.ptm.conductor(task_id)
            assert seeded.flight.summarize()["rungs"] == ["back_source"]
        finally:
            await leech.stop()
            await sched.stop()
            await seed.stop()

    asyncio.run(asyncio.wait_for(main(), SERVER_LIMIT_S))


def test_daemon_limits_are_the_reference_defaults():
    """The daemon's P2P limits, constants or config fields, each equal
    the reference config's default for the same knob."""
    ref = ref_dconfig.DaemonConfig()
    sched = DaemonConfig().scheduler
    assert (PIECE_PARALLELISM, SCHEDULE_TIMEOUT_S, PIECE_TIMEOUT_S,
            sched.schedule_timeout_s, sched.register_timeout_s,
            sched.failover_n, sched.demote_s) == \
        (ref.download.piece_parallelism, ref.scheduler.schedule_timeout_s,
         ref.download.piece_timeout_s, ref.scheduler.schedule_timeout_s,
         ref.scheduler.register_timeout_s, ref.scheduler.failover_n,
         ref.scheduler.demote_s)


def test_advertised_address_is_the_configured_host_ip(tmp_path):
    """The port advertises ``host_ip`` to the scheduler and its children;
    unset, it is the outbound interface's address, found as the reference
    finds it."""
    default = Daemon(DaemonConfig(workdir=str(tmp_path / "d"), device="cpu"))
    ref = RefDaemon(ref_dconfig.DaemonConfig(
        workdir=str(tmp_path / "r"),
        storage=ref_dconfig.StorageSection(gc_interval_s=3600)))
    assert default.host_info().ip == ref.host_ip
    named = Daemon(DaemonConfig(workdir=str(tmp_path / "n"), device="cpu",
                                host_ip="10.1.2.3", hostname="n"))
    assert (named.host_info().ip, named.host_info().id) == \
        ("10.1.2.3", "n-10.1.2.3")


def test_upload_rate_limit_throttles_the_serve(tmp_path):
    """A nonzero ``rate_limit_bps`` holds the upload server to its rate:
    moving more than the bucket's burst (one second of the rate) takes at
    least the excess over the rate."""
    data = _content()
    rate, rounds = 5 * MiB, 4

    async def main():
        mgr = StorageManager(StorageConfig(
            data_dir=str(tmp_path / "port")))
        _fill(mgr, TaskMetadata, data)
        srv = UploadServer(mgr, host="127.0.0.1", rate_limit_bps=rate)
        await srv.start()
        dl = PieceDownloader(timeout_s=5)
        try:
            t0 = time.monotonic()
            for _ in range(rounds):
                for info in _infos(data):
                    buf, _ = await dl.download_span(
                        dst_addr=f"127.0.0.1:{srv.port}", task_id=TASK,
                        src_peer_id="p", pieces=[info])
                    lo = info.range_start
                    assert bytes(buf) == data[lo:lo + info.range_size]
            return time.monotonic() - t0
        finally:
            await dl.close()
            await srv.stop()
    elapsed = asyncio.run(asyncio.wait_for(main(), SERVER_LIMIT_S))
    assert elapsed >= (rounds * len(data) - rate) / rate
