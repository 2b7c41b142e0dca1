"""The daemon announcer and the scheduler's recovery re-announce, on the
port and against the reference.

* ``AnnounceContentRequest`` and ``HeldContentEntry`` encode to the
  reference's msgpack bytes.
* ``Announcer._held_content`` equals the reference's on the same storage.
* The same sealed digest, given to both schedulers' ``announce_content``,
  gives an equal resource view (task and peer states, finished pieces),
  an equal ``tasks_adopted`` and an equal ``recovery`` ledger row; a torn
  digest is refused whole by both.
* An epoch change wakes the announcer's loop before its interval ends.
* Exported demotions round-trip; a blob of another schema is refused
  whole and a blob from a skewed clock is clamped to ``demote_s``, as in
  the reference.
* End to end on the CPU (the reference's ``test_recovery_chaos.py``
  without the state store and quarantine, which wait for Queue 1 item
  5): a seed, two leechers and a scheduler; the scheduler stops and a new
  one starts on its port with a new epoch; the daemons re-announce; a
  fresh leecher, with the origin gone, pulls the same bytes P2P.

Every test that starts servers runs under ``asyncio.wait_for``.
"""

import asyncio
import socket
import time
import types

import numpy as np
import pytest

import dragonfly2_tpu.daemon.announcer as ref_announcer
import dragonfly2_tpu.daemon.pex as ref_pex
import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.common.metrics import REGISTRY as REF_REGISTRY
from dragonfly2_tpu.daemon.scheduler_session import (
    SchedulerConnector as RefConnector)
from dragonfly2_tpu.idl import base as ref_base
from dragonfly2_tpu.scheduler import Scheduler as RefScheduler
from dragonfly2_tpu.scheduler import SchedulerConfig as RefSchedulerConfig
from dragonfly2_tpu.storage import metadata as ref_metadata
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.common.metrics import REGISTRY
from dragonfly2_tpu_torch.daemon import announcer as port_announcer
from dragonfly2_tpu_torch.daemon import pex as port_pex
from dragonfly2_tpu_torch.daemon.config import (DaemonConfig, StorageSection)
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.daemon.scheduler_session import SchedulerConnector
from dragonfly2_tpu_torch.idl import base as port_base
from dragonfly2_tpu_torch.idl.messages import DownloadRequest
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.resource import PeerState, TaskState
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.storage.metadata import PieceMeta, TaskMetadata

LIMIT_S = 20.0
E2E_LIMIT_S = 45.0
EPOCH = 1_700_000_000


def run(coro, limit: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit))


def _storage(md_cls, piece_cls):
    """A completed task, a partial one and one holding nothing."""
    done = md_cls(task_id="d" * 64, url="http://o/d", content_length=12,
                  total_piece_count=3, piece_size=4, done=True, success=True)
    part = md_cls(task_id="p" * 64, url="http://o/p", content_length=20,
                  total_piece_count=5, piece_size=4)
    for md, nums in ((done, (0, 1, 2)), (part, (4, 0, 2))):
        for n in nums:
            md.pieces[n] = piece_cls(num=n, start=4 * n, size=4)
    empty = md_cls(task_id="e" * 64, total_piece_count=2)
    return types.SimpleNamespace(
        tasks=lambda: [types.SimpleNamespace(md=md)
                       for md in (done, part, empty)])


def _fake_daemon(md_cls, piece_cls):
    return types.SimpleNamespace(
        cfg=types.SimpleNamespace(announce_interval_s=30.0),
        storage_mgr=_storage(md_cls, piece_cls))


def test_announce_content_messages_have_the_reference_bytes():
    def build(msg):
        entry = msg.HeldContentEntry(task_id="t" * 64, url="http://o/x",
                                     total_piece_count=7, content_length=99,
                                     piece_size=16, done=False,
                                     pieces=[0, 3, 5])
        host = msg.Host(id="h-127.0.0.1", ip="127.0.0.1", hostname="h",
                        port=7001, download_port=7002,
                        topology=msg.TopologyInfo(slice_name="s",
                                                  ici_coords=(1, 2)))
        return [entry, msg.HeldContentEntry(),
                msg.AnnounceContentRequest(host=host, entries=[entry],
                                           digest=b"abc\n{}"),
                msg.AnnounceContentRequest(),
                msg.AnnounceContentResponse(scheduler_epoch=EPOCH,
                                            tasks_adopted=3)]
    got = [port_base.dumps(m) for m in build(port_msg)]
    want = [ref_base.dumps(m) for m in build(ref_msg)]
    assert got == want
    back = port_base.decode(port_base.loads(got[2]),
                            port_msg.AnnounceContentRequest)
    assert back.entries[0].pieces == [0, 3, 5]


def test_held_content_equals_reference():
    port = port_announcer.Announcer(_fake_daemon(TaskMetadata, PieceMeta))
    ref = ref_announcer.Announcer(_fake_daemon(ref_metadata.TaskMetadata,
                                               ref_metadata.PieceMeta))
    got = port._held_content()
    assert got == ref._held_content()
    assert [e["task_id"][0] for e in got] == ["d", "p"]
    assert got[1]["pieces"] == [0, 2, 4] and "pieces" not in got[0]


def _digest(entries, *, seal=port_pex.seal):
    return seal({"v": port_pex.DIGEST_VERSION, "tasks": entries})


def _view(sched) -> dict:
    res = sched.resource
    return {tid: {"state": t.state.value, "url": t.url,
                  "content_length": t.content_length,
                  "piece_size": t.piece_size,
                  "total": t.total_piece_count,
                  "peers": {pid: (p.state.value, sorted(p.finished_pieces),
                                  p.host.id)
                            for pid, p in t.peers.items()}}
            for tid, t in res.tasks.items()}


def _rows(sched) -> list:
    return [{k: v for k, v in r.items() if k != "created_at"}
            for r in sched.ledger._ring
            if r.get("decision_kind") == "recovery"]


def test_announce_content_rebuilds_the_reference_view():
    daemon = _fake_daemon(TaskMetadata, PieceMeta)
    entries = port_announcer.Announcer(daemon)._held_content()
    digest = _digest(entries)
    assert digest == _digest(entries, seal=ref_pex.seal)

    def drive(sched, msg) -> list:
        sched.service.epoch = EPOCH
        host = msg.Host(id="leech-127.0.0.1", ip="127.0.0.1",
                        hostname="leech", port=7001, download_port=7002)
        out = []
        for raw in (digest, digest[:-2], b""):
            resp = asyncio.run(sched.service.announce_content(
                msg.AnnounceContentRequest(host=host, digest=raw), None))
            out.append((resp.scheduler_epoch, resp.tasks_adopted))
        # a second announce of the same holdings learns no new piece
        resp = asyncio.run(sched.service.announce_content(
            msg.AnnounceContentRequest(host=host, digest=digest), None))
        out.append((resp.scheduler_epoch, resp.tasks_adopted))
        return out

    def counts(registry):
        c = registry.counter("df_sched_recovery_announces_total", "x",
                             ("result",))
        return c.value("adopted"), c.value("rejected")

    port_sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1"))
    ref_sched = RefScheduler(RefSchedulerConfig())
    port_before, ref_before = counts(REGISTRY), counts(REF_REGISTRY)
    got = drive(port_sched, port_msg)
    want = drive(ref_sched, ref_msg)
    assert got == want == [(EPOCH, 2), (EPOCH, 0), (EPOCH, 0), (EPOCH, 2)]
    port_after, ref_after = counts(REGISTRY), counts(REF_REGISTRY)
    assert (port_after[0] - port_before[0], port_after[1] - port_before[1]) \
        == (ref_after[0] - ref_before[0], ref_after[1] - ref_before[1]) \
        == (2, 2)
    view = _view(port_sched)
    assert view == _view(ref_sched)
    recov = "leech-127.0.0.1-recov-" + "d" * 16
    assert view["d" * 64]["state"] == TaskState.SUCCEEDED.value
    assert view["d" * 64]["peers"][recov][0] == PeerState.SUCCEEDED.value
    assert view["p" * 64]["peers"][
        "leech-127.0.0.1-recov-" + "p" * 16][1] == [0, 2, 4]
    rows = _rows(port_sched)
    assert rows == _rows(ref_sched)
    assert [(r["tasks_adopted"], r["pieces_learned"]) for r in rows] == \
        [(2, 3), (2, 0)]
    assert rows[0]["decision_id"] == "r00000001.ch-127.0.0.1"


def test_epoch_change_wakes_the_announcer_early():
    """A 30 s interval: the first pass replays held content, and a
    changed epoch replays again at once, not 30 s later."""
    async def go():
        conn = SchedulerConnector(["127.0.0.1:1"],
                                  port_msg.Host(id="h"))
        calls = []
        epoch = [EPOCH]          # what the scheduler answers

        async def announce_host(req):
            conn.note_epoch(epoch[0])
            calls.append("host")

        async def announce_content(req):
            body = port_pex.unseal(req.digest)
            calls.append(("content", len(body["tasks"])))
            return port_msg.AnnounceContentResponse(tasks_adopted=2)

        conn.announce_host = announce_host
        conn.announce_content = announce_content
        daemon = _fake_daemon(TaskMetadata, PieceMeta)
        daemon.scheduler = conn
        daemon.host_info = lambda: port_msg.Host(id="h")
        daemon.paths = types.SimpleNamespace(data_dir="/")
        ann = port_announcer.Announcer(daemon)
        await ann.start()
        try:
            while len(calls) < 2:
                await asyncio.sleep(0.01)
            assert calls == ["host", ("content", 2)]
            t0 = time.monotonic()
            epoch[0] = EPOCH + 1
            # a register result from the restarted scheduler
            assert conn.note_epoch(EPOCH + 1)
            while len(calls) < 4:
                await asyncio.sleep(0.01)
            assert time.monotonic() - t0 < 2.0
            assert calls[2:] == ["host", ("content", 2)]
            assert not conn.reconcile_event.is_set()
            assert not conn.note_epoch(EPOCH + 1)  # same epoch: no change
        finally:
            await ann.stop()
            await conn.close()

    run(go())


@pytest.mark.parametrize("blob", [
    {"v": 1, "demoted": {"a:1": 5.0, "b:2": 1e6, "gone:3": 5.0,
                         "c:4": -1.0, "d:5": "x"}},
    {"v": 2, "demoted": {"a:1": 5.0}},
    {"demoted": {"a:1": 5.0}},
    ["not", "a", "dict"],
    None])
def test_restore_demotions_matches_reference(blob):
    """Windows are clamped to ``demote_s`` (a skewed clock or a hand edit
    must not demote a member for hours), unknown members are dropped, and
    a blob of another schema is refused whole, as the reference does."""
    addrs = ["a:1", "b:2", "c:4", "d:5"]
    port = SchedulerConnector(addrs, port_msg.Host(id="h"), demote_s=30.0)
    ref = RefConnector(addrs, ref_msg.Host(id="h"), demote_s=30.0)
    assert port.restore_demotions(blob) == ref.restore_demotions(blob)
    assert port.demoted() == ref.demoted()
    exported = port.export_demotions()
    assert set(exported["demoted"]) == set(ref.export_demotions()["demoted"])
    assert all(0 < v <= 30.0 for v in exported["demoted"].values())
    if isinstance(blob, dict) and blob.get("v") == 1:
        assert port.demoted() == {"a:1", "b:2"}
        fresh = SchedulerConnector(addrs, port_msg.Host(id="h"),
                                   demote_s=30.0)
        assert fresh.restore_demotions(exported) == 2
        assert fresh.demoted() == {"a:1", "b:2"}
    else:
        assert port.demoted() == set()


def _seeded(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def test_scheduler_restart_daemons_reannounce_and_serve_p2p(tmp_path):
    data = _seeded((9 << 20) + 4321, 12)
    origin = tmp_path / "origin.bin"
    origin.write_bytes(data)
    url = f"file://{origin}"

    def cfg(name: str, sched_addr: str, **kw) -> DaemonConfig:
        c = DaemonConfig(
            workdir=str(tmp_path / name), hostname=name,
            listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
            storage=StorageSection(gc_interval_s=3600),
            scheduler=DaemonSched(addresses=[sched_addr]), **kw)
        c.announce_interval_s = 0.2
        c.probe_enabled = False
        return c

    async def pull(d: Daemon) -> tuple:
        task_id = None
        out = tmp_path / f"out-{d.hostname}"
        async for resp in d.ptm.start_file_task(DownloadRequest(
                url=url, output=str(out), disable_back_source=True,
                timeout_s=30.0)):
            task_id = resp.task_id or task_id
        c = d.ptm.conductor(task_id)
        return (out.read_bytes() == data, c.traffic_source,
                c.flight.summarize()["rungs"])

    async def go():
        # the seed announces too, so it knows the scheduler's address
        # before the scheduler knows the seed's
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        addr = f"127.0.0.1:{port}"
        seed = Daemon(cfg("seed", addr, is_seed=True))
        await seed.start()
        s1 = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", port=port, seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await s1.start()
        leechers = [Daemon(cfg(n, addr)) for n in ("l1", "l2")]
        s2 = None
        try:
            for d in leechers:
                await d.start()
            for d in leechers:
                ok, source, rungs = await pull(d)
                assert ok and source == 0 and rungs == ["p2p"]
            await s1.stop()
            origin.unlink()
            s2 = Scheduler(SchedulerConfig(listen_ip="127.0.0.1", port=port))
            s2.service.epoch = s1.service.epoch + 1
            await s2.start()
            want = {d.host_info().id for d in (seed, *leechers)}
            deadline = time.monotonic() + 10.0
            while True:
                holders = {p.host.id for t in s2.resource.tasks.values()
                           for p in t.peers.values() if "-recov-" in p.id}
                if holders == want or time.monotonic() > deadline:
                    break
                await asyncio.sleep(0.05)
            assert holders == want
            assert all(t.state == TaskState.SUCCEEDED
                       for t in s2.resource.tasks.values())
            assert len(_rows(s2)) >= 3
            l3 = Daemon(cfg("l3", s2.address))
            await l3.start()
            try:
                ok, source, rungs = await pull(l3)
                assert ok and source == 0 and rungs == ["p2p"]
            finally:
                await l3.stop()
        finally:
            for d in leechers:
                await d.stop()
            await seed.stop()
            if s2 is not None:
                await s2.stop()

    run(go(), E2E_LIMIT_S)
