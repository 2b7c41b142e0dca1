"""Super-seeding: a seed rations its announcements, against the reference.

* The policy (``daemon/rpcserver.py`` ``_SuperSeed``): the reference's
  ``TestSuperSeed`` cases (``tests/test_swarm_machinery.py``), run
  against both packages' classes, plus the reconnect guard of
  ``unsubscribe``. A seeded script of subscribes, landings, starvation
  pings, rotations and departures gives both classes the same reveals in
  the same order (their reveal budgets on one frozen clock).
* The seed's streams: a seed daemon's ``SyncPieceTasks`` opens with a
  geometry-only packet and then carries landed pieces only, never
  ``relay_nums``; a follow-up request on the stream (a starvation ping)
  reaches ``reveal_to``; the policy and its feeder are evicted when the
  last child leaves.
* A pod: a seed and three leechers pulling together, the seed rationing
  at fanout 1 with no rotation. In both packages no packet of the seed's
  streams carries ``relay_nums``, its first packet to each child is
  geometry only, every byte arrives, and (port) the origin is read
  once.
* The swap hold under a rationing seed: a swap-class piece only seeds
  hold waits the swap hold plus two rotation ticks, the time the seed may
  take to tell the replica that owns it.

Tolerances are exact.
"""

import asyncio
import random
import types

import numpy as np
import pytest

import dragonfly2_tpu.common.rate as ref_rate
import dragonfly2_tpu.daemon.piece_engine as ref_engine
import dragonfly2_tpu.daemon.rpcserver as ref_rpcserver
import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.daemon import config as ref_dconfig
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.scheduler import Scheduler as RefScheduler
from dragonfly2_tpu.scheduler import SchedulerConfig as RefSchedulerConfig
from dragonfly2_tpu.scheduler.config import SeedPeerAddr as RefSeedPeerAddr
import dragonfly2_tpu_torch.common.rate as port_rate
import dragonfly2_tpu_torch.daemon.piece_engine as port_engine
import dragonfly2_tpu_torch.daemon.rpcserver as port_rpcserver
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch import source as port_source
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.rpc import Channel, ServiceClient
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.storage.manager import StorageConfig, StorageManager
from dragonfly2_tpu_torch.storage.metadata import TaskMetadata
from test_torch_p2p import _CountingFileClient

MiB = 1 << 20
POD_LIMIT_S = 60.0
CLASSES = {"reference": ref_rpcserver._SuperSeed,
           "port": port_rpcserver._SuperSeed}


@pytest.fixture(params=sorted(CLASSES))
def superseed(request):
    return CLASSES[request.param]


def _drain(q: asyncio.Queue) -> list:
    out = []
    while not q.empty():
        out.append(q.get_nowait())
    return out


# ---------------------------------------------------------------- policy

def test_fanout_rations_each_piece(superseed):
    async def main():
        ss = superseed(fanout=2, rotate_interval_s=3600)
        queues = {f"p{i}": ss.subscribe(f"p{i}") for i in range(6)}
        ss.on_piece(0)
        told = [pid for pid, q in queues.items() if not q.empty()]
        assert len(told) == 2
        assert len(ss.assigned[0]) == 2
        for pid in list(ss.subs):
            ss.unsubscribe(pid)
    asyncio.run(main())


def test_load_spreads_across_children(superseed):
    async def main():
        ss = superseed(fanout=1, rotate_interval_s=3600)
        for i in range(4):
            ss.subscribe(f"p{i}")
        for num in range(8):
            ss.on_piece(num)
        loads = [ss._load(f"p{i}") for i in range(4)]
        assert max(loads) - min(loads) <= 1
        for pid in list(ss.subs):
            ss.unsubscribe(pid)
    asyncio.run(main())


def test_rotation_widens_but_never_broadcasts(superseed):
    async def main():
        ss = superseed(fanout=1, rotate_interval_s=0.01)
        for i in range(8):
            ss.subscribe(f"p{i}")
        ss.on_piece(0)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 5.0
        while (len(ss.assigned[0]) < 2 * ss.fanout
               and loop.time() < deadline):
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.1)   # more ticks must not widen further
        assert len(ss.assigned[0]) == 2 * ss.fanout
        for pid in list(ss.subs):
            ss.unsubscribe(pid)
        assert ss._rotor is None
    asyncio.run(main())


def test_unsubscribe_returns_assignments(superseed):
    async def main():
        ss = superseed(fanout=1, rotate_interval_s=3600)
        ss.subscribe("gone")
        ss.on_piece(0)
        assert ss.assigned[0] == {"gone"}
        ss.unsubscribe("gone")
        assert ss.assigned[0] == set()
        q = ss.subscribe("fresh")
        assert q.get_nowait() == 0
        ss.unsubscribe("fresh")
    asyncio.run(main())


def test_reveal_budget_paces_starving_child(superseed):
    async def main():
        ss = superseed(fanout=1, rotate_interval_s=3600)
        other = ss.subscribe("other")
        q = ss.subscribe("starved")
        for num in range(30):
            ss.on_piece(num)
        base = q.qsize()
        for _ in range(50):
            ss.reveal_to("starved", n=4)
        revealed = q.qsize() - base
        assert 0 < revealed <= ss.REVEAL_BURST + 1
        assert revealed < 30 - base
        assert other is not None
        ss.unsubscribe("starved")
        ss.unsubscribe("other")
    asyncio.run(main())


def test_reveal_prefers_least_assigned(superseed):
    async def main():
        ss = superseed(fanout=1, rotate_interval_s=3600)
        q1 = ss.subscribe("a")
        ss.on_piece(0)
        ss.on_piece(1)
        q2 = ss.subscribe("b")
        ss.reveal_to("b", n=1)
        first = q2.get_nowait()
        ss.reveal_to("b", n=1)
        second = q2.get_nowait()
        assert {first, second} == {0, 1}
        assert q1 is not None
        ss.unsubscribe("a")
        ss.unsubscribe("b")
    asyncio.run(main())


def test_an_old_streams_cleanup_keeps_the_reconnected_subscription(
        superseed):
    async def main():
        ss = superseed(fanout=1, rotate_interval_s=3600)
        old = ss.subscribe("child")
        new = ss.subscribe("child")          # reconnected on a new stream
        ss.unsubscribe("child", old)         # the old stream's cleanup
        assert ss.subs.get("child") is new
        ss.on_piece(3)
        assert _drain(new) == [3] and _drain(old) == []
        ss.unsubscribe("child", new)
        assert "child" not in ss.subs and ss._rotor is None
    asyncio.run(main())


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


def _scripted_reveals(cls, seed: int) -> list:
    """A seeded script of subscribes, landings, starvation pings, rotation
    ticks and departures; every reveal in order, as (step, child,
    piece)."""
    rng = random.Random(seed)
    out = []

    async def main():
        ss = cls(fanout=2, rotate_interval_s=3600)
        queues: dict = {}
        for step in range(400):
            op = rng.random()
            live = sorted(queues)
            if op < 0.15 or not live:
                pid = f"c{rng.randrange(8)}"
                queues[pid] = ss.subscribe(pid,
                                           slice_name=f"s{rng.randrange(3)}")
            elif op < 0.45:
                ss.on_piece(rng.randrange(64))
            elif op < 0.7:
                ss.reveal_to(rng.choice(live), n=rng.randrange(1, 4))
            elif op < 0.8:
                # one rotation tick, as _rotate runs it
                for num in sorted(ss.known):
                    have = len(ss.assigned.get(num, ()))
                    if have < 2 * ss.fanout:
                        ss._offer(num, target=have + 1)
            elif op < 0.9:
                pid = rng.choice(live)
                ss.unsubscribe(pid, queues.pop(pid))
            CLOCK.now += rng.uniform(0.0, 1.5)
            for pid in sorted(queues):
                out.extend((step, pid, n) for n in _drain(queues[pid]))
        for pid in list(ss.subs):
            ss.unsubscribe(pid)
    asyncio.run(main())
    return out


CLOCK = _Clock()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_seeded_script_reveals_the_same_pieces_in_both_packages(
        monkeypatch, seed):
    for mod in (ref_rate, port_rate):
        monkeypatch.setattr(mod, "time", CLOCK)
    CLOCK.now = 1000.0
    want = _scripted_reveals(ref_rpcserver._SuperSeed, seed)
    CLOCK.now = 1000.0
    got = _scripted_reveals(port_rpcserver._SuperSeed, seed)
    assert got == want
    assert len(want) > 100


# ---------------------------------------------------------------- streams

def _held_task(tmp_path, pieces: int = 5, size: int = 1000):
    """A storage manager holding one finished task of ``pieces``
    pieces."""
    mgr = StorageManager(StorageConfig(data_dir=str(tmp_path / "data")))
    md = TaskMetadata(task_id="t" * 64, piece_size=size,
                      content_length=pieces * size,
                      total_piece_count=pieces)
    ts = mgr.register_task(md)
    for n in range(pieces):
        ts.write_piece(n, n * size, bytes([n]) * size)
    ts.mark_done(success=True)
    return mgr


def test_a_seed_stream_opens_with_geometry_and_pings_reach_reveal_to(
        tmp_path, monkeypatch):
    """Through the RPC transport: the seed's first packet carries the
    geometry and no piece; landed pieces follow with no ``relay_nums``;
    each follow-up request is a ``reveal_to`` for its child; the policy
    is evicted when the child leaves."""
    pings = []
    real = port_rpcserver._SuperSeed.reveal_to

    def reveal_to(self, peer_id, n=2):
        pings.append(peer_id)
        return real(self, peer_id, n)

    monkeypatch.setattr(port_rpcserver._SuperSeed, "reveal_to", reveal_to)
    mgr = _held_task(tmp_path)
    ptm = types.SimpleNamespace(storage_mgr=mgr, is_seed=True,
                                conductor=lambda tid: None)
    svc = port_rpcserver.DaemonService(ptm, upload_addr="127.0.0.1:1")

    async def main():
        from dragonfly2_tpu_torch.rpc.server import RPCServer
        server = RPCServer("127.0.0.1:0")
        for sdef in port_rpcserver.build_service(svc):
            server.register(sdef)
        await server.start()
        ch = Channel(f"127.0.0.1:{server.port}")
        try:
            stream = ServiceClient(ch, "df.daemon.Daemon").stream_stream(
                "SyncPieceTasks")
            req = port_msg.PieceTaskRequest(task_id="t" * 64,
                                            src_peer_id="child",
                                            dst_peer_id="seed", limit=1 << 20)
            await stream.write(req)
            first = await stream.read()
            assert first.piece_infos == [] and first.relay_nums is None
            assert (first.content_length, first.total_piece_count,
                    first.piece_size) == (5000, 5, 1000)
            got = []
            while len(got) < 5:
                packet = await stream.read()
                assert packet.relay_nums is None
                got += [p.piece_num for p in packet.piece_infos]
            assert sorted(got) == list(range(5))
            for _ in range(3):
                await stream.write(req)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 5
            while len(pings) < 3 and loop.time() < deadline:
                await asyncio.sleep(0.01)
            assert pings == ["child"] * 3
            assert set(svc._superseed) == {"t" * 64}
            stream.cancel()
            while svc._superseed and loop.time() < deadline:
                await asyncio.sleep(0.01)
            assert svc._superseed == {} and svc._superseed_feeders == {}
        finally:
            await ch.close()
            await server.stop(0.5)
    asyncio.run(asyncio.wait_for(main(), 20))


# ---------------------------------------------------------------- pods

def _origin(tmp_path):
    data = np.random.default_rng(21).integers(
        0, 256, 6 * 4 * MiB + 777, dtype=np.uint8).tobytes()
    path = tmp_path / "origin.bin"
    path.write_bytes(data)
    return f"file://{path}", data


def _record_packets(monkeypatch, engine_mod, seen: list) -> None:
    real = engine_mod._Synchronizer._on_packet

    async def on_packet(self, packet):
        seen.append((self.parent.peer_id, packet.relay_nums,
                     [p.piece_num for p in packet.piece_infos or []]))
        return await real(self, packet)

    monkeypatch.setattr(engine_mod._Synchronizer, "_on_packet", on_packet)


def _ration(monkeypatch, mod) -> None:
    """Fanout 1, no rotation."""
    monkeypatch.setattr(mod._SuperSeed.__init__, "__kwdefaults__",
                        {"fanout": 1, "rotate_interval_s": 3600.0})


async def _port_pod(tmp_path, url: str) -> tuple[dict, list]:
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
        for n in ("a", "b", "c")]
    try:
        for d in leechers:
            await d.start()
        outs = await asyncio.gather(*(_pull(d, port_msg, url, tmp_path, n)
                                      for d, n in zip(leechers, "abc")))
        seed_peer = next(iter(seed.ptm._conductors.values())).peer_id
        return dict(zip("abc", outs)), [seed_peer]
    finally:
        for d in leechers:
            await d.stop()
        await sched.stop()
        await seed.stop()


async def _ref_pod(tmp_path, url: str) -> tuple[dict, list]:
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
    for n in "abc":
        c = cfg(n)
        c.scheduler = ref_dconfig.SchedulerConfig(
            addresses=[sched.address], schedule_timeout_s=20.0)
        leechers.append(RefDaemon(c))
    try:
        for d in leechers:
            await d.start()
        outs = await asyncio.gather(*(_pull(d, ref_msg, url, tmp_path, n)
                                      for d, n in zip(leechers, "abc")))
        seed_peer = next(iter(seed.ptm._conductors.values())).peer_id
        return dict(zip("abc", outs)), [seed_peer]
    finally:
        for d in leechers:
            await d.stop()
        await sched.stop()
        await seed.stop()


async def _pull(daemon, msg, url: str, tmp_path, name: str) -> bytes:
    out = tmp_path / f"out-{msg.__name__.split('.')[0]}-{name}.bin"
    req = msg.DownloadRequest(url=url, output=str(out),
                              disable_back_source=True, timeout_s=POD_LIMIT_S)
    async for _ in daemon.ptm.start_file_task(req):
        pass
    return out.read_bytes()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_a_rationing_seed_feeds_three_leechers_without_relay_nums(
        tmp_path, monkeypatch, pkg):
    url, data = _origin(tmp_path)
    seen: list = []
    if pkg == "port":
        _record_packets(monkeypatch, port_engine, seen)
        _ration(monkeypatch, port_rpcserver)
        counting = _CountingFileClient()
        previous = port_source.client_for("file://")
        port_source.register_client("file", counting)
        try:
            outs, seeds = asyncio.run(asyncio.wait_for(
                _port_pod(tmp_path, url), POD_LIMIT_S))
        finally:
            port_source.register_client("file", previous)
        assert counting.bytes_read == len(data)      # origin read once
    else:
        _record_packets(monkeypatch, ref_engine, seen)
        _ration(monkeypatch, ref_rpcserver)
        outs, seeds = asyncio.run(asyncio.wait_for(
            _ref_pod(tmp_path, url), POD_LIMIT_S))
    for name, got in outs.items():
        assert got == data, name
    from_seed = [(nums, pieces) for peer, nums, pieces in seen
                 if peer in seeds]
    assert from_seed, "no packet from the seed"
    assert from_seed[0] == (None, [])
    assert all(nums is None for nums, _ in from_seed)
    assert any(pieces for _, pieces in from_seed)


# ---------------------------------------------------------------- swap hold

def test_a_seed_only_swap_piece_waits_for_the_seeds_reveal_to_its_owner():
    """A rationing seed may tell the replica that owns a swap-class piece
    two rotation ticks after it told this one, so the hold on a piece only
    seeds hold is the swap hold plus that reveal time; the owner's
    announcement inside it takes the piece."""
    from dragonfly2_tpu_torch.daemon import piece_dispatcher as pd
    assert pd.SUPERSEED_REVEAL_S == 2 * port_rpcserver._SuperSeed(
        ).rotate_interval_s

    def info(num):
        return port_msg.PieceInfo(piece_num=num, range_start=num * 4,
                                  range_size=4)

    async def main():
        d = pd.PieceDispatcher()
        d.set_shard_state({0, 1}, {0, 1})
        d.swap_hold_s = 0.2
        await d.add_parent("seed", "s:1", is_seed=True)
        await d.announce("seed", [info(0), info(1)])
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        # past the plain hold, inside the reveal time: nothing to take
        assert await d.get(timeout=0.2 + pd.SUPERSEED_REVEAL_S / 2) is None
        await d.add_parent("mate", "m:1")
        await d.announce("mate", [info(1)])
        got = await d.get(timeout=0.3)
        assert got.parent.peer_id == "mate" and got.piece.piece_num == 1
        await d.report(got, ok=True)
        got = await d.get(timeout=2.0)
        assert got.parent.peer_id == "seed" and got.piece.piece_num == 0
        assert loop.time() - t0 >= 0.2 + pd.SUPERSEED_REVEAL_S - 0.05
        await d.report(got, ok=True)
        await d.close()
    asyncio.run(asyncio.wait_for(main(), 10))
