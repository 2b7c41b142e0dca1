"""The PEX gossip plane and the swarm index, on the port and against the
reference.

* The reference's ``tests/test_pex.py`` cases, run through the port:
  ``TestSwarmIndex``, ``TestDigestCodec``, ``TestGossipRound``,
  ``TestProbeDemoted``, ``TestLadderHooks``, ``TestPexRungE2E`` and
  ``TestPexPropagationE2E``, plus ``TestSwarmWatermarkFreshness`` from
  ``tests/test_relay.py``. Two gossipers exchange over the port's upload
  server (the reference's use aiohttp); the ``dfdiag`` verdict lines of
  the rung e2e wait for the port's dfdiag.
* Parity: one body seals to the same bytes in both packages; a torn,
  re-versioned or ill-typed envelope is refused by both under the same
  ``reason`` label; the same storage state, relay watermark and
  membership give equal ``build_digest`` and ``build_summary`` dicts; on a
  seeded 64-holder index with ICI coordinates, ``parents_for`` order,
  ``_targets`` picks (same ``rng`` seed) and ``_covers_task`` are the
  reference's.
* Interop: a port daemon and a reference daemon exchange digests in
  both directions over their upload ports, and each then lists the
  other's task in its swarm index.

Every test that starts servers runs under ``asyncio.wait_for``.
"""

import asyncio
import hashlib
import json
import os
import random
import time
import types

import numpy as np
import pytest

import dragonfly2_tpu.daemon.pex as ref_pex
import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.common.metrics import REGISTRY as REF_REGISTRY
from dragonfly2_tpu.daemon import config as ref_dconfig
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.daemon.swarm_index import SwarmEntry as RefSwarmEntry
from dragonfly2_tpu.daemon.swarm_index import SwarmIndex as RefSwarmIndex
from dragonfly2_tpu.storage import metadata as ref_metadata
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.common import faultgate
from dragonfly2_tpu_torch.common.metrics import REGISTRY
from dragonfly2_tpu_torch.daemon import pex as pexmod
from dragonfly2_tpu_torch.daemon.config import (DaemonConfig, StorageSection)
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.daemon.flight_recorder import TaskFlight
from dragonfly2_tpu_torch.daemon.pex import PexGossiper, seal, unseal
from dragonfly2_tpu_torch.daemon.scheduler_session import (PeerSession,
                                                           SchedulerConnector)
from dragonfly2_tpu_torch.daemon.swarm_index import SwarmEntry, SwarmIndex
from dragonfly2_tpu_torch.daemon.upload_server import UploadServer
from dragonfly2_tpu_torch.idl.messages import (DownloadRequest, Host,
                                               PeerAddr, PieceInfo,
                                               PieceResult, TopologyInfo)
from dragonfly2_tpu_torch.storage.metadata import PieceMeta, TaskMetadata

LIMIT_S = 20.0
E2E_LIMIT_S = 40.0


@pytest.fixture(autouse=True)
def _disarm():
    faultgate.reset()
    yield
    faultgate.reset()


def run(coro, limit: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit))


def entry(host_id: str, *, done=True, pieces=None, slice_name="", ici=None,
          total=3, length=12 << 20, rpc_port=1, download_port=2,
          cls=SwarmEntry, topo_cls=TopologyInfo):
    return cls(
        host_id=host_id, ip="10.0.0.1", rpc_port=rpc_port,
        download_port=download_port,
        topology=topo_cls(slice_name=slice_name, ici_coords=ici),
        pieces=pieces, total_pieces=total, content_length=length,
        piece_size=4 << 20, done=done)


def fake_storage(*task_mds):
    return types.SimpleNamespace(
        tasks=lambda: [types.SimpleNamespace(md=md) for md in task_mds])


def completed_md(task_id: str, *, pieces=3, piece_size=4 << 20,
                 md_cls=TaskMetadata, piece_cls=PieceMeta):
    md = md_cls(task_id=task_id, content_length=pieces * piece_size,
                total_piece_count=pieces, piece_size=piece_size,
                done=True, success=True)
    for n in range(pieces):
        md.pieces[n] = piece_cls(num=n, start=n * piece_size,
                                 size=piece_size)
    return md


def self_host(**kw):
    return lambda: Host(id="self", ip="9.9.9.9", download_port=1, **kw)


async def _gossiper_pair(storage_a, storage_b):
    """Two gossipers, B's routes on a port upload server; A knows B by
    bootstrap. Returns (a, b, b_port, cleanup)."""
    ports = {"b": 0}

    def host(name, dport):
        return lambda: Host(id=f"{name}-host", ip="127.0.0.1", port=7000,
                            download_port=dport(),
                            topology=TopologyInfo(slice_name=f"sl-{name}"))

    b = PexGossiper(storage_mgr=storage_b,
                    host_info=host("b", lambda: ports["b"]))
    server = UploadServer(storage_b, host="127.0.0.1", pex=b)
    await server.start()
    ports["b"] = server.port
    a = PexGossiper(storage_mgr=storage_a,
                    host_info=host("a", lambda: 65001),
                    bootstrap=[f"127.0.0.1:{ports['b']}"])

    async def cleanup():
        await a.stop()
        await b.stop()
        await server.stop()

    return a, b, ports["b"], cleanup


async def http_get(port: int, path: str) -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                     f"Connection: close\r\n\r\n".encode())
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body


# ----------------------------------------------------------------------
# the reference's cases through the port
# ----------------------------------------------------------------------

class TestSwarmIndex:
    def test_ttl_expiry_and_purge(self):
        idx = SwarmIndex(ttl_s=10.0)
        idx.update("t1", entry("hA"), now=100.0)
        assert len(idx.parents_for("t1", now=105.0)) == 1
        assert idx.parents_for("t1", now=111.0) == []
        idx.purge(now=111.0)
        assert idx.tasks() == []

    def test_parent_ordering_done_then_locality(self):
        me = TopologyInfo(slice_name="s0", ici_coords=(0, 0))
        idx = SwarmIndex(ttl_s=60.0)
        idx.update("t", entry("far-done", slice_name="s1"), now=0.0)
        idx.update("t", entry("near-done", slice_name="s0", ici=(0, 1)),
                   now=0.0)
        idx.update("t", entry("near-partial", done=False, pieces={0, 1},
                              slice_name="s0", ici=(0, 1)), now=0.0)
        idx.update("t", entry("nearest-done", slice_name="s0", ici=(0, 0)),
                   now=0.0)
        order = [e.host_id for e in
                 idx.parents_for("t", self_topology=me, now=1.0)]
        assert order == ["nearest-done", "near-done", "far-done",
                         "near-partial"]

    def test_exclude_self_and_forget_host(self):
        idx = SwarmIndex(ttl_s=60.0)
        idx.update("t", entry("me"), now=0.0)
        idx.update("t", entry("other"), now=0.0)
        assert [e.host_id for e in
                idx.parents_for("t", exclude_host="me", now=1.0)] == ["other"]
        idx.forget_host("other")
        idx.forget_host("me")
        assert idx.tasks() == []

    def test_caps_evict_soonest_expiring(self):
        idx = SwarmIndex(ttl_s=60.0, max_tasks=2, max_holders_per_task=2)
        idx.update("t1", entry("a"), now=0.0)
        idx.update("t2", entry("a"), now=10.0)
        idx.update("t3", entry("a"), now=20.0)       # evicts t1
        assert set(idx.tasks()) == {"t2", "t3"}
        idx.update("t2", entry("b"), now=30.0)
        idx.update("t2", entry("c"), now=40.0)       # evicts t2's 'a'
        assert {e.host_id for e in idx.parents_for("t2", now=41.0)} == \
            {"b", "c"}


class TestDigestCodec:
    def test_roundtrip(self):
        body = {"v": pexmod.DIGEST_VERSION, "origin": {"host_id": "h"},
                "tasks": []}
        assert unseal(seal(body)) == body

    def test_corrupt_envelope_rejected_and_counted(self):
        rejected = REGISTRY.counter("df_pex_rejected_total", "x", ("reason",))
        before = rejected.value("checksum")
        raw = bytearray(seal({"v": pexmod.DIGEST_VERSION, "tasks": []}))
        raw[0] ^= 0xFF
        assert unseal(bytes(raw)) is None
        assert rejected.value("checksum") == before + 1

    def test_version_mismatch_rejected(self):
        rejected = REGISTRY.counter("df_pex_rejected_total", "x", ("reason",))
        before = rejected.value("version")
        assert unseal(seal({"v": 999})) is None
        assert rejected.value("version") == before + 1


class TestGossipRound:
    def test_push_pull_merges_both_ways(self):
        async def go():
            md = completed_md("t" * 64)
            a, b, b_port, cleanup = await _gossiper_pair(
                fake_storage(), fake_storage(md))
            try:
                assert await a.round() == 1
                holders = a.index.parents_for(md.task_id)
                assert len(holders) == 1
                e = holders[0]
                assert e.done and e.rpc_port == 7000
                assert e.download_port == b_port
                assert e.content_length == md.content_length
                assert e.topology.slice_name == "sl-b"
                assert any(p.host_id == "a-host" for p in b.peers.values())
            finally:
                await cleanup()

        run(go())

    def test_partial_task_carries_piece_set(self):
        async def go():
            md = completed_md("u" * 64, pieces=4)
            md.done = md.success = False
            del md.pieces[3]
            a, b, _port, cleanup = await _gossiper_pair(
                fake_storage(), fake_storage(md))
            try:
                await a.round()
                e = a.index.parents_for(md.task_id)[0]
                assert not e.done
                assert e.pieces == {0, 1, 2}
            finally:
                await cleanup()

        run(go())

    def test_gossip_drop_fault_counted_then_recovers(self):
        sent = REGISTRY.counter("df_pex_digests_sent_total", "x", ("result",))

        async def go():
            md = completed_md("v" * 64)
            a, b, _port, cleanup = await _gossiper_pair(
                fake_storage(), fake_storage(md))
            try:
                script = faultgate.arm("pex.gossip", "fail", n=1)
                before_err = sent.value("error")
                assert await a.round() == 0
                assert script.fired == 1
                assert sent.value("error") == before_err + 1
                assert a.index.parents_for(md.task_id) == []
                assert await a.round() == 1
                assert len(a.index.parents_for(md.task_id)) == 1
            finally:
                await cleanup()

        run(go())

    def test_gossip_corruption_rejected_by_receiver(self):
        rejected = REGISTRY.counter("df_pex_rejected_total", "x", ("reason",))

        async def go():
            md_a = completed_md("w" * 64)
            a, b, _port, cleanup = await _gossiper_pair(
                fake_storage(md_a), fake_storage())
            try:
                faultgate.arm("pex.gossip", "corrupt", n=1)
                before = rejected.value("checksum")
                # the receiver answers 400 on the same keep-alive
                # connection, which the next round reuses
                assert await a.round() == 0
                assert rejected.value("checksum") == before + 1
                assert b.index.parents_for(md_a.task_id) == []
                assert await a.round() == 1
                assert len(b.index.parents_for(md_a.task_id)) == 1
            finally:
                await cleanup()

        run(go())

    def test_hearsay_never_refreshes_liveness(self):
        g = PexGossiper(storage_mgr=fake_storage(), host_info=self_host())
        g.observe_peer(host_id="p", ip="10.0.0.2", download_port=5,
                       direct=True)
        peer = g.peers["10.0.0.2:5"]
        peer.fails = 2
        g.observe_peer(host_id="p", ip="10.0.0.2", download_port=5)
        assert peer.fails == 2
        g.observe_peer(host_id="p", ip="10.0.0.2", download_port=5,
                       direct=True)
        assert peer.fails == 0

    def test_pex_minted_parents_do_not_self_bless(self):
        g = PexGossiper(storage_mgr=fake_storage(), host_info=self_host())
        g.observe_parent(PeerAddr(peer_id="pex-ghost", ip="10.0.0.7",
                                  rpc_port=1, download_port=2))
        assert not g.peers
        g.observe_parent(PeerAddr(peer_id="sched-assigned", ip="10.0.0.7",
                                  rpc_port=1, download_port=2))
        assert "10.0.0.7:2" in g.peers

    def test_evicted_peer_cooldown_blocks_hearsay_recreation(self):
        async def go():
            a, _b, _port, cleanup = await _gossiper_pair(
                fake_storage(), fake_storage())
            try:
                a._bootstrap = ["127.0.0.1:9"]
                for _ in range(pexmod.PEER_FAIL_LIMIT):
                    await a.round()
                assert "127.0.0.1:9" not in a.peers
                await a.round()
                assert "127.0.0.1:9" not in a.peers
                a.observe_peer(host_id="back", ip="127.0.0.1",
                               download_port=9, direct=True)
                assert "127.0.0.1:9" in a.peers
            finally:
                await cleanup()

        run(go())

    def test_well_sealed_but_ill_typed_digest_rejected(self):
        rejected = REGISTRY.counter("df_pex_rejected_total", "x", ("reason",))
        g = PexGossiper(storage_mgr=fake_storage(), host_info=self_host())
        raw = seal({"v": pexmod.DIGEST_VERSION,
                    "origin": {"host_id": "evil", "ip": "10.0.0.3",
                               "rpc_port": "abc", "download_port": 4},
                    "peers": [], "tasks": []})
        before = rejected.value("parse")
        assert not g.ingest(raw)
        assert rejected.value("parse") == before + 1
        assert not g.peers

    def test_peer_dropped_after_fail_limit(self):
        async def go():
            a, _b, _port, cleanup = await _gossiper_pair(
                fake_storage(), fake_storage())
            try:
                a._bootstrap = []
                a.observe_peer(host_id="dead", ip="127.0.0.1",
                               download_port=9)
                assert len(a.peers) == 1
                for _ in range(pexmod.PEER_FAIL_LIMIT):
                    await a.round()
                assert not a.peers
            finally:
                await cleanup()

        run(go())


class TestProbeDemoted:
    def test_probes_run_concurrently(self, monkeypatch):
        async def wedged(_host, _port):
            await asyncio.sleep(3600.0)

        monkeypatch.setattr(asyncio, "open_connection", wedged)

        async def go():
            addrs = ["10.255.255.1:9", "10.255.255.2:9", "10.255.255.3:9"]
            conn = SchedulerConnector(addrs, Host(id="h"), demote_s=3600.0)
            for a in addrs:
                conn.demote(a)
            t0 = time.monotonic()
            assert await conn.probe_demoted(timeout_s=0.5) == []
            assert time.monotonic() - t0 < 1.2
            assert conn.demoted() == set(addrs)
            await conn.close()

        run(go())

    def test_probe_revives_listening_scheduler_only(self):
        async def go():
            server = await asyncio.start_server(
                lambda r, w: w.close(), "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            live = f"127.0.0.1:{port}"
            dead = "127.0.0.1:9"
            conn = SchedulerConnector([live, dead], Host(id="h"),
                                      demote_s=3600.0)
            conn.demote(live)
            conn.demote(dead)
            assert conn.demoted() == {live, dead}
            try:
                assert await conn.probe_demoted(timeout_s=1.0) == [live]
                assert conn.demoted() == {dead}
            finally:
                server.close()
                await server.wait_closed()
                await conn.close()

        run(go())


class TestLadderHooks:
    def _gossiper_with_holder(self, task_id):
        g = PexGossiper(
            storage_mgr=fake_storage(),
            host_info=lambda: Host(id="self", ip="127.0.0.1", port=1,
                                   download_port=2))
        g.index.update(task_id, entry("holder", rpc_port=7, download_port=8))
        return g

    def test_prime_enqueues_advisory_packet(self):
        task_id = "x" * 64
        g = self._gossiper_with_holder(task_id)
        conductor = types.SimpleNamespace(task_id=task_id, peer_id="p",
                                          flight=None)
        session = types.SimpleNamespace(packets=asyncio.Queue())
        g.prime(conductor, session)
        packet = session.packets.get_nowait()
        assert packet.advisory
        assert packet.candidate_peers[0].download_port == 8
        g2 = PexGossiper(storage_mgr=fake_storage(),
                         host_info=lambda: Host(id="s", ip="1.2.3.4"))
        g2.prime(conductor, session)
        assert session.packets.empty()

    def test_try_pull_declines_without_holders_or_engine(self):
        task_id = "y" * 64
        conductor = types.SimpleNamespace(task_id=task_id, peer_id="p",
                                          flight=None)

        async def go():
            g = self._gossiper_with_holder(task_id)
            assert not await g.try_pull(conductor)
            g2 = PexGossiper(storage_mgr=fake_storage(),
                             host_info=lambda: Host(id="s", ip="1.2.3.4"))
            g2.engine_factory = lambda: None
            assert not await g2.try_pull(conductor)

        run(go())

    def test_try_pull_coverage_gate(self):
        task_id = "w" * 64
        pulls = []

        class FakeEngine:
            async def pull(self, cond, session):
                pulls.append(session)
                return True

        def gossiper():
            g = PexGossiper(
                storage_mgr=fake_storage(),
                host_info=lambda: Host(id="self", ip="127.0.0.1", port=1,
                                       download_port=2))
            g.engine_factory = FakeEngine
            return g

        def conductor(ready=()):
            return types.SimpleNamespace(
                task_id=task_id, peer_id="p", flight=None, ready=set(ready),
                log=types.SimpleNamespace(info=lambda *a, **k: None))

        async def go():
            g = gossiper()
            g.index.update(task_id, entry("h1", done=False, pieces={0, 1}))
            assert not await g.try_pull(conductor())
            assert not pulls
            g.index.update(task_id, entry("h2", done=False, pieces={2}))
            assert await g.try_pull(conductor())
            assert len(pulls) == 1
            g2 = gossiper()
            g2.index.update(task_id, entry("h3", done=False, pieces={1, 2}))
            assert await g2.try_pull(conductor(ready={0}))
            g3 = gossiper()
            g3.index.update(task_id, entry("h4", done=False, pieces={0},
                                           total=-1))
            assert not await g3.try_pull(conductor())
            g4 = gossiper()
            g4.index.update(task_id, entry("h5", done=True))
            assert await g4.try_pull(conductor())

        run(go())

    def test_pex_session_is_not_rescuable(self):
        assert pexmod._PexSession.rescuable is False
        assert getattr(PeerSession, "rescuable", True) is True

    def test_try_pull_journals_pex_rung_and_counts_hits(self):
        task_id = "z" * 64
        flight = TaskFlight(task_id, "p")
        conductor = types.SimpleNamespace(
            task_id=task_id, peer_id="p", flight=flight,
            log=types.SimpleNamespace(info=lambda *a, **k: None))
        hits = REGISTRY.counter("df_pex_parent_hits_total", "x")

        class FakeEngine:
            async def pull(self, cond, session):
                await session.report_piece(PieceResult(
                    task_id=task_id, src_peer_id="p",
                    dst_peer_id="pex-holder", success=True,
                    piece_info=PieceInfo(piece_num=0)))
                return True

        async def go():
            g = self._gossiper_with_holder(task_id)
            g.engine_factory = FakeEngine
            before = hits.value()
            assert await g.try_pull(conductor)
            assert hits.value() == before + 1
            assert flight.summarize()["served_rung"] == "pex"

        run(go())


class TestSwarmWatermarkFreshness:
    def _entry(self, pieces, relay, host="h1"):
        return SwarmEntry(host_id=host, ip="10.0.0.9", rpc_port=1,
                          download_port=2, pieces=set(pieces),
                          relay_pieces=set(relay) or None, total_pieces=4)

    def test_update_tracks_watermark_growth(self):
        idx = SwarmIndex(progress_ttl_s=10.0)
        idx.update("t", self._entry([0], [1]), now=100.0)
        assert idx.parents_for("t", now=101.0)[0].progress_at == 100.0
        idx.update("t", self._entry([0], [1]), now=150.0)
        assert idx.parents_for("t", now=151.0)[0].progress_at == 100.0
        idx.update("t", self._entry([0, 1], [2]), now=160.0)
        assert idx.parents_for("t", now=161.0)[0].progress_at == 160.0

    def test_coverage_gate_ignores_stale_watermark(self):
        gossiper = PexGossiper(storage_mgr=None, host_info=lambda: None,
                               index=SwarmIndex(progress_ttl_s=10.0))

        class C:
            ready = set()
        now = time.monotonic()
        gossiper.index.update("t", self._entry([0, 1], [2, 3]), now=now)
        entries = gossiper.index.parents_for("t", now=now + 1)
        assert gossiper._covers_task(entries, C()) is True
        gossiper.index.update("t", self._entry([0, 1], [2, 3]), now=now)
        entries = gossiper.index.parents_for("t", now=now + 1)
        entries[0].progress_at = now - 20.0     # 20 s of no growth
        assert gossiper._covers_task(entries, C()) is False
        done = SwarmEntry(host_id="h2", ip="10.0.0.8", rpc_port=1,
                          download_port=2, pieces=None, done=True)
        gossiper.index.update("t", done, now=now)
        entries = gossiper.index.parents_for("t", now=now + 1)
        assert gossiper._covers_task(entries, C()) is True


# ----------------------------------------------------------------------
# daemons on the CPU
# ----------------------------------------------------------------------

def daemon_cfg(tmp_path, name: str, **kw) -> DaemonConfig:
    return DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                        listen_ip="127.0.0.1", host_ip="127.0.0.1",
                        device="cpu",
                        storage=StorageSection(gc_interval_s=3600), **kw)


async def seed_daemon_with(tmp_path, data: bytes, name: str = "seed"):
    """A port daemon that back-sources one file:// origin; returns
    (daemon, origin path, url, task_id)."""
    path = tmp_path / f"{name}-w.bin"
    path.write_bytes(data)
    url = f"file://{path}"
    daemon = Daemon(daemon_cfg(tmp_path, name))
    await daemon.start()
    task_id = None
    async for resp in daemon.ptm.start_file_task(
            DownloadRequest(url=url, timeout_s=30.0)):
        task_id = resp.task_id or task_id
    return daemon, path, url, task_id


def seeded(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


class TestPexRungE2E:
    def test_all_scheds_down_served_p2p_via_pex(self, tmp_path):
        """Every scheduler faulted dead and the origin gone: the task
        completes P2P on the pex rung, with zero origin bytes."""
        hits = REGISTRY.counter("df_pex_parent_hits_total", "x")

        async def go():
            data = seeded((9 << 20) + 333, 1)       # 3 pieces
            seed, origin, url, task_id = await seed_daemon_with(tmp_path,
                                                                data)
            origin.unlink()
            cfg = daemon_cfg(tmp_path, "leech", scheduler=DaemonSched(
                addresses=["127.0.0.1:9", "127.0.0.1:10"],
                register_timeout_s=2.0, schedule_timeout_s=5.0))
            cfg.probe_enabled = False
            cfg.pex.bootstrap = [f"127.0.0.1:{seed.upload_server.port}"]
            cfg.pex.interval_s = 3600.0
            leech = Daemon(cfg)
            await leech.start()
            faultgate.arm("sched.register", "fail", n=-1)
            try:
                assert await leech.pex.round() == 1
                assert len(leech.pex.index.parents_for(task_id)) == 1
                before = hits.value()
                out = tmp_path / "out.bin"
                async for _ in leech.ptm.start_file_task(DownloadRequest(
                        url=url, output=str(out), timeout_s=30.0)):
                    pass
                assert out.read_bytes() == data
                conductor = leech.ptm.conductor(task_id)
                assert conductor.state == conductor.SUCCESS
                assert conductor.traffic_source == 0
                assert conductor.traffic_p2p == len(data)
                assert hits.value() > before
                summary = leech.flight_recorder.get(task_id).summarize()
                assert summary["served_rung"] == "pex"
                assert summary["rungs"] == ["pex"]
                status, body = await http_get(leech.upload_server.port,
                                              "/debug/pex")
                snap = json.loads(body)
                assert status == 200
                assert task_id in snap["swarm"]["tasks"]
                assert snap["peers"]
            finally:
                await leech.stop()
                await seed.stop()

        run(go(), E2E_LIMIT_S)

    def test_sched_verdict_back_source_skips_pex(self, tmp_path):
        """A NeedBackSource verdict goes to origin even when gossip knows
        a holder: the rung replaces only an absent control plane."""
        from dragonfly2_tpu_torch.common import ids
        from dragonfly2_tpu_torch.common.errors import Code, DFError

        class VerdictScheduler:
            async def register(self, conductor):
                raise DFError(Code.SCHED_NEED_BACK_SOURCE, "small task")

        async def go():
            data = seeded(300_000, 2)
            path = tmp_path / "f.bin"
            path.write_bytes(data)
            url = f"file://{path}"
            daemon = Daemon(daemon_cfg(tmp_path, "verdict"))
            await daemon.start()
            daemon.ptm.scheduler = VerdictScheduler()
            task_id = ids.task_id(url)
            daemon.pex.index.update(task_id, entry("bogus", rpc_port=9,
                                                   download_port=9))
            try:
                out = tmp_path / "o.bin"
                async for _ in daemon.ptm.start_file_task(DownloadRequest(
                        url=url, output=str(out), timeout_s=30.0)):
                    pass
                assert out.read_bytes() == data
                conductor = daemon.ptm.conductor(task_id)
                assert conductor.traffic_source == len(data)
                summary = daemon.flight_recorder.get(task_id).summarize()
                assert summary["served_rung"] == "back_source"
                assert "pex" not in summary["rungs"]
            finally:
                await daemon.stop()

        run(go(), E2E_LIMIT_S)


class TestPexPropagationE2E:
    def test_transitive_membership_three_daemons(self, tmp_path):
        """A -> B bootstrap, B -> C bootstrap: after two rounds A knows C
        through B's peer sample, and the third round holds C's task."""
        async def go():
            c, origin, _url, task_id = await seed_daemon_with(
                tmp_path, seeded((4 << 20) + 5, 3), name="cc")
            origin.unlink()
            b_cfg = daemon_cfg(tmp_path, "bb")
            b_cfg.pex.bootstrap = [f"127.0.0.1:{c.upload_server.port}"]
            b_cfg.pex.interval_s = 3600.0
            b = Daemon(b_cfg)
            await b.start()
            a_cfg = daemon_cfg(tmp_path, "aa")
            a_cfg.pex.bootstrap = [f"127.0.0.1:{b.upload_server.port}"]
            a_cfg.pex.interval_s = 3600.0
            a = Daemon(a_cfg)
            await a.start()
            try:
                await b.pex.round()
                await a.pex.round()
                assert any(p.host_id.startswith("cc")
                           for p in a.pex.peers.values())
                await a.pex.round()
                holders = a.pex.index.parents_for(task_id)
                assert any(e.host_id.startswith("cc") for e in holders)
            finally:
                await a.stop()
                await b.stop()
                await c.stop()

        run(go(), E2E_LIMIT_S)


# ----------------------------------------------------------------------
# parity with the reference
# ----------------------------------------------------------------------

def test_seal_bytes_equal_reference():
    body = {"v": 1, "origin": {"host_id": "h-é", "ip": "10.0.0.1",
                               "rpc_port": 7, "topology": None},
            "tasks": [{"task_id": "t" * 64, "pieces": [3, 1, 2],
                       "done": False, "total": 9, "w": 0.25}],
            "peers": []}
    assert seal(body) == ref_pex.seal(body)
    assert unseal(ref_pex.seal(body)) == ref_pex.unseal(seal(body)) == body


def _ill_typed():
    return ref_pex.seal({"v": 1, "origin": {"host_id": "x", "ip": "1.2.3.4",
                                            "rpc_port": 1,
                                            "download_port": "nope"},
                         "peers": [], "tasks": []})


@pytest.mark.parametrize("case,reason", [
    ("torn", "checksum"), ("no-newline", "checksum"), ("json", "parse"),
    ("version", "version"), ("not-a-dict", "version"),
    ("ill-typed", "parse")])
def test_bad_envelopes_rejected_under_the_same_reason(case, reason):
    good = seal({"v": 1, "tasks": []})
    raw = {"torn": good[:-3],
           "no-newline": good.replace(b"\n", b""),
           "json": hashlib.sha256(b"{x").hexdigest().encode() + b"\n{x",
           "version": seal({"v": 2, "tasks": []}),
           "not-a-dict": seal([1, 2]),
           "ill-typed": _ill_typed()}[case]
    port_c = REGISTRY.counter("df_pex_rejected_total", "x", ("reason",))
    ref_c = REF_REGISTRY.counter("df_pex_rejected_total", "x", ("reason",))
    before = (port_c.value(reason), ref_c.value(reason))
    port_g = PexGossiper(storage_mgr=fake_storage(), host_info=self_host())
    ref_g = ref_pex.PexGossiper(
        storage_mgr=fake_storage(),
        host_info=lambda: ref_msg.Host(id="self", ip="9.9.9.9",
                                       download_port=1))
    assert port_g.ingest(raw) is False
    assert ref_g.ingest(raw) is False
    assert (port_c.value(reason), ref_c.value(reason)) == \
        (before[0] + 1, before[1] + 1)
    assert not port_g.peers and not ref_g.peers


def _digest_pair(n_peers: int = 20, verdicts: tuple = (None, None)):
    """The same storage state, relay watermark, membership and rng seed
    in both packages' gossipers; ``verdicts``: each one's ledger."""
    mds = []
    for pkg in ((TaskMetadata, PieceMeta),
                (ref_metadata.TaskMetadata, ref_metadata.PieceMeta)):
        done = completed_md("d" * 64, md_cls=pkg[0], piece_cls=pkg[1])
        part = completed_md("p" * 64, pieces=6, md_cls=pkg[0],
                            piece_cls=pkg[1])
        part.done = part.success = False
        for n in (1, 4, 5):
            del part.pieces[n]
        empty = pkg[0](task_id="e" * 64, total_piece_count=2)
        mds.append((done, part, empty))
    relay = types.SimpleNamespace(inflight_infos=lambda tid: [
        types.SimpleNamespace(piece_num=n) for n in (0, 1, 4)]
        if tid == "p" * 64 else [])

    def host(msg):
        return lambda: msg.Host(
            id="me-127.0.0.1", ip="127.0.0.1", port=7001, download_port=7002,
            type=msg.HostType.SUPER_SEED,
            topology=msg.TopologyInfo(slice_name="s0", ici_coords=(1, 2),
                                      zone="z", pod="pod-a"))
    port_g = PexGossiper(storage_mgr=fake_storage(*mds[0]),
                         host_info=host(port_msg),
                         relay=relay, rng=random.Random(7),
                         verdicts=verdicts[0])
    ref_g = ref_pex.PexGossiper(storage_mgr=fake_storage(*mds[1]),
                                host_info=host(ref_msg), relay=relay,
                                rng=random.Random(7), verdicts=verdicts[1])
    for i in range(n_peers):
        for g, msg in ((port_g, None), (ref_g, ref_msg)):
            topo = (TopologyInfo if msg is None else msg.TopologyInfo)(
                slice_name=f"s{i % 2}", ici_coords=(i % 4, i // 4), pod="")
            g.observe_peer(host_id=f"h{i}", ip=f"10.0.{i}.1", rpc_port=9000,
                           download_port=9001 + i, is_seed=i == 3,
                           topology=topo, direct=True)
    return port_g, ref_g


def test_build_digest_and_summary_equal_reference():
    port_g, ref_g = _digest_pair()
    got, want = port_g.build_digest(), ref_g.build_digest()
    assert len(got["peers"]) == pexmod.PEER_SAMPLE
    assert got == want
    assert [t["task_id"][0] for t in got["tasks"]] == ["d", "p"]
    assert got["tasks"][1]["relay"] == [1, 4]
    assert port_g.build_summary() == ref_g.build_summary()
    assert port_g.envelope() == ref_g.envelope()


@pytest.mark.parametrize("selfq", [False, True])
def test_digests_carry_the_reference_verdicts(selfq):
    """The verdict hooks of the PEX plane: local shuns ride a digest as
    ``suspects`` and a self-quarantined daemon advertises no tasks, with
    ``selfq`` set, in the reference's bytes."""
    from dragonfly2_tpu.daemon import verdicts as ref_verdicts
    from dragonfly2_tpu_torch.daemon import verdicts as port_verdicts
    ledgers = []
    for mod in (port_verdicts, ref_verdicts):
        v = mod.VerdictLedger(clock=lambda: 0.0)
        for addr in ("10.0.3.1:9004", "10.0.3.1:9004", "10.0.5.1:9006"):
            v.record(addr, "corrupt")
        v.hint("10.0.7.1:9008")
        if selfq:
            v.self_quarantine("rot")
        ledgers.append(v)
    port_g, ref_g = _digest_pair(verdicts=tuple(ledgers))
    got, want = port_g.build_digest(), ref_g.build_digest()
    assert got == want
    assert got["suspects"] == ["10.0.3.1:9004"]
    assert got["origin"]["selfq"] is selfq
    assert (got["tasks"] == []) is selfq
    assert port_g.envelope() == ref_g.envelope()
    assert port_g.build_summary() == ref_g.build_summary()


def _holder_index(idx_cls, entry_cls, topo_cls, rng: np.random.Generator):
    idx = idx_cls(ttl_s=60.0, progress_ttl_s=15.0)
    for i in range(64):
        done = bool(rng.random() < 0.3)
        pieces = (None if done else
                  {int(p) for p in np.flatnonzero(rng.random(12) < 0.5)})
        relay = (None if done else
                 {int(p) for p in np.flatnonzero(rng.random(12) < 0.2)}
                 or None)
        e = entry_cls(host_id=f"h{i:02d}", ip=f"10.1.{i}.1", rpc_port=1,
                      download_port=2,
                      topology=topo_cls(slice_name=f"s{int(rng.integers(3))}",
                                        ici_coords=(int(rng.integers(4)),
                                                    int(rng.integers(4)))),
                      pieces=pieces, relay_pieces=relay, total_pieces=12,
                      content_length=12 << 20, piece_size=1 << 20,
                      done=done)
        idx.update("t", e, now=float(rng.integers(0, 30)))
    return idx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_order_targets_and_coverage_equal_reference(seed):
    me_port = TopologyInfo(slice_name="s1", ici_coords=(1, 1))
    me_ref = ref_msg.TopologyInfo(slice_name="s1", ici_coords=(1, 1))
    port_idx = _holder_index(SwarmIndex, SwarmEntry, TopologyInfo,
                             np.random.default_rng(seed))
    ref_idx = _holder_index(RefSwarmIndex, RefSwarmEntry,
                            ref_msg.TopologyInfo,
                            np.random.default_rng(seed))
    got = port_idx.parents_for("t", self_topology=me_port, now=31.0)
    want = ref_idx.parents_for("t", self_topology=me_ref, now=31.0)
    assert [e.host_id for e in got] == [e.host_id for e in want]
    assert len(got) == 64

    port_g, ref_g = _digest_pair(n_peers=40)
    port_g.fanout = ref_g.fanout = 3
    port_g.rng, ref_g.rng = random.Random(seed), random.Random(seed)
    for _ in range(5):
        assert [p.addr for p in port_g._targets()] == \
            [p.addr for p in ref_g._targets()]

    for ready in (set(), {0, 1, 2, 3}, set(range(11))):
        cond = types.SimpleNamespace(ready=ready)
        partial_port = [e for e in got if not e.done]
        partial_ref = [e for e in want if not e.done]
        for k in (1, 3, 8, len(partial_port)):
            assert port_g._covers_task(partial_port[:k], cond) == \
                ref_g._covers_task(partial_ref[:k], cond)
        assert port_g._covers_task(got, cond) == \
            ref_g._covers_task(want, cond)


# ----------------------------------------------------------------------
# interop
# ----------------------------------------------------------------------

def test_port_and_reference_daemons_gossip_both_ways(tmp_path):
    """Each daemon holds one task; one round from each side over the
    other's upload port leaves both tasks in both swarm indexes."""
    async def go():
        port_d, port_origin, _u, port_task = await seed_daemon_with(
            tmp_path, seeded((2 << 20) + 9, 4), name="portd")
        ref_path = tmp_path / "ref-w.bin"
        ref_path.write_bytes(seeded((3 << 20) + 1, 5))
        ref_cfg = ref_dconfig.DaemonConfig(
            workdir=str(tmp_path / "refd"), host_ip="127.0.0.1",
            hostname="refd",
            storage=ref_dconfig.StorageSection(gc_interval_s=3600))
        ref_cfg.pex.interval_s = 3600.0
        ref_d = RefDaemon(ref_cfg)
        await ref_d.start()
        try:
            ref_task = None
            async for resp in ref_d.ptm.start_file_task(ref_msg.DownloadRequest(
                    url=f"file://{ref_path}", timeout_s=30.0)):
                ref_task = resp.task_id or ref_task
            port_addr = f"127.0.0.1:{port_d.upload_server.port}"
            ref_addr = f"127.0.0.1:{ref_d.upload_server.port}"
            port_d.pex._bootstrap = [ref_addr]
            assert await port_d.pex.round() == 1
            # push landed at the reference, pull reply at the port
            assert port_d.pex.index.parents_for(ref_task)
            assert ref_d.pex.index.parents_for(port_task)
            ref_d.pex.index.forget_host(port_d.host_info().id)
            port_d.pex.index.forget_host(ref_d.host_info().id)
            ref_d.pex._bootstrap = [port_addr]
            assert await ref_d.pex.round() >= 1
            assert port_d.pex.index.parents_for(ref_task)
            assert ref_d.pex.index.parents_for(port_task)
            holder = port_d.pex.index.parents_for(ref_task)[0]
            assert (holder.done, holder.download_port) == \
                (True, ref_d.upload_server.port)
        finally:
            await ref_d.stop()
            await port_d.stop()

    run(go(), E2E_LIMIT_S)


# ----------------------------------------------------------------------
# the port's upload server and engine around the plane
# ----------------------------------------------------------------------

async def _raw(port: int, requests: list[bytes]) -> list[tuple[int, bytes]]:
    """Send requests on one keep-alive connection; (status, body) each."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    out = []
    try:
        for req in requests:
            writer.write(req)
            await writer.drain()
            head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
            length = int(head.lower().split("content-length:")[1]
                         .split("\r\n")[0])
            out.append((int(head.split(" ")[1]),
                        await reader.readexactly(length)))
    finally:
        writer.close()
    return out


def _post(path: str, body: bytes) -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def test_upload_server_pex_routes_on_one_connection():
    """A digest POST is read whole and answered with the receiver's own
    envelope; a bad body is 400 and the connection serves the next
    request; a wrong method is 405; a body past 1 MiB is 413 and the
    connection closes."""
    async def go():
        md = completed_md("q" * 64)
        b = PexGossiper(storage_mgr=fake_storage(md),
                        host_info=lambda: Host(id="b", ip="127.0.0.1",
                                               port=7, download_port=8))
        server = UploadServer(fake_storage(md), host="127.0.0.1", pex=b)
        await server.start()
        try:
            a_env = PexGossiper(
                storage_mgr=fake_storage(),
                host_info=lambda: Host(id="a", ip="127.0.0.1", port=5,
                                       download_port=6)).envelope()
            got = await _raw(server.port, [
                _post("/pex/digest", b"garbage"),
                _post("/pex/digest", a_env),
                b"DELETE /pex/digest HTTP/1.1\r\nHost: x\r\n\r\n",
                b"GET /pex/digest HTTP/1.1\r\nHost: x\r\n\r\n",
                _post("/pex/summary", b.summary_envelope())])
            assert [s for s, _ in got] == [400, 200, 405, 200, 200]
            assert unseal(got[1][1])["tasks"][0]["task_id"] == md.task_id
            assert got[1][1] == got[3][1]
            assert unseal(got[4][1])["kind"] == "summary"
            assert "a:6" not in b.peers and "127.0.0.1:6" in b.peers
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           server.port)
            writer.write(_post("/pex/digest", b"x" * ((1 << 20) + 1)))
            await writer.drain()
            raw = await reader.read()          # closed after the answer
            writer.close()
            assert raw.startswith(b"HTTP/1.1 413 ")
        finally:
            await b.stop()
            await server.stop()

    run(go())


def test_advisory_packet_adds_parents_without_pruning(monkeypatch):
    """An advisory packet (the plane's ``prime``) adds its holders beside
    the scheduler's assignment; the scheduler's next packet prunes to its
    own set. Every admitted parent is handed to the observer."""
    from dragonfly2_tpu_torch.daemon import piece_engine

    monkeypatch.setattr(piece_engine._Synchronizer, "start",
                        lambda self: None)

    def addr(peer_id: str, port: int) -> PeerAddr:
        return PeerAddr(peer_id=peer_id, ip="127.0.0.1", rpc_port=port,
                        download_port=port + 1)

    async def go():
        seen = []
        engine = piece_engine.PieceEngine(peer_observer=seen.append)
        conductor = types.SimpleNamespace(peer_id="me", task_id="t")
        session = types.SimpleNamespace(packets=asyncio.Queue())
        task = asyncio.get_running_loop().create_task(
            engine._consume_packets(conductor, session))
        try:
            for packet in (
                    port_msg.PeerPacket(candidate_peers=[addr("s1", 10)]),
                    port_msg.PeerPacket(candidate_peers=[addr("pex-h", 20)],
                                        advisory=True)):
                session.packets.put_nowait(packet)
                await asyncio.sleep(0.05)
            assert set(engine.dispatcher.parents) == {"s1", "pex-h"}
            session.packets.put_nowait(
                port_msg.PeerPacket(candidate_peers=[addr("s2", 30)]))
            await asyncio.sleep(0.05)
            assert set(engine._synchronizers) == {"s2"}
            assert [p.peer_id for p in seen] == ["s1", "pex-h", "s2"]
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await engine._teardown()

    run(go())
