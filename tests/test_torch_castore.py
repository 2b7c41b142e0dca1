"""The content-addressed store, warm restart and disk GC, held against the
JAX package.

* The cases of the reference's ``tests/test_castore.py`` from
  ``TestContentKey`` through ``TestPopularityEviction`` run through both
  packages (``pkg`` = ``ref`` or ``port``) with the same seeded content:
  content keys, placement with re-verification, the dedupe switch,
  hardlink coalescing and its accounting, adoption by digest, reload of
  partials with re-verification and demotion, torn metadata, popularity-
  ordered eviction and the persistent-task pin.
* ``try_gc`` evicts the same tasks in the same order as the reference's
  on the same tasks, serves and clock.
* A task directory the reference wrote reloads in the port, and the
  reverse: both use ``<data_dir>/<task_id[:3]>/<task_id>`` and the same
  ``metadata.json``.
* Daemon placement (the reference's ``TestDaemonPlacement``), on the
  port with ``file://`` origins: an alias pull adopts the whole content,
  a ranged request never does, and a leecher places announced piece
  digests it already holds under another task instead of pulling them.
  Where the reference reads its flight recorder, these read the content
  store's hit counters (the flight recorder is not ported yet).
* Warm restart: a replica's persisted warm partial reloads in a fresh
  daemon on the same workdir, re-verifies, and the re-pull takes no byte
  from the origin or a peer.

Tolerances are exact. Every test that starts servers runs under
``asyncio.wait_for``.
"""

import asyncio
import hashlib
import os
import time

import numpy as np
import pytest

from dragonfly2_tpu.common import digest as ref_digest
from dragonfly2_tpu.common import piece as ref_piece
from dragonfly2_tpu.idl.messages import TaskType as RefTaskType
from dragonfly2_tpu.storage import castore as ref_castore
from dragonfly2_tpu.storage import manager as ref_manager
from dragonfly2_tpu.storage import metadata as ref_metadata
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch import source as port_source
from dragonfly2_tpu_torch.common import digest as port_digest
from dragonfly2_tpu_torch.common import piece as port_piece
from dragonfly2_tpu_torch.common.metrics import REGISTRY
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.config import StorageSection
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import TaskType as PortTaskType
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.source.file_client import FileSourceClient
from dragonfly2_tpu_torch.storage import castore as port_castore
from dragonfly2_tpu_torch.storage import manager as port_manager
from dragonfly2_tpu_torch.storage import metadata as port_metadata

E2E_LIMIT_S = 60.0
MiB = 1 << 20


class _Pkg:
    def __init__(self, digest, piece, castore, manager, metadata, task_type):
        self.digest = digest
        self.piece = piece
        self.castore = castore
        self.manager = manager
        self.metadata = metadata
        self.TaskType = task_type


PKGS = {"ref": _Pkg(ref_digest, ref_piece, ref_castore, ref_manager,
                    ref_metadata, RefTaskType),
        "port": _Pkg(port_digest, port_piece, port_castore, port_manager,
                     port_metadata, PortTaskType)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def make_manager(pkg, tmp_path, **kw):
    return pkg.manager.StorageManager(pkg.manager.StorageConfig(
        data_dir=str(tmp_path / "data"), **kw))


def fill_task(pkg, mgr, task_id: str, content: bytes, *, url: str = "",
              digest: str = "", task_type=None,
              pieces_only: int | None = None, piece_size: int = 0,
              priority: int = 0, qos_class: str = ""):
    """Land ``content`` (optionally just the first N pieces) with per-piece
    digests recorded: the shape every content-store feature keys on."""
    size = piece_size or pkg.piece.compute_piece_size(len(content))
    n = pkg.piece.piece_count(len(content), size)
    algo = pkg.digest.preferred_piece_algo()
    ts = mgr.register_task(pkg.metadata.TaskMetadata(
        task_id=task_id, task_type=task_type or pkg.TaskType.STANDARD,
        url=url or f"http://o/{task_id[:8]}",
        content_length=len(content), total_piece_count=n, piece_size=size,
        digest=digest, priority=priority, qos_class=qos_class))
    for i in range(n if pieces_only is None else pieces_only):
        off, ln = pkg.piece.piece_range(i, size, len(content))
        ts.write_piece(i, off, content[off:off + ln],
                       pkg.digest.for_bytes(algo, content[off:off + ln]))
    if pieces_only is None:
        ts.md.digest = digest
        ts.mark_done(success=True)
    else:
        ts.persist()
    return ts


# ------------------------------------------------- the reference's cases


class TestContentKey:
    def test_complete_task_keys_on_geometry_and_digests(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        content = _bytes(300_000, 1)
        a = fill_task(pkg, mgr, "a" * 64, content)
        b = fill_task(pkg, mgr, "b" * 64, content)
        assert pkg.castore.content_key(a.md) == pkg.castore.content_key(b.md)
        other = fill_task(pkg, mgr, "c" * 64, _bytes(300_000, 2))
        assert pkg.castore.content_key(other.md) != \
            pkg.castore.content_key(a.md)

    def test_incomplete_or_digestless_has_no_key(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        partial = fill_task(pkg, mgr, "d" * 64, _bytes(300_000, 3),
                            pieces_only=1)
        assert pkg.castore.content_key(partial.md) is None
        bare = mgr.register_task(pkg.metadata.TaskMetadata(task_id="e" * 64))
        assert pkg.castore.content_key(bare.md) is None


class TestPieceIndex:
    def test_place_piece_copies_and_verifies(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        content = _bytes(300_000, 4)
        src = fill_task(pkg, mgr, "a" * 64, content)
        meta0 = src.md.pieces[0]
        dst = mgr.register_task(pkg.metadata.TaskMetadata(
            task_id="b" * 64, content_length=len(content),
            total_piece_count=src.md.total_piece_count,
            piece_size=src.md.piece_size))
        assert mgr.castore.place_piece(dst, 0, 0, meta0.size, meta0.digest)
        assert dst.read_piece(0) == content[:meta0.size]
        assert dst.md.pieces[0].source == "cas"

    def test_place_refuses_corrupt_holder_and_drops_loc(self, pkg, tmp_path):
        """Bit-rot on the holder's disk fails the placement (the copy
        re-verifies) and un-indexes the lying location."""
        mgr = make_manager(pkg, tmp_path)
        content = _bytes(300_000, 5)
        src = fill_task(pkg, mgr, "a" * 64, content)
        meta0 = src.md.pieces[0]
        with open(src.data_path(), "r+b") as f:   # rot piece 0 in place
            f.seek(3)
            f.write(b"\xff\xff\xff")
        rotten = []
        mgr.castore.on_rot = rotten.append
        dst = mgr.register_task(pkg.metadata.TaskMetadata(task_id="b" * 64))
        assert not mgr.castore.place_piece(dst, 0, 0, meta0.size,
                                           meta0.digest)
        assert mgr.castore.find_piece(meta0.digest, meta0.size) is None
        assert rotten == ["a" * 64]

    def test_drop_task_unindexes(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        src = fill_task(pkg, mgr, "a" * 64, _bytes(120_000, 6))
        dg = src.md.pieces[0].digest
        assert mgr.castore.find_piece(dg, src.md.pieces[0].size)
        mgr.delete_task("a" * 64)
        assert mgr.castore.find_piece(dg, src.md.pieces[0].size) is None

    def test_dedupe_disabled_runs_task_keyed(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path, dedupe_enabled=False)
        assert mgr.castore is None
        content = _bytes(120_000, 7)
        a = fill_task(pkg, mgr, "a" * 64, content)
        b = fill_task(pkg, mgr, "b" * 64, content)
        assert a.inode() != b.inode()      # every copy pays its own disk


class TestContentDedupe:
    def test_identical_completed_tasks_share_one_inode(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        content = _bytes(300_000, 8)
        a = fill_task(pkg, mgr, "a" * 64, content)
        b = fill_task(pkg, mgr, "b" * 64, content)
        assert a.inode() == b.inode()
        assert a.nlink() >= 2
        assert b.read_piece(0) == content[:b.md.pieces[0].size]
        assert mgr.usage() == (2 * a.disk_usage(), a.disk_usage())

    def test_canonical_eviction_promotes_next_holder(self, pkg, tmp_path):
        """Deleting the canonical alias neither orphans the shared bytes
        nor makes the next alias pay for its own copy."""
        mgr = make_manager(pkg, tmp_path)
        content = _bytes(300_000, 9)
        fill_task(pkg, mgr, "a" * 64, content)
        b = fill_task(pkg, mgr, "b" * 64, content)
        mgr.delete_task("a" * 64)
        assert b.read_piece(0) == content[:b.md.pieces[0].size]
        c = fill_task(pkg, mgr, "c" * 64, content)
        assert c.inode() == b.inode()      # the promoted holder absorbed it

    def test_adopt_content_by_digest(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        content = _bytes(300_000, 10)
        dg = pkg.digest.for_bytes("sha256", content)
        src = fill_task(pkg, mgr, "a" * 64, content, digest=dg)
        ts = mgr.adopt_content(pkg.metadata.TaskMetadata(task_id="b" * 64,
                                                         digest=dg))
        assert ts is not None and ts.md.done and ts.md.success
        assert ts.inode() == src.inode()
        assert len(ts.md.pieces) == len(src.md.pieces)
        got = b"".join(ts.read_piece(p.num) for p in ts.piece_infos())
        assert got == content
        assert mgr.adopt_content(pkg.metadata.TaskMetadata(
            task_id="c" * 64, digest="sha256:" + "0" * 64)) is None


class TestWarmReload:
    def test_partial_task_survives_restart_with_verified_pieces(
            self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        fill_task(pkg, mgr, "a" * 64, _bytes(600_000, 11), pieces_only=2,
                  piece_size=200_000)
        mgr2 = make_manager(pkg, tmp_path)
        ts = mgr2.get("a" * 64)
        assert ts is not None and not ts.md.done
        assert sorted(ts.md.pieces) == [0, 1]
        stats = mgr2.verify_reloaded()
        assert stats["pieces_ok"] == 2 and stats["pieces_dropped"] == 0
        # the reloaded pieces are indexed: a second task places them
        meta0 = ts.md.pieces[0]
        dst = mgr2.register_task(pkg.metadata.TaskMetadata(task_id="b" * 64))
        assert mgr2.castore.place_piece(dst, 0, 0, meta0.size, meta0.digest)

    def test_verify_drops_rotted_piece_and_demotes_task(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        ts = fill_task(pkg, mgr, "a" * 64, _bytes(600_000, 12),
                       piece_size=200_000)
        p1 = ts.md.pieces[1]
        with open(ts.data_path(), "r+b") as f:
            f.seek(p1.start + 5)
            f.write(b"\x00\x11\x22\x33")
        mgr2 = make_manager(pkg, tmp_path)
        stats = mgr2.verify_reloaded()
        assert stats["pieces_dropped"] == 1 and stats["pieces_rot"] == 1
        ts2 = mgr2.get("a" * 64)
        assert ts2 is not None
        assert 1 not in ts2.md.pieces          # the hole, not the task
        assert not ts2.md.done                 # demoted: re-pull the hole
        assert mgr2.find_completed_task("a" * 64) is None
        # the demotion persisted: a third boot sees the same partial
        mgr3 = make_manager(pkg, tmp_path)
        assert not mgr3.get("a" * 64).md.done

    def test_all_rotten_task_dropped(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        ts = fill_task(pkg, mgr, "a" * 64, _bytes(100_000, 13))
        with open(ts.data_path(), "r+b") as f:
            f.write(_bytes(100_000, 14))       # total rot
        mgr2 = make_manager(pkg, tmp_path)
        stats = mgr2.verify_reloaded()
        assert stats["tasks_dropped"] == 1
        assert mgr2.get("a" * 64) is None

    def test_digestless_partial_discarded(self, pkg, tmp_path):
        """A partial whose pieces carry no digests cannot be re-verified:
        reload discards it."""
        mgr = make_manager(pkg, tmp_path)
        ts = mgr.register_task(pkg.metadata.TaskMetadata(task_id="a" * 64))
        ts.write_piece(0, 0, b"x" * 1000)
        ts.md.pieces[0].digest = ""            # legacy metadata
        ts.persist()
        mgr2 = make_manager(pkg, tmp_path)
        assert mgr2.get("a" * 64) is None

    def test_async_verify_equals_the_blocking_one(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        ts = fill_task(pkg, mgr, "a" * 64, _bytes(600_000, 15),
                       piece_size=200_000)
        fill_task(pkg, mgr, "b" * 64, _bytes(300_000, 16), pieces_only=1,
                  piece_size=200_000)
        with open(ts.data_path(), "r+b") as f:
            f.seek(ts.md.pieces[2].start + 1)
            f.write(b"\x01\x02")
        stats = asyncio.run(make_manager(pkg, tmp_path)
                            .verify_reloaded_async())
        assert stats == {"tasks": 2, "pieces_ok": 3, "pieces_dropped": 1,
                         "tasks_dropped": 0, "pieces_rot": 1}


class TestCrashSafeMetadata:
    def test_save_leaves_no_tmp_and_replaces_atomically(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path)
        ts = fill_task(pkg, mgr, "a" * 64, _bytes(50_000, 17))
        files = os.listdir(ts.dir)
        assert pkg.metadata.METADATA_FILE in files
        assert not [f for f in files if f.endswith(".tmp")]

    def test_truncated_metadata_never_boots(self, pkg, tmp_path):
        """A torn metadata file is rejected at load and the task discarded
        at reload, never half-parsed into a lying piece table."""
        mgr = make_manager(pkg, tmp_path)
        ts = fill_task(pkg, mgr, "a" * 64, _bytes(50_000, 18))
        mpath = os.path.join(ts.dir, pkg.metadata.METADATA_FILE)
        raw = open(mpath, "rb").read()
        with open(mpath, "wb") as f:
            f.write(raw[:len(raw) // 2])       # torn mid-write
        with pytest.raises((ValueError, KeyError)):
            pkg.metadata.TaskMetadata.load(ts.dir)
        mgr2 = make_manager(pkg, tmp_path)
        assert mgr2.get("a" * 64) is None
        assert not os.path.isdir(ts.dir)


class TestPopularityEviction:
    def test_hot_task_outlives_cold_at_capacity(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path, capacity_bytes=10_000,
                           disk_gc_high_ratio=0.5, disk_gc_low_ratio=0.45)
        fill_task(pkg, mgr, "1" * 64, _bytes(4000, 19))
        hot = fill_task(pkg, mgr, "2" * 64, _bytes(4000, 20))
        # the hot one is the older-accessed: recency alone would evict it
        hot.md.access_time -= 1000
        for _ in range(5):
            mgr.castore.record_serve("2" * 64, 4000)
        assert mgr.try_gc() >= 1
        assert mgr.get("2" * 64) is not None   # popularity saved it
        assert mgr.get("1" * 64) is None

    def test_gc_reports_logical_vs_physical_for_shared_bytes(self, pkg,
                                                             tmp_path):
        """Evicting one alias of hardlink-shared content frees logical
        bytes but no physical ones, and the sweep goes on until the
        physical watermark is met."""
        mgr = make_manager(pkg, tmp_path, capacity_bytes=10_000,
                           disk_gc_high_ratio=0.5, disk_gc_low_ratio=0.45)
        content = _bytes(6000, 21)
        a = fill_task(pkg, mgr, "1" * 64, content)
        b = fill_task(pkg, mgr, "2" * 64, content)
        assert a.inode() == b.inode()          # shared: physical 6000
        assert mgr.usage() == (12000, 6000)
        a.md.access_time -= 100
        assert mgr.try_gc() >= 1               # 6000/10000 > 0.5
        stats = mgr.last_gc_stats
        assert stats["logical_bytes_freed"] >= 6000
        assert stats["physical_bytes_freed"] < stats["logical_bytes_freed"]

    def test_ttl_eviction_still_spares_persistent(self, pkg, tmp_path):
        mgr = make_manager(pkg, tmp_path, task_ttl_s=0.0)
        fill_task(pkg, mgr, "1" * 64, b"x" * 1000)
        fill_task(pkg, mgr, "2" * 64, b"y" * 1000,
                  task_type=pkg.TaskType.PERSISTENT)
        time.sleep(0.01)
        assert mgr.try_gc() == 1
        assert mgr.get("2" * 64) is not None


# ------------------------------------------------------ port against ref


def _gc_order(pkg, tmp_path, monkeypatch) -> tuple[list[str], dict]:
    """Ten tasks of mixed priority, class, serves and age under one frozen
    clock; the order ``try_gc`` deletes them in, and its stats."""
    clock = {"mono": 1000.0, "wall": 1.7e9}
    monkeypatch.setattr(pkg.castore.time, "monotonic",
                        lambda: clock["mono"])
    monkeypatch.setattr(pkg.manager.time, "monotonic",
                        lambda: clock["mono"])
    monkeypatch.setattr(pkg.manager.time, "time", lambda: clock["wall"])
    mgr = make_manager(pkg, tmp_path, capacity_bytes=100_000,
                       disk_gc_high_ratio=0.5, disk_gc_low_ratio=0.2,
                       task_ttl_s=3600.0)
    rng = np.random.default_rng(42)
    for i in range(10):
        tid = f"{i}" * 64
        ts = fill_task(pkg, mgr, tid, _bytes(7000, 100 + i),
                       priority=int(rng.integers(0, 3)),
                       qos_class=["", "critical", "standard", "bulk"][i % 4])
        ts.md.access_time = clock["wall"] - float(rng.integers(0, 600))
        for _ in range(int(rng.integers(0, 4))):
            clock["mono"] += float(rng.integers(1, 300))
            mgr.castore.record_serve(tid, int(rng.integers(1, 8)) * MiB)
    stale = fill_task(pkg, mgr, "s" * 64, _bytes(3000, 99))
    stale.md.access_time = clock["wall"] - 7200.0     # past the TTL
    clock["mono"] += 120.0
    order: list[str] = []
    delete = mgr.delete_task

    def recording(task_id):
        order.append(task_id[0])
        return delete(task_id)
    mgr.delete_task = recording
    mgr.try_gc()
    return order, mgr.last_gc_stats


def test_try_gc_evicts_in_the_reference_order(tmp_path, monkeypatch):
    got = _gc_order(PKGS["port"], tmp_path / "port", monkeypatch)
    want = _gc_order(PKGS["ref"], tmp_path / "ref", monkeypatch)
    assert got == want
    order, stats = got
    assert order[0] == "s" and 1 < len(order) < 11
    assert stats["reclaimed_tasks"] == len(order)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_task_directories_reload_in_the_other_package(tmp_path, writer,
                                                      reader):
    """The same layout and metadata: a complete task and a warm partial
    written by one package reload, verified, in the other."""
    w, r = PKGS[writer], PKGS[reader]
    mgr = make_manager(w, tmp_path)
    content = _bytes(600_000, 23)
    fill_task(w, mgr, "a" * 64, content, piece_size=200_000)
    fill_task(w, mgr, "b" * 64, content, pieces_only=2, piece_size=200_000)
    again = make_manager(r, tmp_path)
    assert again.reloaded_tasks == 2
    assert again.verify_reloaded()["pieces_ok"] == 5
    done = again.find_completed_task("a" * 64)
    assert done is not None and done.data_path().endswith(
        os.path.join("aaa", "a" * 64, "data"))
    assert b"".join(done.read_piece(n) for n in range(3)) == content
    assert sorted(again.get("b" * 64).md.pieces) == [0, 1]


# ------------------------------------------------------ daemon placement


def _hits() -> dict:
    hits = REGISTRY.counter("df_store_dedupe_hits_total", labels=("kind",))
    return {k: hits.value(k) for k in ("piece", "task", "content")} | {
        "bytes": REGISTRY.counter("df_store_dedupe_bytes_total").value()}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def _daemon(tmp_path, name: str, **kw) -> Daemon:
    return Daemon(DaemonConfig(
        workdir=str(tmp_path / name), hostname=name, listen_ip="127.0.0.1",
        host_ip="127.0.0.1", device="cpu",
        storage=StorageSection(gc_interval_s=3600), **kw))


async def _get(daemon, url: str, meta: dict, **req) -> str:
    task_id = None
    async for resp in daemon.ptm.start_file_task(port_msg.DownloadRequest(
            url=url, url_meta=port_msg.UrlMeta(**meta), timeout_s=60.0,
            **req)):
        task_id = resp.task_id or task_id
    return task_id


def _origin(tmp_path, names, n: int, seed: int) -> tuple[list[str], bytes]:
    data = _bytes(n, seed)
    urls = []
    for name in names:
        path = tmp_path / name
        path.write_bytes(data)
        urls.append(f"file://{path}")
    return urls, data


class TestDaemonPlacement:
    def test_alias_pull_adopts_whole_content(self, tmp_path):
        """The same bytes under two URLs (two task ids): the second pull
        moves no byte from anywhere, and the two tasks share one inode."""
        urls, data = _origin(tmp_path, ["m1.bin", "m2.bin"], 5 * MiB, 31)
        dg = "sha256:" + hashlib.sha256(data).hexdigest()

        async def main():
            daemon = _daemon(tmp_path, "d1")
            await daemon.start()
            try:
                tids = []
                for url, out in zip(urls, ("out-m1.bin", "out-m2.bin")):
                    before = _hits()
                    tids.append(await _get(daemon, url, {"digest": dg},
                                           output=str(tmp_path / out)))
                assert (tmp_path / "out-m2.bin").read_bytes() == data
                c1, c2 = (daemon.ptm.conductor(t) for t in tids)
                assert c1.traffic_source == len(data)
                assert (c2.traffic_source, c2.traffic_p2p,
                        c2.traffic_placed) == (0, 0, len(data))
                ts1, ts2 = (daemon.storage_mgr.get(t) for t in tids)
                assert ts1.inode() == ts2.inode()
                assert _delta(before, _hits()) == {
                    "piece": 0, "task": 0, "content": 1, "bytes": len(data)}
                assert daemon.storage_mgr.castore.stats()["content_digests"] \
                    == 1
            finally:
                await daemon.stop()

        asyncio.run(asyncio.wait_for(main(), E2E_LIMIT_S))

    def test_ranged_request_never_adopts_whole_content(self, tmp_path):
        """A ranged request carrying a whole-file digest is not adopted
        whole: the client gets exactly its range."""
        urls, data = _origin(tmp_path, ["m.bin"], 2 * MiB, 32)
        dg = "sha256:" + hashlib.sha256(data).hexdigest()

        async def main():
            daemon = _daemon(tmp_path, "d1")
            await daemon.start()
            try:
                await _get(daemon, urls[0], {"digest": dg})
                before = _hits()
                out = tmp_path / "range.bin"
                await _get(daemon, urls[0],
                           {"digest": dg, "range": "bytes=100-299"},
                           output=str(out))
                assert out.read_bytes() == data[100:300]
                assert _delta(before, _hits())["content"] == 0
            finally:
                await daemon.stop()

        asyncio.run(asyncio.wait_for(main(), E2E_LIMIT_S))

    def test_engine_places_announced_digests_instead_of_pulling(
            self, tmp_path):
        """P2P path: a leecher that holds the announced piece digests
        under another task id places them from its own disk; the seed's
        upload server serves no byte of the second task."""
        urls, data = _origin(tmp_path, ["m.bin"], 9 * MiB + 333, 33)
        upload = REGISTRY.counter("df_upload_bytes_total")

        async def main():
            seed = _daemon(tmp_path, "seed", is_seed=True)
            await seed.start()
            sched = Scheduler(SchedulerConfig(
                listen_ip="127.0.0.1", seed_peers=[SeedPeerAddr(
                    host_id=seed.host_info().id, ip="127.0.0.1",
                    rpc_port=seed.rpc.port,
                    download_port=seed.upload_server.port)]))
            await sched.start()
            leech = _daemon(tmp_path, "leech", scheduler=DaemonSched(
                addresses=[sched.address]))
            await leech.start()
            try:
                first = await _get(leech, urls[0], {"tag": "one"},
                                   disable_back_source=True)
                c1 = leech.ptm.conductor(first)
                assert c1.traffic_p2p == len(data)
                served = upload.value()
                before = _hits()
                alias = await _get(leech, urls[0], {"tag": "two"},
                                   disable_back_source=True)
                c2 = leech.ptm.conductor(alias)
                assert alias != first and c2.state == c2.SUCCESS
                assert (c2.traffic_p2p, c2.traffic_source,
                        c2.traffic_placed) == (0, 0, len(data))
                assert upload.value() == served
                hits = _delta(before, _hits())
                assert hits["piece"] == 3 and hits["bytes"] == len(data)
                with open(leech.storage_mgr.get(alias).data_path(),
                          "rb") as f:
                    assert f.read() == data
            finally:
                await leech.stop()
                await sched.stop()
                await seed.stop()

        asyncio.run(asyncio.wait_for(main(), E2E_LIMIT_S))


# ----------------------------------------------------------- warm restart


class _CountingFileClient(FileSourceClient):
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


def test_restarted_replica_repulls_its_warm_partial_from_disk(tmp_path):
    """A replica pulls a shard subset (a warm partial, persisted), stops,
    and a fresh daemon on the same workdir pulls the same subset again:
    the partial reloads and re-verifies at start, and the re-pull lands
    every tensor from disk with no byte from the origin or a peer."""
    urls, data = _origin(tmp_path, ["ckpt.bin"], 20 * MiB + 4321, 34)
    q = 5 * MiB
    shards = [port_msg.ShardInfo(name=f"s{i}", range_start=i * q,
                                 range_size=q, dtype="uint8")
              for i in range(4)]
    manifest = port_msg.ShardManifest(shards=shards)
    counting = _CountingFileClient()
    upload = REGISTRY.counter("df_upload_bytes_total")

    async def pull(daemon):
        task_id = None
        async for resp in daemon.ptm.start_file_task(
                port_msg.DownloadRequest(
                    url=urls[0], url_meta=port_msg.UrlMeta(shards="s1,s2"),
                    disable_back_source=True, shard_manifest=manifest,
                    device_sink=port_msg.DeviceSink(enabled=True),
                    timeout_s=60.0)):
            task_id = resp.task_id or task_id
        c = daemon.ptm.conductor(task_id)
        out = await asyncio.to_thread(c.device_ingest.result, 30)
        return c, out

    async def main():
        seed = _daemon(tmp_path, "seed", is_seed=True)
        await seed.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await sched.start()
        cfg = {"scheduler": DaemonSched(addresses=[sched.address])}
        try:
            first = _daemon(tmp_path, "replica", **cfg)
            await first.start()
            try:
                c1, _ = await pull(first)
                assert c1.traffic_p2p > 0 and not c1.storage.md.done
            finally:
                await first.stop()
            read, served = counting.bytes_read, upload.value()
            again = _daemon(tmp_path, "replica", **cfg)
            assert again.storage_mgr.reloaded_tasks == 1
            await again.start()
            try:
                assert again.reload_stats["pieces_ok"] == len(
                    c1.storage.md.pieces)
                assert again.reload_stats["pieces_dropped"] == 0
                c2, out = await pull(again)
            finally:
                await again.stop()
            return c1, c2, out, read, served
        finally:
            await sched.stop()
            await seed.stop()

    previous = port_source.client_for("file://")
    port_source.register_client("file", counting)
    try:
        c1, c2, out, read, served = asyncio.run(
            asyncio.wait_for(main(), E2E_LIMIT_S))
    finally:
        port_source.register_client("file", previous)
    assert (c2.traffic_p2p, c2.traffic_source) == (0, 0)
    assert c2.traffic_placed == sum(
        c1.storage.md.pieces[n].size for n in c2.ready)
    assert counting.bytes_read == read and upload.value() == served
    assert list(out) == ["s1", "s2"]
    for s in shards[1:3]:
        got = out[s.name].reshape(-1).numpy().tobytes()
        assert got == data[s.range_start:s.range_start + s.range_size]
