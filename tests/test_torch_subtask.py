"""Ranged reuse: sub-tasks over a parent's file, and ranged requests served
from a finished whole-file parent, against the reference.

* Storage (both packages, same inputs, same outcome): the reference's
  ``TestSubtask`` case (``tests/test_storage.py``) and its bounds check
  (``tests/test_daemon_e2e.py``); ``find_partial_completed_task``'s
  bounds; ranged ``store_to``; what the GC and a reload do with a
  sub-task (the GC drops one whose parent is gone or whose access is past
  the TTL; a reload finds the parent alone).
* ``parent_task_id`` equals the reference's.
* Daemons (both packages, each against the port's standard-library
  origin): the ranged cases of ``tests/test_daemon_e2e.py``. A ranged
  request fetches only its range; a range of a finished whole file is
  answered from disk (``peer_id`` ``"reused"``, no origin byte, the
  origin stopped); with ``download.prefetch_whole_file`` a ranged request
  warms the whole file and a later range is reused. The bytes and the
  origin's byte counts are the reference's. ``dfget --range`` through the
  port daemon's socket takes the reuse path.

Tolerances are exact.
"""

import argparse
import asyncio
import os

import numpy as np
import pytest

import dragonfly2_tpu.common.ids as ref_ids
import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.common.errors import DFError as RefDFError
from dragonfly2_tpu.daemon import config as ref_dconfig
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.storage.manager import StorageConfig as RefStorageConfig
from dragonfly2_tpu.storage.manager import StorageManager as RefStorageManager
from dragonfly2_tpu.storage.metadata import TaskMetadata as RefTaskMetadata
import dragonfly2_tpu_torch.common.ids as port_ids
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.daemon.config import DaemonConfig, DownloadConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.source import close_clients
from dragonfly2_tpu_torch.storage.manager import StorageConfig, StorageManager
from dragonfly2_tpu_torch.storage.metadata import TaskMetadata
from dragonfly2_tpu_torch.tools import dfget
from torch_origin import Origin

LIMIT_S = 30.0
PKGS = {
    "reference": (RefStorageManager, RefStorageConfig, RefTaskMetadata,
                  RefDFError),
    "port": (StorageManager, StorageConfig, TaskMetadata, DFError)}


@pytest.fixture(params=sorted(PKGS))
def storage(request):
    return PKGS[request.param]


# ---------------------------------------------------------------- storage

def test_subtask_shares_parent_file(tmp_path, storage):
    mgr_cls, cfg_cls, md_cls, _ = storage
    mgr = mgr_cls(cfg_cls(data_dir=str(tmp_path / "d")))
    parent_id = "p" * 64
    sub = mgr.register_subtask(md_cls(
        task_id="s" * 64, parent_task_id=parent_id,
        range_start=1000, range_length=2000, content_length=2000))
    sub.write_piece(0, 0, b"A" * 1500)
    sub.write_piece(1, 1500, b"B" * 500)
    sub.mark_done(success=True)
    assert sub.read_piece(0) == b"A" * 1500
    parent = mgr.get(parent_id)
    assert parent.read_range(1000, 4) == b"AAAA"
    assert parent.read_range(2500, 4) == b"BBBB"
    assert mgr.get("s" * 64) is sub
    assert [(p.num, p.start, p.size) for p in sub.piece_infos()] == \
        [(0, 0, 1500), (1, 1500, 500)]
    out = tmp_path / "sub.bin"
    sub.store_to(str(out))
    assert out.read_bytes() == b"A" * 1500 + b"B" * 500
    # the parent's piece table gains nothing
    assert parent.md.pieces == {}


def test_subtask_bounds_enforced(tmp_path, storage):
    mgr_cls, cfg_cls, md_cls, err_cls = storage
    mgr = mgr_cls(cfg_cls(data_dir=str(tmp_path / "d")))
    sub = mgr.register_subtask(md_cls(
        task_id="cd" * 32, parent_task_id="ef" * 32,
        range_start=0, range_length=1000))
    with pytest.raises(err_cls) as ei:
        sub.write_piece(0, 900, b"x" * 4096)
    assert int(ei.value.code) == int(Code.CLIENT_STORAGE_ERROR)
    with pytest.raises(err_cls):
        mgr.register_subtask(md_cls(task_id="ab" * 32, range_length=10))


def _finished(mgr, md_cls, task_id: str, data: bytes, piece: int = 4096):
    ts = mgr.register_task(md_cls(task_id=task_id, piece_size=piece,
                                  content_length=len(data)))
    for n, off in enumerate(range(0, len(data), piece)):
        ts.write_piece(n, off, data[off:off + piece])
    ts.mark_done(success=True, content_length=len(data),
                 total_piece_count=-(-len(data) // piece))
    return ts


def _partial_and_store(tmp_path, storage) -> dict:
    mgr_cls, cfg_cls, md_cls, _ = storage
    data = np.random.default_rng(5).integers(0, 256, 20000,
                                             dtype=np.uint8).tobytes()
    mgr = mgr_cls(cfg_cls(data_dir=str(tmp_path / "d")))
    _finished(mgr, md_cls, "w" * 64, data)
    got = {}
    for start, length in ((0, 20000), (0, 1), (19999, 1), (5000, 15001),
                          (20000, 0), (123, 4567)):
        hit = mgr.find_partial_completed_task("w" * 64, start, length)
        got[(start, length)] = hit is not None
        if hit is not None and length:
            out = tmp_path / f"r{start}-{length}.bin"
            hit.store_to(str(out), range_start=start, range_length=length)
            assert out.read_bytes() == data[start:start + length]
    got["unknown"] = mgr.find_partial_completed_task("v" * 64, 0, 1)
    whole = tmp_path / "whole.bin"
    mgr.get("w" * 64).store_to(str(whole))
    assert whole.read_bytes() == data
    return got


def test_partial_completed_task_bounds_match_reference(tmp_path):
    want = _partial_and_store(tmp_path / "ref", PKGS["reference"])
    got = _partial_and_store(tmp_path / "port", PKGS["port"])
    assert got == want
    assert got[(5000, 15001)] is False and got[(123, 4567)] is True


def _gc_and_reload(tmp_path, storage) -> dict:
    """A sub-task over a finished parent: a GC with a live parent keeps
    it; deleting the parent then a GC drops it; a stale sub-task goes at
    the next GC; a reload finds the parent alone."""
    mgr_cls, cfg_cls, md_cls, _ = storage
    cfg = cfg_cls(data_dir=str(tmp_path / "d"), task_ttl_s=60.0)
    mgr = mgr_cls(cfg)
    data = bytes(range(256)) * 40
    _finished(mgr, md_cls, "a" * 64, data)
    _finished(mgr, md_cls, "b" * 64, data[::-1])
    for sid, parent in (("s" * 64, "a" * 64), ("t" * 64, "b" * 64),
                        ("u" * 64, "a" * 64)):
        sub = mgr.register_subtask(md_cls(task_id=sid, parent_task_id=parent,
                                          range_start=10, range_length=100))
        sub.write_piece(0, 0, data[10:110])
    out = {"first_gc": mgr.try_gc()}
    out["kept"] = sorted(t for t in ("s", "t", "u")
                         if mgr.get(t * 64) is not None)
    mgr.delete_task("b" * 64)
    mgr.get("u" * 64).md.access_time -= 3600
    out["second_gc"] = mgr.try_gc()
    out["after"] = sorted(t for t in ("a", "b", "s", "t", "u")
                          if mgr.get(t * 64) is not None)
    again = mgr_cls(cfg)
    out["reloaded"] = sorted(ts.md.task_id[:1] for ts in again.tasks())
    out["reloaded_sub"] = again.get("s" * 64) is None
    return out


def test_gc_and_reload_keep_subtasks_as_the_reference_does(tmp_path):
    want = _gc_and_reload(tmp_path / "ref", PKGS["reference"])
    got = _gc_and_reload(tmp_path / "port", PKGS["port"])
    assert got == want
    assert got["kept"] == ["s", "t", "u"] and got["after"] == ["a", "s"]
    assert got["reloaded"] == ["a"] and got["reloaded_sub"]


@pytest.mark.parametrize("kw", [
    {}, {"tag": "t"}, {"application": "app", "digest": "sha256:00"},
    {"filtered_query_params": ["sig"]}])
def test_parent_task_id_equals_reference(kw):
    url = "http://origin/model.bin?sig=x&a=1"
    assert port_ids.parent_task_id(url, **kw) == \
        ref_ids.parent_task_id(url, **kw)
    assert port_ids.parent_task_id(url, **kw) == port_ids.task_id(url, **kw)


# ---------------------------------------------------------------- daemons

DATA = np.random.default_rng(9).integers(0, 256, 500_000,
                                         dtype=np.uint8).tobytes()


def _daemon(pkg: str, tmp_path, name: str, prefetch: bool = False):
    if pkg == "reference":
        cfg = ref_dconfig.DaemonConfig(
            workdir=str(tmp_path / name), host_ip="127.0.0.1", hostname=name,
            download=ref_dconfig.DownloadConfig(
                back_source_group_min_bytes=1 << 20,
                prefetch_whole_file=prefetch),
            storage=ref_dconfig.StorageSection(gc_interval_s=3600))
        return RefDaemon(cfg), ref_msg
    cfg = DaemonConfig(workdir=str(tmp_path / name), host_ip="127.0.0.1",
                       listen_ip="127.0.0.1", hostname=name, device="cpu",
                       download=DownloadConfig(
                           back_source_group_min_bytes=1 << 20,
                           prefetch_whole_file=prefetch))
    return Daemon(cfg), port_msg


async def _get(daemon, msg, url: str, out, rng: str = "") -> list:
    """One download; the frames' (peer_id, content_length, done)."""
    req = msg.DownloadRequest(url=url, output=str(out),
                              url_meta=msg.UrlMeta(range=rng),
                              timeout_s=LIMIT_S)
    frames = []
    async for resp in daemon.ptm.start_file_task(req):
        frames.append((resp.peer_id == "reused", resp.content_length,
                       resp.done))
    return frames


def _ranged_cases(pkg: str, tmp_path) -> dict:
    """The three ranged scenarios on one package's daemons; each step's
    bytes, frames and origin body bytes."""
    out: dict = {}

    async def main():
        try:
            # 1. a ranged request fetches only its range
            with Origin({"f": DATA}) as origin:
                d, msg = _daemon(pkg, tmp_path, "rng")
                await d.start()
                try:
                    f = await _get(d, msg, f"{origin.base}/f",
                                   tmp_path / "rng.bin", "bytes=1000-5999")
                finally:
                    await d.stop()
                out["range_only"] = (f[-1], origin.body_bytes,
                                     (tmp_path / "rng.bin").read_bytes()
                                     == DATA[1000:6000])
            # 2. a range of a finished whole file comes from disk, with the
            # origin stopped
            d, msg = _daemon(pkg, tmp_path, "whole")
            await d.start()
            try:
                with Origin({"f": DATA}) as origin:
                    url = f"{origin.base}/f"
                    await _get(d, msg, url, tmp_path / "whole.bin")
                    whole_bytes = origin.body_bytes
                f = await _get(d, msg, url, tmp_path / "part.bin",
                               "bytes=100-299")
            finally:
                await d.stop()
            out["from_parent"] = (f, whole_bytes,
                                  (tmp_path / "part.bin").read_bytes()
                                  == DATA[100:300])
            # 3. prefetch_whole_file: a range warms the whole file, and a
            # later range over another span is reused, the origin stopped
            d, msg = _daemon(pkg, tmp_path, "pref", prefetch=True)
            await d.start()
            try:
                with Origin({"f": DATA}) as origin:
                    url = f"{origin.base}/f"
                    f1 = await _get(d, msg, url, tmp_path / "p1.bin",
                                    "bytes=0-999")
                    parent = port_ids.parent_task_id(url)
                    for _ in range(400):
                        if d.storage_mgr.find_completed_task(parent):
                            break
                        await asyncio.sleep(0.025)
                    warmed = d.storage_mgr.find_completed_task(parent) \
                        is not None
                    while d.ptm._prefetch_tasks:
                        await asyncio.sleep(0.01)
                    pref_bytes = origin.body_bytes
                f2 = await _get(d, msg, url, tmp_path / "p2.bin",
                                "bytes=200000-299999")
            finally:
                await d.stop()
            out["prefetch"] = (f1[-1], f2, warmed, pref_bytes,
                               (tmp_path / "p1.bin").read_bytes()
                               == DATA[:1000],
                               (tmp_path / "p2.bin").read_bytes()
                               == DATA[200000:300000])
        finally:
            if pkg == "port":
                await close_clients()
    asyncio.run(asyncio.wait_for(main(), 3 * LIMIT_S))
    return out


def test_ranged_requests_match_the_reference(tmp_path):
    want = _ranged_cases("reference", tmp_path / "ref")
    got = _ranged_cases("port", tmp_path / "port")
    assert got == want
    assert got["range_only"] == ((False, 5000, True), 5000, True)
    frames, whole_bytes, ok = got["from_parent"]
    assert frames == [(True, 200, True)] and ok
    assert whole_bytes == len(DATA)
    first, second, warmed, pref_bytes, ok1, ok2 = got["prefetch"]
    assert first == (False, 1000, True) and warmed and ok1 and ok2
    assert second == [(True, 100000, True)]
    assert pref_bytes == 1000 + len(DATA)


def test_a_bad_range_of_a_finished_parent_is_invalid(tmp_path):
    async def main():
        d, msg = _daemon("port", tmp_path, "bad")
        await d.start()
        try:
            with Origin({"f": DATA}) as origin:
                url = f"{origin.base}/f"
                await _get(d, msg, url, tmp_path / "whole.bin")
                with pytest.raises(DFError) as err:
                    await _get(d, msg, url, tmp_path / "x.bin",
                               "bytes=600000-600010")
                return err.value.code
        finally:
            await d.stop()
            await close_clients()
    assert asyncio.run(asyncio.wait_for(main(), LIMIT_S)) == \
        Code.INVALID_ARGUMENT


def test_dfget_range_through_the_daemon_is_reused(tmp_path):
    """``dfget --range`` sends ``UrlMeta.range`` through the local API; a
    finished whole file answers it from disk."""
    async def main():
        d, _ = _daemon("port", tmp_path, "dfget")
        await d.start()
        try:
            with Origin({"f": DATA}) as origin:
                url = f"{origin.base}/f"
                args = dfget.build_parser().parse_args(
                    [url, "-O", str(tmp_path / "whole.bin"), "--quiet"])
                await dfget.download_via_daemon(d.unix_sock, args)
                before = origin.body_bytes
                args = dfget.build_parser().parse_args(
                    [url, "-O", str(tmp_path / "r.bin"), "--quiet",
                     "--range", "bytes=4096-8191"])
                frames = []
                await dfget.download_via_daemon(
                    d.unix_sock, args,
                    progress=lambda c, t, done=False: frames.append(
                        (c, t, done)))
                return before, origin.body_bytes, frames
        finally:
            await d.stop()
            await close_clients()
    before, after, frames = asyncio.run(asyncio.wait_for(main(), LIMIT_S))
    assert before == after == len(DATA)
    assert frames == [(4096, 4096, True)]
    assert (tmp_path / "r.bin").read_bytes() == DATA[4096:8192]
    assert os.path.getsize(tmp_path / "whole.bin") == len(DATA)
