"""A task's cached data fd does not outlive its owner.

``TaskStorage`` keeps one O_RDWR fd per task once piece IO starts
(``storage/store.py``). ``Daemon.stop`` releases every task's fd through
``StorageManager.close``, so a workdir removed after its daemon stopped
frees its disk at once, as it did when each IO call opened and closed
the file.
"""

import asyncio
import hashlib
import os

import numpy as np

from dragonfly2_tpu_torch.daemon.config import (DaemonConfig, DownloadConfig,
                                                StorageSection)
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import DownloadRequest, UrlMeta
from dragonfly2_tpu_torch.storage.manager import StorageConfig, StorageManager
from dragonfly2_tpu_torch.storage.metadata import TaskMetadata

LIMIT_S = 60


def _fds_under(root) -> list[str]:
    """The targets of this process's open fds that lie under ``root``."""
    root = os.path.realpath(root)
    out = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue                   # closed since the listing
        if target.startswith(root + os.sep):
            out.append(target)
    return out


def test_daemon_stop_releases_every_task_fd(tmp_path):
    rng = np.random.default_rng(24)
    blobs = [rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes()
             for _ in range(2)]
    for i, blob in enumerate(blobs):
        (tmp_path / f"origin{i}.bin").write_bytes(blob)
    workdir = tmp_path / "d1"

    async def main():
        daemon = Daemon(DaemonConfig(
            workdir=str(workdir), hostname="d1", device="cpu",
            download=DownloadConfig(back_source_group_min_bytes=1 << 20),
            storage=StorageSection(gc_interval_s=3600)))
        await daemon.start()
        try:
            for i, blob in enumerate(blobs):
                req = DownloadRequest(
                    url=f"file://{tmp_path}/origin{i}.bin",
                    output=str(tmp_path / f"out{i}.bin"),
                    url_meta=UrlMeta(digest="sha256:" + hashlib.sha256(
                        blob).hexdigest()),
                    timeout_s=30.0)
                async for _ in daemon.ptm.start_file_task(req):
                    pass
            held = _fds_under(workdir)
        finally:
            await daemon.stop()
        return held

    held = asyncio.run(asyncio.wait_for(main(), LIMIT_S))
    # the pulls held their tasks' data fds (the check below is not vacuous)
    assert len(held) >= 2, held
    assert _fds_under(workdir) == []
    for i, blob in enumerate(blobs):
        assert (tmp_path / f"out{i}.bin").read_bytes() == blob


def test_storage_manager_close_drops_fds_and_io_reopens(tmp_path):
    mgr = StorageManager(StorageConfig(data_dir=str(tmp_path / "data"),
                                       gc_interval_s=3600))
    tasks = []
    for i in range(3):
        ts = mgr.register_task(TaskMetadata(
            task_id=f"{i:064x}", url=f"file:///t{i}", content_length=8,
            total_piece_count=1, piece_size=8))
        ts.write_piece(0, 0, bytes([i]) * 8, "")
        tasks.append(ts)
    assert len(_fds_under(tmp_path)) == 3
    mgr.close()
    assert _fds_under(tmp_path) == []
    # a later lease reopens the path
    assert tasks[1].read_piece(0) == bytes([1]) * 8
    mgr.close()
    assert _fds_under(tmp_path) == []
