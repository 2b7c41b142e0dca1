"""ShardPrefetcher through the port, held against the JAX package.

Four seeded ``file://`` shards at depth 2 go through both packages'
prefetchers: the shards must arrive in order with the origin's bytes, later
shards must be in flight while the first is consumed, and no shard may be
left in storage afterwards. The remaining cases port
``tests/test_tpu_data.py`` onto the port with ``file://`` shards.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

from dragonfly2_tpu.daemon import config as ref_config
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.tpu.data import ShardPrefetcher as RefShardPrefetcher
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.tpu.data import ShardPrefetcher


def _shards(tmp_path, n=4):
    rng = np.random.default_rng(11)
    urls, data = [], []
    for i in range(n):
        blob = rng.integers(0, 256, 512 * 1024 + 17 * i,
                            dtype=np.uint8).tobytes()
        path = tmp_path / f"shard-{i}.tar"
        path.write_bytes(blob)
        urls.append(f"file://{path}")
        data.append(blob)
    return urls, data


def _port_daemon(tmp_path, name="pf"):
    return Daemon(DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                               device="cpu"))


def _reassemble(arrays) -> bytes:
    return b"".join(np.asarray(a).tobytes() for a in arrays)


async def _consume(daemon, prefetcher_cls, urls):
    """Drain one prefetcher; returns (shard bytes in order, the URLs whose
    download had started when shard 0 was handed over)."""
    started = []
    real = daemon.ptm.start_file_task

    def recording(req):
        started.append(req.url)
        return real(req)

    daemon.ptm.start_file_task = recording
    stream = prefetcher_cls(daemon, urls, depth=2).astream()
    first = await stream.__anext__()
    at_first = list(started)
    rest = [_reassemble(a) async for a in stream]
    return [_reassemble(first)] + rest, at_first


def test_parity_ordered_overlapped_streamed_through(tmp_path):
    urls, data = _shards(tmp_path)

    async def main():
        ref = RefDaemon(ref_config.DaemonConfig(
            workdir=str(tmp_path / "ref"), host_ip="127.0.0.1",
            hostname="ref",
            storage=ref_config.StorageSection(gc_interval_s=3600)))
        port = _port_daemon(tmp_path)
        await ref.start()
        await port.start()
        try:
            out = [await _consume(ref, RefShardPrefetcher, urls),
                   await _consume(port, ShardPrefetcher, urls)]
            left = [[t for t in d.ptm.storage_mgr.tasks() if t.md.done]
                    for d in (ref, port)]
            return out, left
        finally:
            await port.stop()
            await ref.stop()

    (theirs, ours), left = asyncio.run(main())
    # structural overlap: shard 1 was already downloading when shard 0 was
    # handed to the consumer (depth 2)
    assert ours[1] == theirs[1] == urls[:2]
    assert len(ours[0]) == len(theirs[0]) == 4
    for i, (o, t) in enumerate(zip(ours[0], theirs[0])):
        assert o[:len(data[i])] == t[:len(data[i])] == data[i], f"shard {i}"
        assert not any(o[len(data[i]):])
    assert left == [[], []], "shards must not accumulate in storage"


def test_skip_failed_yields_the_rest(tmp_path):
    urls, data = _shards(tmp_path, 3)

    async def main():
        daemon = _port_daemon(tmp_path)
        await daemon.start()
        try:
            missing = f"file://{tmp_path}/missing/shard-9.tar"
            pf = ShardPrefetcher(daemon, [urls[0], missing, urls[2]],
                                 depth=2, skip_failed=True)
            out = [_reassemble(a) async for a in pf.astream()]
            assert len(out) == 2
            assert out[0][:len(data[0])] == data[0]
            assert out[1][:len(data[2])] == data[2]
            with pytest.raises(Exception):
                async for _ in ShardPrefetcher(daemon, [missing]).astream():
                    pass
        finally:
            await daemon.stop()

    asyncio.run(main())


def test_early_consumer_exit_cancels_inflight(tmp_path):
    urls, data = _shards(tmp_path)

    async def main():
        daemon = _port_daemon(tmp_path)
        await daemon.start()
        try:
            stream = ShardPrefetcher(daemon, urls, depth=2).astream()
            first = await stream.__anext__()
            assert _reassemble(first)[:len(data[0])] == data[0]
            await stream.aclose()
            out = [_reassemble(a) async for a in
                   ShardPrefetcher(daemon, [urls[3]]).astream()]
            assert out[0][:len(data[3])] == data[3]
        finally:
            await daemon.stop()

    asyncio.run(main())


def test_second_epoch_rebuilds_from_storage(tmp_path):
    """delete_after=False + a second epoch: the completed-task fast path
    has no conductor, so the prefetcher rebuilds the device leg from the
    stored pieces."""
    urls, data = _shards(tmp_path, 2)

    async def main():
        daemon = _port_daemon(tmp_path)
        await daemon.start()
        try:
            for epoch in range(2):
                pf = ShardPrefetcher(daemon, urls, depth=2,
                                     delete_after=False)
                out = [_reassemble(a) async for a in pf.astream()]
                for i, got in enumerate(out):
                    assert got[:len(data[i])] == data[i], (epoch, i)
            assert len(daemon.ptm.storage_mgr.tasks()) == 2
        finally:
            await daemon.stop()

    asyncio.run(main())


def test_sync_facade_from_training_thread(tmp_path):
    urls, data = _shards(tmp_path, 3)
    boot: dict = {}
    ready = threading.Event()
    stop = threading.Event()

    def daemon_thread():
        async def main():
            daemon = _port_daemon(tmp_path)
            await daemon.start()
            boot["daemon"] = daemon
            boot["loop"] = asyncio.get_running_loop()
            ready.set()
            while not stop.is_set():
                await asyncio.sleep(0.02)
            await daemon.stop()

        asyncio.run(main())

    t = threading.Thread(target=daemon_thread, daemon=True)
    t.start()
    assert ready.wait(timeout=60)
    try:
        pf = ShardPrefetcher(boot["daemon"], urls, depth=2,
                             loop=boot["loop"])
        got = [_reassemble(a) for a in pf]
        assert len(got) == 3
        for i, g in enumerate(got):
            assert g[:len(data[i])] == data[i]
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()


def test_duplicate_urls_serialize_not_corrupt(tmp_path):
    urls, data = _shards(tmp_path, 1)

    async def main():
        daemon = _port_daemon(tmp_path)
        await daemon.start()
        try:
            pf = ShardPrefetcher(daemon, [urls[0], urls[0]], depth=2)
            out = [a async for a in pf.astream()]
            assert len(out) == 2
            assert all(isinstance(t, torch.Tensor) for a in out for t in a)
            for arrays in out:
                assert _reassemble(arrays)[:len(data[0])] == data[0]
        finally:
            await daemon.stop()

    asyncio.run(main())


def test_sync_without_loop_raises():
    pf = ShardPrefetcher(None, [])
    with pytest.raises(RuntimeError):
        iter(pf).__next__()

