"""The port's device sink and daemon on a CUDA card.

Every test here needs a card: each is marked ``gpu`` and skips (from the
``cuda`` fixture, never at import) where none is present. The file imports
only torch, numpy and the port, so it also runs where JAX is not
installed::

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import asyncio
import hashlib

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.daemon.config import DaemonConfig, SchedulerConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import (DeviceSink, DownloadRequest,
                                               ShardInfo, ShardManifest,
                                               UrlMeta)
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig as \
    SchedCfg
from dragonfly2_tpu_torch.scheduler.config import SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.tpu.hbm_sink import DeviceIngest


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _seeded(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.gpu
def test_whole_file_shuffled_pieces(cuda):
    raw = _seeded(3_000_001)
    ingest = DeviceIngest(len(raw), devices=[cuda], shards_per_device=4)
    assert ingest.host.is_pinned()
    piece = 250_000
    order = np.random.default_rng(1).permutation(-(-len(raw) // piece))
    for p in order:
        ingest.write(int(p) * piece, raw[int(p) * piece:(int(p) + 1) * piece])
    arrays = ingest.result(timeout=60)
    assert len(arrays) == 4
    assert all(a.device == cuda and a.dtype == torch.uint8 for a in arrays)
    flat = torch.cat(arrays).cpu().numpy()
    assert flat[:len(raw)].tobytes() == raw
    assert not flat[len(raw):].any()
    assert len(ingest.transfer_spans) == 4


@pytest.mark.gpu
def test_manifest_dtypes_shapes_and_bytes(cuda):
    raw = _seeded(1 << 20, seed=2)
    specs = [("w", 0, 4096 * 2, "bfloat16", [64, 64]),
             ("b", 10_000, 4 * 100, "float32", [100]),
             ("q", 20_001, 999, "int8", None)]
    ingest = DeviceIngest(len(raw), devices=[cuda], shard_specs=specs)
    for off in range(0, len(raw), 65536):
        ingest.write(off, raw[off:off + 65536])
    out = ingest.result(timeout=60)
    want = {"w": torch.bfloat16, "b": torch.float32, "q": torch.int8}
    for name, start, size, _dt, shape in specs:
        t = out[name]
        assert t.device == cuda and t.dtype == want[name]
        assert list(t.shape) == (shape or [size])
        got = t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
        assert got == raw[start:start + size]


@pytest.mark.gpu
def test_result_usable_on_another_stream(cuda):
    raw = _seeded(1 << 20, seed=3)
    ingest = DeviceIngest(len(raw), devices=[cuda])
    ingest.write(0, raw)
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        (arr,) = ingest.result(timeout=60)
        total = arr.to(torch.int64).sum()
    side.synchronize()
    assert int(total) == int(np.frombuffer(raw, np.uint8).sum(dtype=np.int64))


@pytest.mark.gpu
def test_default_devices_are_cuda(cuda):
    ingest = DeviceIngest(1000)
    assert all(d.type == "cuda" for d in ingest.devices)
    ingest.write(0, bytes(1000))
    arrays = ingest.result(timeout=60)
    assert all(a.device.type == "cuda" for a in arrays)


@pytest.mark.gpu
def test_daemon_pull_lands_on_card(cuda, tmp_path):
    raw = _seeded(40 << 20, seed=4)       # above the piece-group threshold
    path = tmp_path / "ckpt.bin"
    path.write_bytes(raw)
    digest = "sha256:" + hashlib.sha256(raw).hexdigest()
    manifest = ShardManifest(shards=[
        ShardInfo(name="emb", range_start=0, range_size=32 << 20,
                  dtype="bfloat16", shape=[4096, 4096]),
        ShardInfo(name="norm", range_start=(32 << 20) + 8, range_size=8192,
                  dtype="bfloat16", shape=[4096])])

    async def main():
        daemon = Daemon(DaemonConfig(workdir=str(tmp_path / "d")))
        await daemon.start()
        try:
            out = {}
            for tag, man in (("m", manifest), ("f", None)):
                task_id = None
                async for r in daemon.ptm.start_file_task(DownloadRequest(
                        url=f"file://{path}",
                        url_meta=UrlMeta(digest=digest, tag=tag),
                        device_sink=DeviceSink(enabled=True),
                        shard_manifest=man)):
                    task_id = r.task_id
                ingest = daemon.ptm.conductor(task_id).device_ingest
                assert ingest is not None
                out[tag] = await asyncio.to_thread(ingest.result, 60)
            return out
        finally:
            await daemon.stop()

    out = asyncio.run(main())
    for info in manifest.shards:
        t = out["m"][info.name]
        assert t.device == cuda and t.dtype == torch.bfloat16
        got = t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
        assert got == raw[info.range_start:info.range_start + info.range_size]
    flat = torch.cat(out["f"])
    assert all(a.device == cuda for a in out["f"])
    assert flat[:len(raw)].cpu().numpy().tobytes() == raw


@pytest.mark.gpu
def test_p2p_pull_from_a_seed_lands_on_card(cuda, tmp_path):
    """Two daemons and a scheduler: the leecher, with back-source off,
    takes every piece from the seed's upload server into cuda:0."""
    raw = _seeded(24 << 20, seed=5)
    path = tmp_path / "ckpt.bin"
    path.write_bytes(raw)
    manifest = ShardManifest(shards=[
        ShardInfo(name="w", range_start=0, range_size=16 << 20,
                  dtype="bfloat16", shape=[2048, 4096]),
        ShardInfo(name="b", range_start=(16 << 20) + 64,
                  range_size=4 << 20, dtype="float32", shape=[1 << 20])])

    async def main():
        seed = Daemon(DaemonConfig(workdir=str(tmp_path / "seed"),
                                   hostname="seed", is_seed=True,
                                   listen_ip="127.0.0.1",
                                   host_ip="127.0.0.1"))
        await seed.start()
        sched = Scheduler(SchedCfg(listen_ip="127.0.0.1", seed_peers=[
            SeedPeerAddr(host_id=seed.host_info().id, ip="127.0.0.1",
                         rpc_port=seed.rpc.port,
                         download_port=seed.upload_server.port)]))
        await sched.start()
        leecher = Daemon(DaemonConfig(
            workdir=str(tmp_path / "leecher"), hostname="leecher",
            listen_ip="127.0.0.1", host_ip="127.0.0.1",
            scheduler=SchedulerConfig(addresses=[sched.address])))
        await leecher.start()
        try:
            task_id = None
            async for r in leecher.ptm.start_file_task(DownloadRequest(
                    url=f"file://{path}", disable_back_source=True,
                    device_sink=DeviceSink(enabled=True),
                    shard_manifest=manifest, timeout_s=120)):
                task_id = r.task_id
            c = leecher.ptm.conductor(task_id)
            assert c.traffic_p2p == len(raw) and c.traffic_source == 0
            return await asyncio.to_thread(c.device_ingest.result, 60)
        finally:
            await leecher.stop()
            await sched.stop()
            await seed.stop()

    out = asyncio.run(asyncio.wait_for(main(), 180))
    for info, dtype in zip(manifest.shards, (torch.bfloat16, torch.float32)):
        t = out[info.name]
        assert t.device == cuda and t.dtype == dtype
        assert list(t.shape) == list(info.shape)
        got = t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
        assert got == raw[info.range_start:info.range_start + info.range_size]
