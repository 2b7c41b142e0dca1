"""The port's device sink, daemon and trainer on a CUDA card.

Every test here needs a card: each is marked ``gpu`` and skips (from the
``cuda`` fixture, never at import) where none is present. The file imports
only torch, numpy and the port, so it also runs where JAX is not
installed::

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import argparse
import asyncio
import functools
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.daemon.config import DaemonConfig, SchedulerConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import (DeviceSink, DownloadRequest,
                                               ShardInfo, ShardManifest,
                                               UrlMeta)
from dragonfly2_tpu_torch.manager import Manager, ManagerConfig
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig as \
    SchedCfg
from dragonfly2_tpu_torch.scheduler.config import SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.tpu.hbm_sink import DeviceIngest
from dragonfly2_tpu_torch.tools import dfbench
from dragonfly2_tpu_torch.trainer import (features, models, pipeline, ranks,
                                          training)
from dragonfly2_tpu_torch.trainer.server import Trainer, TrainerConfig


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
def test_subset_sink_pins_only_requested_bytes(cuda):
    """A sink built with a shard subset pins the specs' bytes, rounded up
    as the host allocator rounds a block (the next power of two), not the
    content, and returns CUDA tensors of the requested shards. A 1-byte
    pinned buffer of ``Tensor.item()``, returned to the allocator during
    the sink's allocation, must not show in its count."""
    raw = _seeded(48 << 20, seed=6)
    specs = [("w", 8 << 20, 3 << 20, "bfloat16", [1024, 1536]),
             ("b", (8 << 20) + (3 << 20), 4 * 1000, "float32", [1000]),
             ("t", 40 << 20, (1 << 20) + 123, "uint8", None)]
    staged = (3 << 20) + 4000 + (1 << 20) + 123
    # what came before the sink on the card: Tensor.item() calls and a
    # pinned block of the same size, used for a copy and freed
    x = torch.ones(4, dtype=torch.uint8, device=cuda)
    x[0].item(), x.float().sum().item()
    h = torch.empty(staged, dtype=torch.uint8, pin_memory=True)
    h.to(cuda, non_blocking=True)
    torch.cuda.synchronize()
    del h
    ingest = DeviceIngest(len(raw), devices=[cuda], shard_specs=specs)
    assert ingest.host.is_pinned() and ingest.host.numel() == staged
    assert ingest.pinned_bytes == 1 << (staged - 1).bit_length() == 8 << 20
    piece = 4 << 20
    for off in range(0, len(raw), piece):        # a widened download
        ingest.write(off, raw[off:off + piece])
    out = ingest.result(timeout=60)
    assert list(out) == ["w", "b", "t"]
    for name, start, size, _dt, _shape in specs:
        t = out[name]
        assert t.device == cuda
        assert t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes() \
            == raw[start:start + size]


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


@pytest.mark.gpu
def test_an_mtls_pull_from_a_seed_lands_on_card(cuda, tmp_path):
    """Fleet mTLS: a manager issues the certificates; the seed and the
    leecher enroll with ``security.enabled`` and the scheduler with its
    issuance token, so the seed trigger, the sync stream and every piece
    GET ride mutual TLS; the leecher's pull lands on cuda:0."""
    from dragonfly2_tpu_torch.daemon.config import SecurityConfig

    raw = _seeded(24 << 20, seed=6)
    path = tmp_path / "ckpt.bin"
    path.write_bytes(raw)
    manifest = ShardManifest(shards=[
        ShardInfo(name="w", range_start=0, range_size=16 << 20,
                  dtype="bfloat16", shape=[2048, 4096])])

    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    workdir=str(tmp_path / "mgr"),
                                    issue_certs=True))
        await mgr.start()
        sec = SecurityConfig(enabled=True, issue_token=mgr.issue_token)
        addrs = [f"127.0.0.1:{mgr.port}"]
        seed = Daemon(DaemonConfig(workdir=str(tmp_path / "seed"),
                                   hostname="seed", is_seed=True,
                                   listen_ip="127.0.0.1",
                                   host_ip="127.0.0.1",
                                   manager_addresses=addrs, security=sec))
        await seed.start()
        sched = Scheduler(SchedCfg(
            listen_ip="127.0.0.1", manager_addresses=addrs,
            security_issue_token=mgr.issue_token,
            workdir=str(tmp_path / "sched"), statestore_handoff=False,
            seed_peers=[SeedPeerAddr(host_id=seed.host_info().id,
                                     ip="127.0.0.1", rpc_port=seed.rpc.port,
                                     download_port=seed.upload_server.port)]))
        await sched.start()
        leecher = Daemon(DaemonConfig(
            workdir=str(tmp_path / "leecher"), hostname="leecher",
            listen_ip="127.0.0.1", host_ip="127.0.0.1",
            manager_addresses=addrs, security=sec,
            scheduler=SchedulerConfig(addresses=[sched.address])))
        await leecher.start()
        try:
            assert sched.seed_client._channels.tls_cert
            task_id = None
            async for r in leecher.ptm.start_file_task(DownloadRequest(
                    url=f"file://{path}", disable_back_source=True,
                    device_sink=DeviceSink(enabled=True),
                    shard_manifest=manifest, timeout_s=120)):
                task_id = r.task_id
            c = leecher.ptm.conductor(task_id)
            assert c.traffic_p2p == len(raw) and c.traffic_source == 0
            assert leecher._downloader.scheme == "https"
            return await asyncio.to_thread(c.device_ingest.result, 60)
        finally:
            await leecher.stop()
            await sched.stop()
            await seed.stop()
            await mgr.stop()

    out = asyncio.run(asyncio.wait_for(main(), 180))
    t = out["w"]
    assert t.device == cuda and t.dtype == torch.bfloat16
    assert t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes() == \
        raw[:16 << 20]


@pytest.mark.gpu
def test_a_gateway_object_prefetched_onto_the_card_equals_its_bytes(
        cuda, tmp_path):
    """An object PUT through a seed's object gateway (a file:// bucket) is
    prefetched by a leecher, back-source off, through ``ShardPrefetcher``
    under the gateway's task meta: its bytes on cuda:0 are the object's,
    every one from the seed."""
    from dragonfly2_tpu_torch.daemon.config import ObjectStorageConfig
    from dragonfly2_tpu_torch.tools.dfstore import Dfstore
    from dragonfly2_tpu_torch.tpu.data import ShardPrefetcher

    raw = _seeded(20 << 20, seed=16)
    src = tmp_path / "shard.tar"
    src.write_bytes(raw)
    bucket = tmp_path / "bucket"
    bucket.mkdir()

    async def main():
        seed = Daemon(DaemonConfig(
            workdir=str(tmp_path / "seed"), hostname="seed", is_seed=True,
            listen_ip="127.0.0.1", host_ip="127.0.0.1",
            object_storage=ObjectStorageConfig(
                enabled=True, buckets={"data": f"file://{bucket}"})))
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
        store = Dfstore(f"http://127.0.0.1:{seed.object_gateway.port}")
        try:
            await store.put_object("data", "train/shard-0.tar", str(src))
            url = seed.object_gateway._object_url("data",
                                                  "train/shard-0.tar")
            pf = ShardPrefetcher(leecher, [url],
                                 url_meta=UrlMeta(tag="objstore"),
                                 disable_back_source=True,
                                 delete_after=False)
            got = [arrays async for arrays in pf.astream()]
            task_id = leecher.ptm._task_id(url, UrlMeta(tag="objstore"))
            c = leecher.ptm.conductor(task_id)
            return got, c.traffic_p2p, c.traffic_source
        finally:
            await store.close()
            await leecher.stop()
            await sched.stop()
            await seed.stop()

    got, p2p, src_bytes = asyncio.run(asyncio.wait_for(main(), 180))
    assert len(got) == 1 and all(a.device == cuda for a in got[0])
    flat = torch.cat(got[0])
    assert flat[:len(raw)].cpu().numpy().tobytes() == raw
    assert (p2p, src_bytes) == (len(raw), 0)


@pytest.mark.gpu
def test_a_preheated_file_pulled_from_the_seed_lands_on_the_card(
        cuda, tmp_path):
    """A REST preheat job of the manager warms a file into a seed whose
    sink is the CPU; the origin file is then removed, and a leecher that
    knows only the manager pulls it with back-source off into cuda:0: its
    bytes are the origin's, every one from the seed."""
    import urllib.request

    raw = _seeded(24 << 20, seed=20)
    path = tmp_path / "ckpt.bin"
    path.write_bytes(raw)
    url = f"file://{path}"

    def rest(port: int, route: str, body: dict | None = None) -> dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{route}",
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1"))
        await mgr.start()
        seed = Daemon(DaemonConfig(
            workdir=str(tmp_path / "seed"), hostname="seed", is_seed=True,
            listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
            manager_addresses=[mgr.address]))
        await seed.start()
        sched = Scheduler(SchedCfg(listen_ip="127.0.0.1",
                                   manager_addresses=[mgr.address]))
        await sched.start()
        leecher = None
        try:
            job_id = (await asyncio.to_thread(
                rest, mgr.rest.port, "/api/v1/jobs",
                {"type": "preheat", "args": {"url": url}}))["id"]
            for _ in range(600):
                job = await asyncio.to_thread(rest, mgr.rest.port,
                                              f"/api/v1/jobs/{job_id}")
                if job["state"] in ("succeeded", "failed"):
                    break
                await asyncio.sleep(0.1)
            assert job["state"] == "succeeded", job
            path.unlink()
            leecher = Daemon(DaemonConfig(
                workdir=str(tmp_path / "leecher"), hostname="leecher",
                listen_ip="127.0.0.1", host_ip="127.0.0.1",
                manager_addresses=[mgr.address]))
            await leecher.start()
            task_id = None
            async for r in leecher.ptm.start_file_task(DownloadRequest(
                    url=url, disable_back_source=True,
                    device_sink=DeviceSink(enabled=True), timeout_s=120)):
                task_id = r.task_id
            (entry,) = job["result"].values()
            assert entry["task_id"] == task_id
            c = leecher.ptm.conductor(task_id)
            assert c.traffic_p2p == len(raw) and c.traffic_source == 0
            return await asyncio.to_thread(c.device_ingest.result, 60)
        finally:
            if leecher is not None:
                await leecher.stop()
            await sched.stop()
            await seed.stop()
            await mgr.stop()

    out = asyncio.run(asyncio.wait_for(main(), 180))
    assert all(a.device == cuda for a in out)
    flat = torch.cat(out)
    assert flat[:len(raw)].cpu().numpy().tobytes() == raw


@pytest.mark.gpu
def test_a_blob_pulled_through_a_hijacking_proxy_lands_on_the_card(
        cuda, tmp_path):
    """A registry blob over TLS (``chip_smoke.RegistryStandIn``), pulled
    with ``http.client`` through a daemon's CONNECT with ``proxy.hijack``
    and copied to cuda:0 through a pinned buffer on a side stream, equals
    its bytes; the leaf names the CONNECT host, and the stand-in served
    the blob once."""
    import chip_smoke
    from dragonfly2_tpu_torch.daemon.config import (DownloadConfig,
                                                    ProxyConfig)

    raw = _seeded(12 << 20, seed=17)
    digest = "sha256:" + hashlib.sha256(raw).hexdigest()
    blob = tmp_path / "blob"
    blob.write_bytes(raw)
    reg = chip_smoke.RegistryStandIn(str(tmp_path / "registry"),
                                     {digest: str(blob)}, b"{}")
    port = reg.start()

    async def main():
        d = Daemon(DaemonConfig(
            workdir=str(tmp_path / "d"), hostname="proxyd",
            listen_ip="127.0.0.1", host_ip="127.0.0.1",
            download=DownloadConfig(source_ca=reg.ca_path),
            proxy=ProxyConfig(enabled=True, hijack=True)))
        await d.start()
        client = chip_smoke.OCIClient(
            "connect", ("127.0.0.1", d.proxy_server.port),
            f"https://127.0.0.1:{port}", ca=d.proxy_server.ca_cert_path,
            device=cuda)

        def fetch():
            resp = client.request(f"/v2/repo/blobs/{digest}")
            assert resp.status == 200
            return client._layer(resp, len(raw))

        try:
            return await asyncio.to_thread(fetch), client.peer_sans
        finally:
            client.close()
            await d.stop()

    try:
        (host, card), sans = asyncio.run(asyncio.wait_for(main(), 120))
        served = reg.stats()["served"]
    finally:
        reg.stop()
    assert host.is_pinned() and card.device == cuda
    assert card.cpu().numpy().tobytes() == raw
    assert sans == [["127.0.0.1"]]
    assert served == {digest: len(raw)}


def _mlp_rows(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, features.FEATURE_DIM)) * [1, 1, 1, 1, 1, 64, 4]
    cost = 10 ** rng.uniform(0, 3, n)
    return [{"kind": "piece", "features": row.tolist(),
             "label": features.label_from_cost(4 << 20, float(c))}
            for row, c in zip(x, cost)]


def _topo_rows(seed: int, hosts: int, links: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < links:
        a, b = (int(v) for v in rng.integers(0, hosts, 2))
        if a != b:
            pairs.add((a, b))
    # every host appears, so the graph fills the 1024-node bucket
    return [{"src": f"host-{a:04d}", "dst": f"host-{b:04d}",
             "avg_rtt_us": float(10 ** rng.uniform(1, 4)), "count": 3}
            for a, b in sorted(pairs)]


@pytest.mark.gpu
def test_mlp_fits_on_card_are_byte_identical(cuda):
    rows = _mlp_rows(0, 6000)
    a = training.train_mlp(rows, epochs=20, seed=3, device=cuda)
    b = training.train_mlp(rows, epochs=20, seed=3)       # default: cuda:0
    assert a[0] == b[0] and a[1]["version"] == b[1]["version"]
    assert a[1]["final_loss"] < a[1]["first_epoch_loss"]
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.gpu
def test_gnn_fits_on_card_are_byte_identical_at_the_largest_buckets(cuda):
    topo = _topo_rows(1, 1024, 8192)
    a = training.train_gnn(topo, seed=5, device=cuda)
    b = training.train_gnn(topo, seed=5, device=cuda)
    assert a[1]["nodes"] == 1024 and a[1]["edges"] == 8192
    assert a[0] == b[0]
    assert a[1]["final_loss"] < a[1]["first_epoch_loss"]


def _learnable_rows(seed: int, n: int) -> list[dict]:
    """Labels that depend on the features, with noise: a fit converges to
    the noise floor, where a run's last bits no longer move its loss."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, features.FEATURE_DIM))
    y = 0.2 + 0.5 * x[:, 0] + 0.2 * x[:, 4] * x[:, 1] + rng.normal(0, 0.1, n)
    return [{"features": a.tolist(), "label": float(b)}
            for a, b in zip(x, y)]


@pytest.mark.gpu
def test_card_and_cpu_fits_agree(cuda):
    """Same rows, same seed (the same initial weights: the generator is on
    the CPU): the final losses agree within 1 %."""
    rows = _learnable_rows(2, 3000)
    on_card = training.train_mlp(rows, epochs=40, seed=1, device=cuda)[1]
    on_cpu = training.train_mlp(rows, epochs=40, seed=1, device="cpu")[1]
    assert abs(on_card["final_loss"] - on_cpu["final_loss"]) <= \
        0.01 * on_cpu["final_loss"]
    topo = _topo_rows(3, 256, 2048)
    g_card = training.train_gnn(topo, seed=2, device=cuda)[1]
    g_cpu = training.train_gnn(topo, seed=2, device="cpu")[1]
    assert abs(g_card["final_loss"] - g_cpu["final_loss"]) <= \
        0.01 * g_cpu["final_loss"]


@pytest.mark.gpu
def test_dfbench_pr19_fits_on_card_repeat(cuda, monkeypatch):
    """``dfbench --pr19`` on the card: its two seeded fits give the same
    blob bytes, its two learned legs the same schedule and decision
    digests, and every schedule digest is BENCH_pr19.json's."""
    blobs = []
    fit = pipeline.train_decision_model

    def recorded(rows, **kw):
        out = fit(rows, **kw)
        blobs.append(out[0])
        return out

    monkeypatch.setattr(pipeline, "train_decision_model", recorded)
    args = argparse.Namespace(seed=7, daemons=8, pieces=64,
                              piece_size=4 << 20, parallelism=4,
                              smoke=False, device="cuda")
    r = dfbench._run_pr19(args)
    assert len(blobs) == 2 and blobs[0] == blobs[1]
    assert r["fit"]["device"] == str(cuda)
    assert r["trained_deterministic"] and r["learned_deterministic"]
    assert r["ml_disarmed_pure"] and r["outcomes_pure"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCH_pr19.json")) as f:
        want = json.load(f)
    for key in ("schedule_digest", "learned_schedule_digest",
                "learned_decision_digest"):
        assert r[key] == want[key], key


@pytest.mark.gpu
def test_fit_without_a_visible_card_raises(cuda):
    """With the card hidden, ``train_mlp(device=None)`` raises rather than
    fitting on the CPU."""
    code = ("from dragonfly2_tpu_torch.trainer import training\n"
            "try:\n"
            "    training.train_mlp([{'features': [0.0] * 7, 'label': 0.5}]"
            " * 16, epochs=1)\n"
            "except RuntimeError as exc:\n"
            "    print('raised:', exc)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr
    assert "raised: no CUDA device" in proc.stdout


@pytest.mark.gpu
def test_trainer_on_card_publishes_and_scheduler_binds_it(cuda, tmp_path):
    """A trainer on the card, attached to a manager, publishes its fit;
    the scheduler's refresh binds the registry's version, which is the
    trainer's."""
    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1"))
        await mgr.start()
        trainer = Trainer(TrainerConfig(
            listen_ip="127.0.0.1", data_dir=str(tmp_path / "spool"),
            manager_addresses=[mgr.address]))
        await trainer.start()
        sched = Scheduler(SchedCfg(listen_ip="127.0.0.1", algorithm="ml",
                                   trainer_address=trainer.address,
                                   manager_addresses=[mgr.address]))
        await sched.start()
        try:
            assert trainer.service.device == cuda
            for row in _mlp_rows(4, 256):
                sched.service.records._append(row)
            assert await sched.announcer.upload_once()
            _, metrics = trainer.service.latest[features.MLP_MODEL_NAME]
            (listed,) = mgr.store.models(name=features.MLP_MODEL_NAME)
            assert listed["version"] == metrics["version"]
            assert await sched.announcer.refresh_model_once()
            assert sched.announcer.model_version == metrics["version"]
            assert sched.scheduling.evaluator.infer.version == \
                metrics["version"]
        finally:
            await sched.stop()
            await trainer.stop()
            await mgr.stop()

    asyncio.run(asyncio.wait_for(main(), 120))


@pytest.mark.gpu
def test_one_rank_nccl_step_equals_the_single_device_step(cuda,
                                                         monkeypatch):
    """The sharded step on a one-rank NCCL mesh (dp=1, tp=1, a spawned
    rank on card 0) gives each model the single-device step's loss and
    gradients on the same params and batch; ``train_mlp`` with the mesh
    default on one card reports one device."""
    from dragonfly2_tpu_torch import graft_entry
    monkeypatch.setattr(ranks, "run_ranks",
                        functools.partial(ranks.run_ranks, timeout_s=120))
    out = graft_entry.dryrun_multichip(1, device="cuda")
    assert out["mesh"] == {"dp": 1, "tp": 1}
    losses = {"mlp": models.mlp_loss, "gnn": models.gnn_loss}
    for name, (tree, batch) in graft_entry.dryrun_inputs().items():
        with training.fit_numerics():
            model = models.params_from_numpy(tree).to(cuda)
            step = models.make_train_step(losses[name],
                                          models.make_optimizer(model))
            loss = float(step(model, models.batch_to_device(batch, cuda)))
        assert out[name]["loss"] == pytest.approx(loss, rel=1e-6)
        grads = models.params_to_numpy(model, leaf=lambda d: {
            "b": d.b.grad.cpu().numpy(), "w": d.w.grad.cpu().numpy()})
        for got, want in zip(_leaves(out[name]["grads"]), _leaves(grads)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    rows = _mlp_rows(4, 256)
    blob, metrics = training.train_mlp(rows, epochs=5, seed=3)
    assert metrics["devices"] == 1
    assert blob == training.train_mlp(rows, epochs=5, seed=3,
                                      use_mesh=False)[0]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]
