"""The slice end to end: one daemon pulls a task back to source into its
device sink, through the JAX package and through the port, compared with
zero tolerance.

Both daemons pull the same seeded ``file://`` origin with a ``sha256``
digest; every message is built from one field dict through each package's
own message classes. JAX runs on its 8 CPU devices (``tests/conftest.py``);
the port runs with ``device="cpu"`` and ``pipeline_shards=8``, which gives
the same shard geometry on one CPU device.
"""

import asyncio
import builtins
import hashlib
import time

import numpy as np
import pytest

import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.common import faultgate as ref_faultgate
from dragonfly2_tpu.common.errors import DFError as RefDFError
from dragonfly2_tpu.daemon import config as ref_config
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.tpu import topology as ref_topology
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.common import faultgate as port_faultgate
from dragonfly2_tpu_torch.common.errors import Code
from dragonfly2_tpu_torch.common.errors import DFError as PortDFError
from dragonfly2_tpu_torch.common.piece import INGEST_DMA_UNIT_BYTES
from dragonfly2_tpu_torch.daemon.config import DaemonConfig, DownloadConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.tpu import topology as port_topology

MiB = 1 << 20


def _origin(tmp_path, n: int, seed: int) -> tuple[str, bytes, str]:
    data = np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    path = tmp_path / f"origin-{seed}.bin"
    path.write_bytes(data)
    return f"file://{path}", data, "sha256:" + hashlib.sha256(data).hexdigest()


def _daemons(tmp_path, **download):
    ref = RefDaemon(ref_config.DaemonConfig(
        workdir=str(tmp_path / "ref"), host_ip="127.0.0.1", hostname="ref",
        storage=ref_config.StorageSection(gc_interval_s=3600),
        download=ref_config.DownloadConfig(**download)))
    port = Daemon(DaemonConfig(workdir=str(tmp_path / "port"),
                               hostname="port", device="cpu",
                               download=DownloadConfig(**download)))
    return ref, port


async def _pull(daemon, msg, fields: dict):
    """One file task through ``daemon``; returns (conductor, sink result or
    None). ``fields`` is one dict both packages' messages are built from."""
    shards = fields.get("shards")
    req = msg.DownloadRequest(
        url=fields["url"], output=fields.get("output", ""),
        url_meta=msg.UrlMeta(**fields.get("meta", {})),
        device_sink=msg.DeviceSink(**fields["sink"]),
        shard_manifest=(msg.ShardManifest(
            shards=[msg.ShardInfo(**s) for s in shards]) if shards else None),
        timeout_s=60.0)
    task_id = None
    async for resp in daemon.ptm.start_file_task(req):
        task_id = resp.task_id or task_id
    conductor = daemon.ptm.conductor(task_id)
    ingest = conductor.device_ingest
    out = await asyncio.to_thread(ingest.result, 30) if ingest else None
    return conductor, out


def _both(tmp_path, fields_ref: dict, fields_port: dict, **download):
    async def main():
        ref, port = _daemons(tmp_path, **download)
        await ref.start()
        await port.start()
        try:
            return (await _pull(ref, ref_msg, fields_ref),
                    await _pull(port, port_msg, fields_port))
        finally:
            await port.stop()
            await ref.stop()

    return asyncio.run(main())


def _jax_bytes(a) -> bytes:
    return np.asarray(a).reshape(-1).view(np.uint8).tobytes()


def _torch_bytes(t) -> bytes:
    import torch
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("group_min", [32 * MiB, 1 * MiB],
                         ids=["one-stream", "piece-groups"])
def test_whole_file_parity(tmp_path, group_min):
    url, data, digest = _origin(tmp_path, 9 * MiB + 12345, seed=1)
    common = {"url": url, "meta": {"digest": digest}}
    (rc, rout), (pc, pout) = _both(
        tmp_path,
        {**common, "sink": {"enabled": True},
         "output": str(tmp_path / "ref.out")},
        {**common, "sink": {"enabled": True, "pipeline_shards": 8},
         "output": str(tmp_path / "port.out")},
        back_source_group_min_bytes=group_min)
    assert rc.task_id == pc.task_id
    assert (pc.piece_size, pc.total_pieces) == (rc.piece_size, rc.total_pieces)
    assert pc.state == rc.state == "success"
    assert len(pout) == len(rout) == 8
    for p, r in zip(pout, rout):
        assert _torch_bytes(p) == _jax_bytes(r)
    assert b"".join(_torch_bytes(p) for p in pout)[:len(data)] == data
    assert (tmp_path / "port.out").read_bytes() == data


def test_manifest_parity(tmp_path):
    url, data, digest = _origin(tmp_path, 6 * MiB + 24, seed=2)
    shards = [
        {"name": "embed", "range_start": 24, "range_size": 1024 * 1024 * 2,
         "dtype": "bfloat16", "shape": [1024, 1024]},
        {"name": "proj", "range_start": 24 + 2 * MiB,
         "range_size": 512 * 1024 * 4, "dtype": "float32",
         "shape": [512, 1024]},
        # a gap before it, and a range straddling the piece boundary
        {"name": "q8", "range_start": 4 * MiB + 100, "range_size": 5000,
         "dtype": "int8", "shape": [50, 100]},
        {"name": "raw", "range_start": 5 * MiB, "range_size": 777},
    ]
    fields = {"url": url, "meta": {"digest": digest},
              "sink": {"enabled": True}, "shards": shards}
    (rc, rout), (pc, pout) = _both(tmp_path, fields, fields)
    assert (pc.piece_size, pc.total_pieces) == (rc.piece_size, rc.total_pieces)
    assert list(pout) == list(rout) == [s["name"] for s in shards]
    for s in shards:
        p, r = pout[s["name"]], rout[s["name"]]
        assert str(p.dtype) == f"torch.{r.dtype}"
        assert tuple(p.shape) == tuple(r.shape)
        lo = s["range_start"]
        assert _torch_bytes(p) == _jax_bytes(r) == data[lo:lo + s["range_size"]]


def test_digest_mismatch_same_code(tmp_path):
    url, _data, _digest = _origin(tmp_path, 3 * MiB, seed=3)
    wrong = "sha256:" + "0" * 64
    codes = []

    async def main():
        ref, port = _daemons(tmp_path)
        await ref.start()
        await port.start()
        try:
            for daemon, msg, err in ((ref, ref_msg, RefDFError),
                                     (port, port_msg, PortDFError)):
                with pytest.raises(err) as exc:
                    await _pull(daemon, msg, {"url": url,
                                              "meta": {"digest": wrong},
                                              "sink": {"enabled": True}})
                codes.append(int(exc.value.code))
        finally:
            await port.stop()
            await ref.stop()

    asyncio.run(main())
    assert codes[0] == codes[1] == int(Code.CLIENT_DIGEST_MISMATCH)


def test_faultgate_disables_sink_file_completes(tmp_path):
    """A raising ``hbm.ingest`` script: the sink is disabled and the task
    finishes to disk, in both packages."""
    url, data, digest = _origin(tmp_path, 5 * MiB, seed=4)
    ref_faultgate.arm("hbm.ingest", "fail", n=1)
    port_faultgate.arm("hbm.ingest", "fail", n=1)
    try:
        (rc, rout), (pc, pout) = _both(
            tmp_path,
            {"url": url, "meta": {"digest": digest},
             "sink": {"enabled": True}, "output": str(tmp_path / "r.out")},
            {"url": url, "meta": {"digest": digest},
             "sink": {"enabled": True}, "output": str(tmp_path / "p.out")})
    finally:
        ref_faultgate.reset()
        port_faultgate.reset()
    assert rout is None and pout is None
    assert rc.device_ingest is None and pc.device_ingest is None
    assert rc.state == pc.state == "success"
    assert (tmp_path / "r.out").read_bytes() == data
    assert (tmp_path / "p.out").read_bytes() == data


def test_auto_pipeline_shards_rule(tmp_path):
    """Bytes per device over the copy unit, clamped to 1..32 — the same
    count per device as the reference's rule over its 8 devices."""
    ref, port = _daemons(tmp_path)
    for per_dev in (1000, 70 * MiB, 200 * MiB):
        ours = port.device_sink_builder(port_msg.DeviceSink(enabled=True))(
            per_dev)
        theirs = ref.device_sink_builder(ref_msg.DeviceSink(enabled=True))(
            8 * per_dev)
        try:
            assert ours.shards_per_device == theirs.shards_per_device == \
                max(1, min(32, per_dev // INGEST_DMA_UNIT_BYTES))
        finally:
            ours.close()
            theirs.close()


@pytest.mark.parametrize("state", ["ok", "error", "timeout"])
def test_probe_states_match_reference(state, monkeypatch, tmp_path):
    """Both probes report the same state under the same runtime condition:
    answering, failing to import, hanging in initialisation."""
    for mod in (ref_topology, port_topology):
        monkeypatch.setattr(mod, "_local_probe_hung", False)
        monkeypatch.setattr(mod, "_runtime_ok", mod._runtime_ok)
    monkeypatch.setattr(ref_topology, "_wedge_cache_path",
                        lambda: str(tmp_path / "ref-wedge"))
    monkeypatch.setattr(port_topology, "_wedge_cache_path",
                        lambda: str(tmp_path / "port-wedge"))
    real_import = builtins.__import__

    def hooked(name, *a, **kw):
        if name in ("jax", "torch"):
            if state == "error":
                raise ImportError(f"{name} broken (test)")
            if state == "timeout":
                time.sleep(5)
        return real_import(name, *a, **kw)

    if state != "ok":
        monkeypatch.setattr(builtins, "__import__", hooked)
    timeout = 0.3 if state == "timeout" else 60
    got = [ref_topology.probe_jax_devices(timeout_s=timeout),
           port_topology.probe_cuda_devices(timeout_s=timeout)]
    monkeypatch.setattr(builtins, "__import__", real_import)
    assert [g[0] for g in got] == [state, state]
    if state == "ok":
        assert got[1][1][0] == got[1][1][2]   # every counted device is CUDA


@pytest.mark.parametrize("name", ["UrlMeta", "PieceInfo", "ShardInfo",
                                  "ShardManifest", "DeviceSink",
                                  "DownloadRequest", "DownloadResponse"])
def test_message_fields_match_reference(name):
    """Same field names, order and defaults: one field dict builds either
    package's message."""
    import dataclasses

    def shape(cls):
        out = []
        for f in dataclasses.fields(cls):
            default = (f.default if f.default is not dataclasses.MISSING
                       else f.default_factory())
            out.append((f.name, default))
        return out

    assert shape(getattr(port_msg, name)) == shape(getattr(ref_msg, name))
