"""Recursive downloads, against the reference.

* The local API's recursive ``Download`` (the reference's
  ``tests/test_daemon_e2e.py::TestRecursiveDownload``) on a ``file://``
  tree, through each package's daemon: one done frame per file, the
  mirror equal to the tree.
* ``DaemonService._download_recursive`` over a recording task manager,
  in both packages: each leaf's request (digest and range dropped, the
  device sink, back-source, task type, rate and offset fields carried,
  the output mirrored), at most ``recursive_concurrency`` leaves in
  flight, the first leaf error raised once the walk ends, the producer
  and its leaves cancelled when the client goes, and an empty ``output``
  joined as the reference joins it (a path relative to the daemon's
  working directory).
* The published checkpoint layout from a GCS stand-in
  (``chip_smoke.GCSStandIn``) with a CPU device sink: back to source
  through one daemon of each package, then through a scheduler, a seed
  and two leechers of each package, where the second leecher's registers
  take the scheduler's ``EMPTY`` (zero-byte) and ``SMALL`` (one-piece)
  branches. Each leaf's sink bytes equal its object's in both packages;
  a zero-byte leaf finishes with no sink and an empty file.
* A ``source.fetch`` fault on one leaf ends both packages' streams with
  the same code.
* ``dfget --recursive`` (the reference's ``TestDfgetRecursiveFallback``)
  with and without a daemon, through both packages' CLIs.
* ``chip_smoke.py`` phase 22 rehearsed on the CPU at a 16 MB weights
  file.

Tolerances are exact.
"""

import asyncio
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.common import faultgate as ref_faultgate
from dragonfly2_tpu.daemon import config as ref_config
from dragonfly2_tpu.daemon import rpcserver as ref_rpcserver
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.rpc.client import Channel as RefChannel
from dragonfly2_tpu.rpc.client import ServiceClient as RefServiceClient
from dragonfly2_tpu.scheduler import Scheduler as RefScheduler
from dragonfly2_tpu.scheduler import SchedulerConfig as RefSchedulerConfig
from dragonfly2_tpu.scheduler.config import SeedPeerAddr as RefSeedPeerAddr
from dragonfly2_tpu.source import client as ref_client
from dragonfly2_tpu.tools import dfget as ref_dfget
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.common import faultgate as port_faultgate
from dragonfly2_tpu_torch.common.metrics import REGISTRY
from dragonfly2_tpu_torch.daemon import rpcserver as port_rpcserver
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.rpc import Channel, ServiceClient
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.source import client as port_client
from dragonfly2_tpu_torch.tools import dfget as port_dfget
import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 60.0
TREE_URL = f"gs://{chip_smoke.TREE_BUCKET}/{chip_smoke.TREE_PREFIX}"


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _file_tree(root) -> dict[str, bytes]:
    """The reference's ``TestRecursiveDownload`` tree, seeded."""
    files = {"a.bin": _bytes(50_000, 1), "b.txt": b"hello",
             "sub/c.bin": _bytes(20_000, 2)}
    for rel, data in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
    return files


def _ref_cfg(tmp_path, name: str, **kw):
    cfg = ref_config.DaemonConfig(
        workdir=str(tmp_path / f"r-{name}"), host_ip="127.0.0.1",
        hostname=f"r-{name}",
        storage=ref_config.StorageSection(gc_interval_s=3600))
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _port_cfg(tmp_path, name: str, **kw) -> DaemonConfig:
    return DaemonConfig(workdir=str(tmp_path / f"p-{name}"),
                        hostname=f"p-{name}", listen_ip="127.0.0.1",
                        host_ip="127.0.0.1", device="cpu", **kw)


PKG = {
    "reference": (ref_msg, RefDaemon, _ref_cfg, RefChannel,
                  RefServiceClient),
    "port": (port_msg, Daemon, _port_cfg, Channel, ServiceClient),
}


def _mirror(out) -> dict[str, bytes]:
    return {os.path.relpath(os.path.join(dp, fn), out): open(
        os.path.join(dp, fn), "rb").read()
        for dp, _d, fns in os.walk(out) for fn in fns}


async def _recursive(daemon, pkg: str, req_fields: dict) -> list:
    """A recursive ``Download`` over the daemon's unix socket; the done
    frames, or the stream's error code."""
    msg, _d, _c, channel, client_cls = PKG[pkg]
    ch = channel(f"unix:{daemon.unix_sock}")
    client = client_cls(ch, "df.daemon.Daemon")
    dones = []
    try:
        async for resp in client.unary_stream("Download", msg.DownloadRequest(
                recursive=True, **req_fields)):
            if resp.done:
                dones.append(resp)
    except Exception as exc:  # noqa: BLE001 - either package's DFError
        return ["error", exc.code.name, len(dones)]
    finally:
        await ch.close()
    return dones


# ---------------------------------------------------------------- file tree

@pytest.mark.parametrize("pkg", PKG)
def test_recursive_directory_via_daemon(tmp_path, pkg):
    """``TestRecursiveDownload``: three files, three done frames, the
    mirror equal to the tree."""
    files = _file_tree(tmp_path / "tree")
    _msg, daemon_cls, cfg, _ch, _cl = PKG[pkg]
    out = tmp_path / "mirror"

    async def go():
        d = daemon_cls(cfg(tmp_path, "d1"))
        await d.start()
        try:
            return await _recursive(d, pkg, {
                "url": f"file://{tmp_path / 'tree'}", "output": str(out)})
        finally:
            await d.stop()

    dones = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
    assert sorted(os.path.relpath(r.output, out) for r in dones) == \
        sorted(files)
    assert sorted(r.completed_length for r in dones) == \
        sorted(len(v) for v in files.values())
    assert _mirror(out) == files


# ------------------------------------------------- the recursion's contract

class _RecordingManager:
    """A task manager whose file task records its request, waits
    ``delay_s``, and ends with a done frame or, for the leaf named
    ``fail``, raises the package's DFError."""

    def __init__(self, msg, err_cls, delay_s: float = 0.05,
                 fail: str = ""):
        self.msg, self.err_cls = msg, err_cls
        self.delay_s, self.fail = delay_s, fail
        self.requests, self.cancelled = [], []
        self.active = self.peak = 0

    async def start_file_task(self, req):
        self.requests.append(req)
        self.active += 1
        self.peak = max(self.peak, self.active)
        try:
            await asyncio.sleep(self.delay_s)
            if self.fail and req.url.endswith(self.fail):
                from importlib import import_module
                code = import_module(
                    self.err_cls.__module__).Code.SOURCE_NOT_FOUND
                raise self.err_cls(code, f"no {self.fail}")
            yield self.msg.DownloadResponse(
                task_id=req.url, completed_length=1, content_length=1,
                done=True, output=req.output)
        except asyncio.CancelledError:
            self.cancelled.append(req.url)
            raise
        finally:
            self.active -= 1


SERVICES = {
    "reference": (ref_rpcserver, ref_msg, "dragonfly2_tpu"),
    "port": (port_rpcserver, port_msg, "dragonfly2_tpu_torch"),
}


def _service(pkg: str, **kw):
    mod, msg, top = SERVICES[pkg]
    err = __import__(f"{top}.common.errors", fromlist=["DFError"]).DFError
    ptm = _RecordingManager(msg, err, **kw)
    return mod.DaemonService(ptm), ptm, msg


def _leaf_fields(req, out: str) -> tuple:
    meta = req.url_meta
    return (os.path.relpath(req.output, out) if out else req.output,
            meta.digest, meta.range, meta.tag,
            tuple(sorted((meta.header or {}).items())),
            req.timeout_s, req.disable_back_source,
            req.device_sink.enabled if req.device_sink else None,
            int(req.task_type), req.rate_limit_bps,
            req.keep_original_offset, req.recursive)


def test_leaf_requests_carry_the_reference_fields(tmp_path):
    """Digest and range dropped from each leaf's meta; the device sink,
    back-source, task type, rate, offset, timeout and origin headers
    carried; the output mirrored; at most ``recursive_concurrency`` in
    flight."""
    files = _file_tree(tmp_path / "tree")
    for i in range(5):
        (tmp_path / "tree" / f"more-{i}.bin").write_bytes(b"m" * i)
    out = str(tmp_path / "mirror")
    got = {}
    for pkg in SERVICES:
        svc, ptm, msg = _service(pkg)
        req = msg.DownloadRequest(
            url=f"file://{tmp_path / 'tree'}", output=out, recursive=True,
            recursive_concurrency=2, timeout_s=9.0, rate_limit_bps=1234,
            disable_back_source=True, keep_original_offset=True,
            task_type=msg.TaskType.PERSISTENT,
            device_sink=msg.DeviceSink(enabled=True),
            url_meta=msg.UrlMeta(digest="sha256:" + "0" * 64,
                                 range="bytes=0-9", tag="t",
                                 header={"X-Origin": "v"}))

        async def go():
            return [r.output async for r in svc.download(req, None)]

        outputs = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
        got[pkg] = (sorted(_leaf_fields(r, out) for r in ptm.requests),
                    ptm.peak, sorted(os.path.relpath(o, out)
                                     for o in outputs))
    assert got["port"] == got["reference"]
    leaves, peak, outputs = got["port"]
    assert peak == 2 and len(leaves) == len(files) + 5
    assert outputs == sorted(list(files) + [f"more-{i}.bin"
                                            for i in range(5)])
    assert {leaf[1:] for leaf in leaves} == {
        ("", "", "t", (("X-Origin", "v"),), 9.0, True, True, 1, 1234, True,
         False)}


def test_the_first_leaf_error_ends_the_stream_after_the_walk(tmp_path):
    _file_tree(tmp_path / "tree")
    got = {}
    for pkg in SERVICES:
        svc, ptm, msg = _service(pkg, fail="b.txt")
        req = msg.DownloadRequest(url=f"file://{tmp_path / 'tree'}",
                                  output=str(tmp_path / "o"), recursive=True)

        async def go():
            outs = []
            try:
                async for r in svc.download(req, None):
                    outs.append(os.path.basename(r.output))
            except Exception as exc:  # noqa: BLE001
                return sorted(outs), exc.code.name, exc.message
            return sorted(outs), None, None

        got[pkg] = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
    assert got["port"] == got["reference"] == (
        ["a.bin", "c.bin"], "SOURCE_NOT_FOUND", "no b.txt")


def test_a_client_that_goes_cancels_the_producer_and_its_leaves(tmp_path):
    _file_tree(tmp_path / "tree")
    for i in range(6):
        (tmp_path / "tree" / f"slow-{i}.bin").write_bytes(b"s")
    got = {}
    for pkg in SERVICES:
        svc, ptm, msg = _service(pkg, delay_s=0.3)
        req = msg.DownloadRequest(url=f"file://{tmp_path / 'tree'}",
                                  output=str(tmp_path / "o"), recursive=True,
                                  recursive_concurrency=3)

        async def go():
            stream = svc.download(req, None)
            first = await stream.__anext__()
            await stream.aclose()          # the client went
            await asyncio.sleep(0.05)
            return first.done, ptm.active, len(ptm.cancelled)

        done, active, cancelled = asyncio.run(asyncio.wait_for(go(),
                                                               LIMIT_S))
        got[pkg] = (done, active, cancelled > 0)
    assert got["port"] == got["reference"] == (True, 0, True)


def test_an_empty_output_is_joined_as_the_reference_joins_it(tmp_path,
                                                            monkeypatch):
    """``os.path.join("", rel)``: each leaf's output is its relative path,
    which the daemon resolves against its own working directory."""
    files = _file_tree(tmp_path / "tree")
    got = {}
    for pkg in PKG:
        cwd = tmp_path / f"cwd-{pkg}"
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        _msg, daemon_cls, cfg, _ch, _cl = PKG[pkg]

        async def go():
            d = daemon_cls(cfg(tmp_path, f"empty-{pkg}"))
            await d.start()
            try:
                return await _recursive(d, pkg, {
                    "url": f"file://{tmp_path / 'tree'}", "output": ""})
            finally:
                await d.stop()

        dones = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
        got[pkg] = (sorted(r.output for r in dones), _mirror(cwd))
    assert got["port"] == got["reference"]
    assert got["port"] == (sorted(files), files)


# ---------------------------------------------------------------- gcs tree

def _gcs_tree(tmp_path, weights_bytes: int = 9 << 20) -> tuple:
    """The published layout (``chip_smoke.hf_tree``) over a seeded
    weights file, served by a started ``GCSStandIn``; returns the stand-in
    and each object's bytes."""
    weights = tmp_path / "weights.safetensors"
    weights.write_bytes(_bytes(weights_bytes, 7))
    root = tmp_path / "gcs"
    sizes = chip_smoke.hf_tree(str(root / chip_smoke.TREE_BUCKET),
                               str(weights))
    base = root / chip_smoke.TREE_BUCKET / chip_smoke.TREE_PREFIX
    objects = {rel: (base / rel).read_bytes() for rel in sizes}
    store = chip_smoke.GCSStandIn(str(root))
    store.start()
    return store, objects


def _gcs_env(monkeypatch, store) -> None:
    monkeypatch.setenv("DF_GCS_ENDPOINT",
                       f"http://127.0.0.1:{store._server.server_address[1]}")
    monkeypatch.setenv("GOOGLE_APPLICATION_TOKEN", store.token)


def _sink_bytes(pkg: str, c) -> bytes | None:
    """A completed leaf's device-sink bytes (None: no sink was built)."""
    ingest = c.device_ingest
    if ingest is None:
        return None
    out = ingest.result(30)
    if pkg == "port":
        return torch.cat([t.reshape(-1) for t in out]).numpy().tobytes()[
            :c.content_length]
    return b"".join(np.asarray(a).reshape(-1).view(np.uint8).tobytes()
                    for a in out)[:c.content_length]


def _leaf_rows(pkg: str, daemon, dones, out) -> dict:
    rows = {}
    for r in dones:
        c = daemon.ptm.conductor(r.task_id)
        rows[os.path.relpath(r.output, out)] = {
            "task_id": r.task_id, "length": c.content_length,
            "pieces": c.total_pieces, "source": c.traffic_source,
            "p2p": c.traffic_p2p, "sink": _sink_bytes(pkg, c)}
    return rows


def test_gcs_tree_back_to_source_into_a_cpu_sink(tmp_path, monkeypatch):
    """One daemon of each package pulls the tree back to source with a
    device sink: the same task ids and leaves, each sink's bytes equal to
    its object, the zero-byte leaf with no sink."""
    store, objects = _gcs_tree(tmp_path)
    _gcs_env(monkeypatch, store)
    got = {}
    try:
        for pkg in PKG:
            msg, daemon_cls, cfg, _ch, _cl = PKG[pkg]
            out = tmp_path / f"mirror-{pkg}"

            async def go():
                d = daemon_cls(cfg(tmp_path, f"gcs-{pkg}"))
                await d.start()
                try:
                    dones = await _recursive(d, pkg, {
                        "url": TREE_URL, "output": str(out),
                        "device_sink": msg.DeviceSink(enabled=True)})
                    assert not (dones and dones[0] == "error"), dones
                    return await asyncio.to_thread(_leaf_rows, pkg, d,
                                                   dones, out)
                finally:
                    await d.stop()
                    await ref_client.close_clients()
                    await port_client.close_clients()

            got[pkg] = (asyncio.run(asyncio.wait_for(go(), LIMIT_S)),
                        _mirror(out))
    finally:
        store.stop()
    assert got["port"] == got["reference"]
    rows, mirror = got["port"]
    assert mirror == objects
    for rel, data in objects.items():
        assert rows[rel]["sink"] == (data or None), rel
        assert rows[rel]["source"] == len(data)


def _port_pod(tmp_path):
    seed = Daemon(_port_cfg(tmp_path, "seed", is_seed=True))

    async def start():
        await seed.start()
        sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1", seed_peers=[
            SeedPeerAddr(host_id=seed.host_info().id, ip="127.0.0.1",
                         rpc_port=seed.rpc.port,
                         download_port=seed.upload_server.port)]))
        await sched.start()
        leechers = [Daemon(_port_cfg(
            tmp_path, n, scheduler=DaemonSched(addresses=[sched.address])))
            for n in ("l1", "l2")]
        return seed, sched, leechers
    return start


def _ref_pod(tmp_path):
    async def start():
        seed = RefDaemon(_ref_cfg(tmp_path, "seed", is_seed=True))
        await seed.start()
        sched = RefScheduler(RefSchedulerConfig(seed_peers=[RefSeedPeerAddr(
            ip="127.0.0.1", rpc_port=seed.rpc.port,
            download_port=seed.upload_server.port)]))
        await sched.start()
        leechers = [RefDaemon(_ref_cfg(
            tmp_path, n, scheduler=ref_config.SchedulerConfig(
                addresses=[sched.address], schedule_timeout_s=20.0)))
            for n in ("l1", "l2")]
        return seed, sched, leechers
    return start


def test_gcs_tree_through_a_pod_with_empty_and_one_piece_leaves(
        tmp_path, monkeypatch):
    """A scheduler, a seed reading the stand-in, and two leechers with
    back-source disabled and CPU sinks, in each package. The first
    leecher's registers meet unknown lengths; the second's take the
    ``EMPTY`` branch for the zero-byte leaf and ``SMALL`` for the
    one-piece ones. Each leaf lands from peers with its object's bytes;
    the zero-byte leaf finishes with no sink, on both leechers."""
    store, objects = _gcs_tree(tmp_path)
    _gcs_env(monkeypatch, store)
    registers = REGISTRY.counter("df_sched_register_total",
                                 labels=("scope",))
    got = {}
    try:
        for pkg, pod in (("port", _port_pod(tmp_path)),
                         ("reference", _ref_pod(tmp_path))):
            msg = PKG[pkg][0]

            async def go():
                seed, sched, leechers = await pod()
                rows = []
                empty0 = registers.value("EMPTY")
                try:
                    for d in leechers:
                        await d.start()
                    for i, d in enumerate(leechers):
                        out = tmp_path / f"{pkg}-l{i + 1}"
                        dones = await _recursive(d, pkg, {
                            "url": TREE_URL, "output": str(out),
                            "disable_back_source": True,
                            "device_sink": msg.DeviceSink(enabled=True)})
                        assert not (dones and dones[0] == "error"), dones
                        rows.append((await asyncio.to_thread(
                            _leaf_rows, pkg, d, dones, out), _mirror(out)))
                finally:
                    for d in leechers:
                        await d.stop()
                    await sched.stop()
                    await seed.stop()
                    await ref_client.close_clients()
                    await port_client.close_clients()
                return rows, registers.value("EMPTY") - empty0

            got[pkg] = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
        stats = store.stats()
    finally:
        store.stop()
    port_rows, empties = got["port"]
    ref_rows, _ = got["reference"]
    assert port_rows == ref_rows
    assert empties == 1                      # the second leecher's register
    for rows, mirror in port_rows:
        assert mirror == objects
        for rel, data in objects.items():
            assert rows[rel]["sink"] == (data or None), rel
            assert rows[rel]["source"] == 0 and rows[rel]["p2p"] == len(data)
    # each pod's seed read every object once; the walkers listed twice
    # each; the media went to the seeds alone
    assert sum(stats["media_bytes"].values()) == \
        2 * sum(len(v) for v in objects.values())
    assert stats["listings"] == 8


# ---------------------------------------------------------------- faults

def test_a_failing_leaf_ends_both_streams_with_the_same_code(tmp_path):
    """``source.fetch@<one leaf's url>=fail`` on every attempt: the stream
    ends with the leaf's code in both packages, after the other leaves'
    done frames."""
    _file_tree(tmp_path / "tree")
    leaf = f"file://{tmp_path / 'tree' / 'sub' / 'c.bin'}"
    got = {}
    for pkg, fg in (("reference", ref_faultgate), ("port", port_faultgate)):
        _msg, daemon_cls, cfg, _ch, _cl = PKG[pkg]
        fg.arm_script(f"source.fetch@{leaf}=fail:n=-1")

        async def go():
            d = daemon_cls(cfg(tmp_path, f"fault-{pkg}"))
            await d.start()
            try:
                return await _recursive(d, pkg, {
                    "url": f"file://{tmp_path / 'tree'}",
                    "output": str(tmp_path / f"out-{pkg}")})
            finally:
                await d.stop()

        try:
            got[pkg] = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
        finally:
            fg.reset()
    assert got["port"] == got["reference"]
    assert got["port"][:2] == ["error", "UNAVAILABLE"]


# ---------------------------------------------------------------- dfget

DFGET = {"reference": ref_dfget, "port": port_dfget}


@pytest.mark.parametrize("pkg", PKG)
@pytest.mark.parametrize("daemon", [False, True],
                         ids=["no-daemon", "daemon"])
def test_dfget_recursive_mirrors_a_tree(tmp_path, pkg, daemon, capsys):
    """``TestDfgetRecursiveFallback`` (``--no-daemon``), and the same
    through a running daemon's socket: one line per file and a total."""
    src = tmp_path / "tree"
    (src / "deep").mkdir(parents=True)
    files = {"one.bin": _bytes(30_000, 3), "deep/two.bin": _bytes(10_000, 4)}
    for rel, data in files.items():
        (src / rel).write_bytes(data)
    out = tmp_path / "mirror"
    argv = [f"file://{src}", "-O", str(out), "--recursive"]
    if not daemon:
        assert DFGET[pkg].main(argv + ["--no-daemon", "--quiet"]) == 0
        assert _mirror(out) == files
        return
    _msg, daemon_cls, cfg, _ch, _cl = PKG[pkg]
    ready, stop = threading.Event(), threading.Event()
    box = {}

    def serve():
        async def main():
            d = daemon_cls(cfg(tmp_path, f"dfget-{pkg}"))
            await d.start()
            box["sock"] = d.unix_sock
            ready.set()
            try:
                while not stop.is_set():
                    await asyncio.sleep(0.02)
            finally:
                await d.stop()
        asyncio.run(main())

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        assert ready.wait(LIMIT_S)
        assert DFGET[pkg].main(argv + ["--daemon-sock", box["sock"]]) == 0
    finally:
        stop.set()
        t.join(LIMIT_S)
    printed = capsys.readouterr().out.splitlines()
    assert len([ln for ln in printed if ln.startswith("dfget: [")]) == 2
    assert printed[-1].startswith("dfget: 2 files, ")
    assert _mirror(out) == files


# ---------------------------------------------------------------- phase 22

def test_phase_22_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_tree`` at a 16 MB weights file with CPU sinks:
    the stand-in in a child, the scheduler and seed in another, L1's
    recursive ``Download``, the ``dfget --recursive`` process on L2, and
    dfcache's round trip, with every check of the phase."""
    real_run = subprocess.run

    def fake_run(args, *a, **kw):
        if args and args[0] == "nvidia-smi":
            return subprocess.CompletedProcess(args, 0,
                                               "CPU rehearsal, 0 W\n", "")
        return real_run(args, *a, **kw)

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    monkeypatch.setitem(chip_smoke.LLAMA3_8B, "vocab", 2000)
    monkeypatch.setattr(sys, "path", [ROOT, *sys.path])
    os.makedirs(tmp_path / "deploy")
    header, nbytes = chip_smoke.safetensors_header(chip_smoke.deploy_layout())
    with open(tmp_path / "deploy" / chip_smoke.TREE_WEIGHTS, "wb") as f:
        f.write(header)
        f.write(memoryview(chip_smoke.seeded_bytes(
            np.random.default_rng(0), nbytes)))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit",
                        lambda phase, rec: lines.append((phase, rec)))
    chip_smoke.phase_tree(str(tmp_path), torch.device("cpu"))
    (phase, rec), = lines
    assert phase == "phase 22 tree"
    assert rec["leaves"] == 5 and rec["media_bytes"] == rec["bytes"]
    assert rec["listing_requests"] == 4 and rec["unauthorized"] == 1
    assert set(rec["l1_ready_s"]) == {
        "config.json", "original/params.json", ".gitattributes",
        "model.safetensors.index.json", chip_smoke.TREE_WEIGHTS}
    assert not os.path.exists(tmp_path / "tree")
    assert os.environ.get("DF_GCS_ENDPOINT") is None or \
        "127.0.0.1" not in os.environ["DF_GCS_ENDPOINT"]
