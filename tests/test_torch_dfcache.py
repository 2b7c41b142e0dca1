"""dfcache and the local API's ``ImportTask`` / ``ExportTask``, against the
reference.

* The CLI (the reference's ``tests/test_aux.py::TestDfcacheCLI``):
  ``import``, ``stat``, ``export``, ``delete`` and a ``stat`` that exits 1
  after the delete, each its own process against a daemon of the same
  package; the JSON lines equal between the packages. ``import`` without
  ``-I`` and ``export`` without ``-O`` exit 2.
* The RPCs in-process: ``ImportTask`` answers the reference's
  ``TaskStat``; ``ExportTask`` copies a locally completed task out, with
  ``local_only`` and no local copy answers ``NOT_FOUND``, and otherwise
  runs a file task; ``DeleteTask`` then ``StatTask`` is ``NOT_FOUND``.

Tolerances are exact.
"""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.daemon import config as ref_config
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.rpc.client import Channel as RefChannel
from dragonfly2_tpu.rpc.client import ServiceClient as RefServiceClient
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.rpc import Channel, ServiceClient
from dragonfly2_tpu_torch.tools import dfcache as port_dfcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 60.0
MODULE = {"reference": "dragonfly2_tpu.tools.dfcache",
          "port": "dragonfly2_tpu_torch.tools.dfcache"}


def _daemon(pkg: str, tmp_path, name: str):
    if pkg == "reference":
        return RefDaemon(ref_config.DaemonConfig(
            workdir=str(tmp_path / name), host_ip="127.0.0.1", hostname=name,
            storage=ref_config.StorageSection(gc_interval_s=3600)))
    return Daemon(DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                               host_ip="127.0.0.1", device="cpu"))


def _cli(pkg: str, sock: str, *args) -> tuple[int, str, str]:
    r = subprocess.run(
        [sys.executable, "-m", MODULE[pkg], *args, "--daemon-sock", sock],
        capture_output=True, text=True, timeout=LIMIT_S, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"})
    return r.returncode, r.stdout, r.stderr


@pytest.mark.parametrize("pkg", MODULE)
def test_dfcache_cli_round_trip(tmp_path, pkg):
    """``TestDfcacheCLI``: import, stat, export (bytes equal), delete, and
    a stat after the delete exiting 1 with NOT_FOUND."""
    payload = np.random.default_rng(3).integers(
        0, 256, 200_000, dtype=np.uint8).tobytes()
    src, out = tmp_path / "seed.bin", tmp_path / "back.bin"
    src.write_bytes(payload)

    async def go():
        d = _daemon(pkg, tmp_path, "cached")
        await d.start()
        try:
            steps = []
            for args in (("import", "w1", "-I", str(src)), ("stat", "w1"),
                         ("export", "w1", "-O", str(out)),
                         ("delete", "w1"), ("stat", "w1"),
                         ("import", "w2"), ("export", "w2")):
                steps.append(await asyncio.to_thread(_cli, pkg, d.unix_sock,
                                                     *args))
            return steps
        finally:
            await d.stop()

    steps = asyncio.run(asyncio.wait_for(go(), 6 * LIMIT_S))
    (imp, stat, exp, dele, gone, no_in, no_out) = steps
    assert imp[0] == 0 and json.loads(imp[1])["content_length"] == \
        len(payload), imp
    assert stat[0] == 0 and json.loads(stat[1]) == {
        "id": json.loads(imp[1])["id"], "state": "success",
        "content_length": len(payload), "pieces": 1}
    assert exp[0] == 0 and json.loads(exp[1]) == {"exported": str(out)}
    assert out.read_bytes() == payload
    assert dele[0] == 0 and json.loads(dele[1]) == {"deleted": "w1"}
    assert gone[0] == 1 and gone[2].startswith("dfcache: NOT_FOUND: ")
    assert no_in[:2] == (2, "") and "import requires -I" in no_in[2]
    assert no_out[:2] == (2, "") and "export requires -O" in no_out[2]


def test_dfcache_parser_is_the_references():
    from dragonfly2_tpu.tools import dfcache as ref_dfcache
    p, r = port_dfcache.build_parser(), ref_dfcache.build_parser()
    assert p.prog == r.prog
    assert [(a.option_strings, a.dest, a.default, a.choices)
            for a in p._actions] == [(a.option_strings, a.dest, a.default,
                                      a.choices) for a in r._actions]
    assert port_dfcache.cache_url("x") == ref_dfcache.cache_url("x") == \
        "cache://local/x"


PKG = {"reference": (ref_msg, RefChannel, RefServiceClient),
       "port": (port_msg, Channel, ServiceClient)}


def test_import_and_export_tasks_answer_as_the_reference(tmp_path):
    data = np.random.default_rng(5).integers(0, 256, 5 << 20,
                                             dtype=np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    origin = tmp_path / "origin.bin"
    origin.write_bytes(data[:300_000])
    got = {}
    for pkg, (msg, channel, client_cls) in PKG.items():
        async def go():
            d = _daemon(pkg, tmp_path, f"rpc-{pkg}")
            await d.start()
            ch = channel(f"unix:{d.unix_sock}")
            c = client_cls(ch, "df.daemon.Daemon")
            out = {}

            async def call(method, req):
                try:
                    return await c.unary(method, req, timeout=LIMIT_S)
                except Exception as exc:  # noqa: BLE001 - either DFError
                    return exc.code.name

            try:
                url, meta = "cache://local/m", msg.UrlMeta(tag="t")
                stat = await call("ImportTask", msg.ImportTaskRequest(
                    path=str(src), url=url, url_meta=meta))
                out["import"] = (stat.id, int(stat.type),
                                 stat.content_length, stat.total_piece_count,
                                 stat.state, stat.has_available_peer)
                exp = tmp_path / f"{pkg}-exported.bin"
                out["export"] = type(await call(
                    "ExportTask", msg.ExportTaskRequest(
                        url=url, output=str(exp), url_meta=meta,
                        local_only=True))).__name__
                out["exported"] = exp.read_bytes() == data
                out["not_local"] = await call(
                    "ExportTask", msg.ExportTaskRequest(
                        url=f"file://{origin}", output=str(exp),
                        local_only=True))
                pulled = tmp_path / f"{pkg}-pulled.bin"
                out["file_task"] = type(await call(
                    "ExportTask", msg.ExportTaskRequest(
                        url=f"file://{origin}", output=str(pulled),
                        timeout_s=30.0))).__name__
                out["pulled"] = pulled.read_bytes() == data[:300_000]
                await call("DeleteTask", msg.DeleteTaskRequest(
                    url=url, url_meta=meta))
                out["gone"] = await call("StatTask", msg.StatTaskDaemonRequest(
                    url=url, url_meta=meta))
            finally:
                await ch.close()
                await d.stop()
            return out

        got[pkg] = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
    assert got["port"] == got["reference"]
    imp = got["port"]["import"]
    assert imp[1:] == (1, 5 << 20, 2, "success", True)
    assert got["port"]["export"] == "Empty" and got["port"]["exported"]
    assert got["port"]["not_local"] == "NOT_FOUND"
    assert got["port"]["file_task"] == "Empty" and got["port"]["pulled"]
    assert got["port"]["gone"] == "NOT_FOUND"
