"""The port's http(s):// origin client against a standard-library origin.

* The reference's ``TestHTTPClient`` cases (``tests/test_source.py``):
  metadata and a whole download, a ranged download, the HEAD fallback to a
  ranged GET, an unknown length, 404; each run through the port.
* The rules the reference takes from aiohttp, held here on the standard
  library: a redirect, ``Retry-After`` on 503, a chunked body with no
  length, a HEAD the origin rejects, 401/403, probes kept out of the
  keep-alive pool, and the TLS settings.
* A port daemon's back-source pull from an ``http://`` URL lands the same
  bytes and piece metadata (task id, piece size and count, crc32c piece
  digests with both native libraries built, sha256) as the reference's
  daemon pulling the same origin.

Tolerances are exact. Every test runs under ``asyncio.wait_for``.
"""

import asyncio
import hashlib
import ssl

import numpy as np
import pytest

from dragonfly2_tpu.daemon import config as ref_dconfig
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.common.piece import Range
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.source import (SourceRequest, client_for,
                                         content_length, download)
from dragonfly2_tpu_torch.source.http_client import HTTPSourceClient
from test_torch_native import ref_native_lib  # noqa: F401 - fixture
from torch_origin import Origin

LIMIT_S = 20.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _data(n: int, seed: int = 1) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def test_registry_dispatch():
    assert type(client_for("http://x/y")) is HTTPSourceClient
    assert client_for("https://x/y") is client_for("http://x/y")
    assert client_for("file:///tmp/x").__class__.__name__ == \
        "FileSourceClient"
    with pytest.raises(DFError):
        client_for("weird://x")


class TestHTTPClient:
    """The reference's five cases, through the port."""

    def test_metadata_and_download(self):
        data = _data(50_000)

        async def go(base):
            url = f"{base}/f.bin"
            assert await content_length(SourceRequest(url=url)) == len(data)
            assert await client_for(url).supports_range(SourceRequest(url=url))
            resp = await download(SourceRequest(url=url))
            assert await resp.read_all() == data
        with Origin({"f.bin": data}) as o:
            run(go(o.base))

    def test_ranged_download(self):
        data = _data(50_000)

        async def go(base):
            resp = await download(SourceRequest(url=f"{base}/f",
                                                range=Range(1000, 2000)))
            assert resp.status == 206
            assert await resp.read_all() == data[1000:3000]
            assert resp.total_length == len(data)
            assert resp.content_length == 2000
        with Origin({"f": data}) as o:
            run(go(o.base))

    def test_head_fallback_to_ranged_get(self):
        data = _data(10_000)

        async def go(base):
            n = await content_length(SourceRequest(url=f"{base}/f"))
            assert n == len(data)
        with Origin({"f": data}, no_head=True) as o:
            run(go(o.base))

    def test_unknown_length(self):
        data = _data(10_000)

        async def go(base):
            resp = await download(SourceRequest(url=f"{base}/f"))
            assert resp.content_length == -1
            assert await resp.read_all() == data
        with Origin({"f": data}, no_length=True) as o:
            run(go(o.base))

    def test_404(self):
        async def go(base):
            with pytest.raises(DFError) as ei:
                await download(SourceRequest(url=f"{base}/x"))
            assert ei.value.code == Code.SOURCE_NOT_FOUND
        with Origin({"y": b""}) as o:
            run(go(o.base))


def test_redirect_is_followed():
    data = _data(70_000)

    async def go(base):
        url = f"{base}/redirect/f.bin"
        assert await content_length(SourceRequest(url=url)) == len(data)
        resp = await download(SourceRequest(url=url, range=Range(5, 100)))
        assert resp.status == 206
        assert await resp.read_all() == data[5:105]
    with Origin({"f.bin": data}) as o:
        run(go(o.base))
        assert [p for _m, p, _r in o.requests].count("/f.bin") == 2


def test_retry_after_on_503_and_auth_codes():
    async def go(base):
        with pytest.raises(DFError) as ei:
            await download(SourceRequest(url=f"{base}/busy"))
        assert ei.value.code == Code.SOURCE_ERROR
        assert ei.value.retry_after_ms == 2000
        with pytest.raises(DFError) as ei:
            await content_length(SourceRequest(url=f"{base}/forbidden"))
        assert ei.value.code == Code.SOURCE_AUTH_ERROR
    with Origin({}) as o:
        run(go(o.base))


def test_chunked_body_with_no_length_streams_in_bounded_chunks():
    data = _data(3 * (1 << 20) + 12345)

    async def go(base):
        resp = await download(SourceRequest(url=f"{base}/big"))
        sizes, out = [], bytearray()
        async for chunk in resp.chunks:
            sizes.append(len(chunk))
            out.extend(chunk)
        assert bytes(out) == data
        assert max(sizes) <= 1 << 20
    with Origin({"big": data}, no_length=True, chunk=300_000) as o:
        run(go(o.base))


def test_rejected_head_probes_with_a_ranged_get():
    """HEAD answers 405: length and range support come from a
    ``bytes=0-0`` GET's ``Content-Range``."""
    data = _data(123_457)

    async def go(base):
        req = SourceRequest(url=f"{base}/f")
        assert await content_length(req) == len(data)
        assert await client_for(req.url).supports_range(req)
        resp = await download(req)
        assert await resp.read_all() == data
    with Origin({"f": data}, no_head=True) as o:
        run(go(o.base))
        probes = [r for m, _p, r in o.requests if m == "GET" and r]
        assert probes and all(r == "bytes=0-0" for r in probes)


def test_probes_stay_out_of_the_pool_and_downloads_reuse_it():
    data = _data(40_000)
    client = HTTPSourceClient()

    async def go(base):
        url = f"{base}/f"
        await client.content_length(SourceRequest(url=url))
        assert not any(client._pool().values())
        for _ in range(3):
            resp = await client.download(SourceRequest(url=url))
            assert await resp.read_all() == data
        (idle,) = [c for c in client._pool().values() if c]
        assert len(idle) == 1      # one keep-alive connection, reused
        await client.close()
    with Origin({"f": data}) as o:
        run(go(o.base))


def test_set_tls():
    client = HTTPSourceClient()
    assert client._ssl is None
    client.set_tls(insecure=True)
    assert client._ssl.verify_mode == ssl.CERT_NONE
    assert not client._ssl.check_hostname
    client.set_tls()
    assert client._ssl is None
    with pytest.raises(FileNotFoundError):
        client.set_tls(ca_file="/nonexistent/ca.pem")


def _holding(storage_mgr, task_id: str) -> dict:
    ts = storage_mgr.get(task_id)
    with open(ts.data_path(), "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    return {"task_id": task_id, "piece_size": ts.md.piece_size,
            "pieces": ts.md.total_piece_count,
            "content_length": ts.md.content_length,
            "digests": {n: p.digest for n, p in ts.md.pieces.items()},
            "sha256": sha}


def test_daemon_http_pull_matches_reference(tmp_path, ref_native_lib):
    data = _data(9 * (1 << 20) + 4321, seed=5)

    async def pull(daemon, msg, url: str) -> str:
        task_id = None
        async for resp in daemon.ptm.start_file_task(msg.DownloadRequest(
                url=url, output=str(tmp_path / f"out-{id(daemon)}"),
                timeout_s=LIMIT_S)):
            task_id = resp.task_id or task_id
        return task_id

    async def port(url: str) -> dict:
        d = Daemon(DaemonConfig(workdir=str(tmp_path / "port"),
                                hostname="port", listen_ip="127.0.0.1",
                                host_ip="127.0.0.1", device="cpu"))
        await d.start()
        try:
            task_id = await pull(d, port_msg, url)
            c = d.ptm.conductor(task_id)
            assert c.traffic_source == len(data)
            summary = c.flight.summarize()
            assert summary["bytes_source"] == len(data)
            assert summary["rungs"] == ["back_source"]
            return _holding(d.storage_mgr, task_id)
        finally:
            await d.stop()

    async def ref(url: str) -> dict:
        d = RefDaemon(ref_dconfig.DaemonConfig(
            workdir=str(tmp_path / "ref"), host_ip="127.0.0.1",
            hostname="ref",
            storage=ref_dconfig.StorageSection(gc_interval_s=3600)))
        await d.start()
        try:
            task_id = await pull(d, ref_msg, url)
            return _holding(d.storage_mgr, task_id)
        finally:
            await d.stop()

    with Origin({"w.bin": data}) as o:
        url = f"{o.base}/w.bin"
        got = run(port(url))
        assert o.body_bytes == len(data)
        want = run(ref(url))
    assert got == want
    assert got["content_length"] == len(data) and got["pieces"] == 3
    assert all(d.startswith("crc32c:") for d in got["digests"].values())


def test_daemon_pulls_an_origin_with_no_length_as_the_reference(
        tmp_path, ref_native_lib):
    """A chunked origin with no ``Content-Length``: both daemons stream it
    to its end, cut 4 MiB pieces with a short last one, and learn the
    total at the end; the same bytes, piece count and piece metadata
    (crc32c digests, offsets, sizes). A manifest device sink needs the
    length up front, so neither daemon builds one: the pull lands on disk
    only, and the flight names the back-source rung."""
    data = _data(9 * (1 << 20) + 777, seed=8)
    manifest = [dict(name="head", range_start=0, range_size=1 << 20,
                     dtype="uint8"),
                dict(name="tail", range_start=8 << 20, range_size=1 << 20,
                     dtype="uint8")]

    def pieces(storage_mgr, task_id: str) -> list:
        md = storage_mgr.get(task_id).md
        return [(p.num, p.start, p.size, p.digest)
                for p in sorted(md.pieces.values(), key=lambda p: p.num)]

    async def pull(daemon, msg, url: str) -> dict:
        task_id = None
        async for resp in daemon.ptm.start_file_task(msg.DownloadRequest(
                url=url, output=str(tmp_path / f"out-{id(daemon)}"),
                timeout_s=LIMIT_S,
                device_sink=msg.DeviceSink(enabled=True),
                shard_manifest=msg.ShardManifest(
                    shards=[msg.ShardInfo(**s) for s in manifest]))):
            task_id = resp.task_id or task_id
        c = daemon.ptm.conductor(task_id)
        assert c.device_ingest is None
        assert c.traffic_source == len(data)
        out = (tmp_path / f"out-{id(daemon)}").read_bytes()
        return {**_holding(daemon.storage_mgr, task_id),
                "pieces_meta": pieces(daemon.storage_mgr, task_id),
                "total_pieces": c.total_pieces, "out": out,
                "rungs": c.flight.summarize()["rungs"]}

    async def port(url: str) -> dict:
        d = Daemon(DaemonConfig(workdir=str(tmp_path / "port"),
                                hostname="port", listen_ip="127.0.0.1",
                                host_ip="127.0.0.1", device="cpu"))
        await d.start()
        try:
            return await pull(d, port_msg, url)
        finally:
            await d.stop()

    async def ref(url: str) -> dict:
        d = RefDaemon(ref_dconfig.DaemonConfig(
            workdir=str(tmp_path / "ref"), host_ip="127.0.0.1",
            hostname="ref",
            storage=ref_dconfig.StorageSection(gc_interval_s=3600)))
        await d.start()
        try:
            return await pull(d, ref_msg, url)
        finally:
            await d.stop()

    # HEAD refused and ranges unsupported: the probe's GET is chunked too
    with Origin({"w.bin": data}, no_length=True, no_head=True,
                support_range=False) as o:
        url = f"{o.base}/w.bin"
        got = run(port(url))
        want = run(ref(url))
    assert got == want
    assert got["out"] == data
    assert got["content_length"] == len(data)
    assert got["pieces"] == got["total_pieces"] == 3
    assert [p[2] for p in got["pieces_meta"]] == [4 << 20, 4 << 20, 777 + (1 << 20)]
    assert got["rungs"] == ["back_source"]
    assert all(p[3].startswith("crc32c:") for p in got["pieces_meta"])
