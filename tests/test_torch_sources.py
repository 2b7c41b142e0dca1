"""The other origins and the walk, against the reference.

* ``memory://``: the reference's ``TestMemoryClient`` case, ranges, the
  prefix listing and the missing blob, through both packages' registries.
* ``gs://`` against standard-library stand-ins (the reference's
  ``TestGCSClient``): the media path with ``alt=media``, the ``Range``
  and the ``Authorization`` sent; the listing's ``items`` and
  ``prefixes`` as ``ListEntry``s, the metadata's ``updated`` as the
  last-modified time (``chip_smoke.GCSStandIn``, the card's phase 22
  stand-in); one listing page (``nextPageToken`` is not followed); a
  bucket-root URL refused with ``INVALID_ARGUMENT``.
* ``hdfs://`` (the reference's ``TestHDFSSource``): ``GETFILESTATUS``,
  ``OPEN`` with ``offset`` and ``length`` in the query and a 307 to a
  DataNode, a ranged answer as status 206 with an unknown total,
  ``LISTSTATUS``, ``user.name`` from ``DF_HDFS_USER``.
* ``oras://`` (the reference's ``TestORASSource``): the bearer challenge
  answered once, its comma-holding quoted scope kept whole; blob ranges;
  a registry answering a range with 200 refused; one manifest GET per
  download.
* ``walk``: the reference's three ``TestWalk`` cases, and trees over
  ``memory://``, ``gs://`` and ``http://``: both packages yield the same
  ``(url, relative path)`` sequence.
* The ``source.fetch`` faultgate site: a script keyed by one URL fails
  that URL's back-source pull alone, in both packages.

Every server is a ``ThreadingHTTPServer`` on a thread, so both packages'
HTTP clients (aiohttp in the reference, asyncio streams in the port) talk
to the same one. Tolerances are exact.
"""

import asyncio
import contextlib
import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

import dragonfly2_tpu.source as ref_source
from dragonfly2_tpu.common import faultgate as ref_faultgate
from dragonfly2_tpu.common.errors import DFError as RefDFError
from dragonfly2_tpu.common.piece import Range as RefRange
from dragonfly2_tpu.daemon import config as ref_config
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.idl import messages as ref_msg
from dragonfly2_tpu.source import client as ref_client
from dragonfly2_tpu.source import memory_client as ref_memory
import dragonfly2_tpu_torch.source as port_source
from dragonfly2_tpu_torch.common import faultgate as port_faultgate
from dragonfly2_tpu_torch.common.errors import Code
from dragonfly2_tpu_torch.common.errors import DFError as PortDFError
from dragonfly2_tpu_torch.common.piece import Range as PortRange
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl import messages as port_msg
from dragonfly2_tpu_torch.source import client as port_client
from dragonfly2_tpu_torch.source import memory_client as port_memory
import chip_smoke

LIMIT_S = 30.0
PKGS = {
    "reference": (ref_source, ref_client, RefRange, RefDFError),
    "port": (port_source, port_client, PortRange, PortDFError),
}


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _run(pkg: str, coro_fn):
    """``coro_fn(source, client_mod, Range, DFError)`` on a fresh loop,
    closing that loop's pooled origin connections after."""
    src, cli, rng, err = PKGS[pkg]

    async def main():
        try:
            return await asyncio.wait_for(coro_fn(src, cli, rng, err),
                                          LIMIT_S)
        finally:
            await cli.close_clients()
            # the reference's gs client keeps an HTTP client of its own
            # that ``close_clients`` does not reach
            await src.client_for("gs://b/o")._http.close()

    return asyncio.run(main())


def _entries(entries, host: str = "") -> list[tuple]:
    """Entries as tuples; ``host`` (a server's ``ip:port``, which differs
    between the packages' runs) written as ``HOST``."""
    out = [dataclasses.astuple(e) for e in entries]
    return [(e[0].replace(host, "HOST"), *e[1:]) for e in out] if host \
        else out


@contextlib.contextmanager
def _server(handle):
    """A ``ThreadingHTTPServer`` on a thread; ``handle(req)`` gets each
    request (``req.command``, ``req.path``, ``req.headers``, ``req.port``)
    and returns (status, headers, body). Yields (base URL, the requests
    seen as (method, path, headers))."""
    seen: list = []
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _any(self):
            with lock:
                seen.append((self.command, self.path, dict(self.headers)))
            self.port = server.server_address[1]
            status, headers, body = handle(self)
            self.send_response(status)
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        do_GET = do_HEAD = _any

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", seen
    finally:
        server.shutdown()
        server.server_close()


def _ranged(data: bytes, req) -> tuple[int, dict, bytes]:
    rng = req.headers.get("Range")
    if rng:
        a, _, b = rng.split("=", 1)[1].partition("-")
        lo, hi = int(a), min(len(data), int(b) + 1)
        return 206, {"Content-Range": f"bytes {lo}-{hi - 1}/{len(data)}"}, \
            data[lo:hi]
    return 200, {"Accept-Ranges": "bytes"}, data


# ---------------------------------------------------------------- memory

MEMORY = {"reference": ref_memory, "port": port_memory}


@pytest.mark.parametrize("pkg", PKGS)
def test_memory_roundtrip_as_the_reference(pkg):
    """``TestMemoryClient.test_roundtrip``: a blob's length and a range."""
    mem = MEMORY[pkg]
    url = mem.put_blob("t1", b"hello world" * 100)

    async def go(src, cli, Range, DFError):
        n = await src.content_length(src.SourceRequest(url=url))
        resp = await src.download(src.SourceRequest(url=url,
                                                    range=Range(0, 5)))
        return n, await resp.read_all(), resp.total_length

    try:
        assert _run(pkg, go) == (1100, b"hello", 1100)
    finally:
        mem.delete_blob("t1")


def test_memory_ranges_listing_and_misses_equal_the_reference():
    blobs = {f"ds/shard-{i}": _bytes(300_000 + 7 * i, i) for i in range(3)}
    blobs["other/x"] = b"x"

    def go_for(pkg):
        mem = MEMORY[pkg]
        for k, v in blobs.items():
            mem.put_blob(k, v)

        async def go(src, cli, Range, DFError):
            c = src.client_for("memory://x")
            out = {"list": _entries(await c.list(
                src.SourceRequest(url="memory://ds/")))}
            for start, length in ((0, 10), (299_990, 100), (1 << 20, 5)):
                req = src.SourceRequest(url="memory://ds/shard-1",
                                        range=Range(start, length))
                resp = await c.download(req)
                out[start] = (await c.content_length(req),
                              await resp.read_all(), resp.content_length,
                              resp.total_length)
            try:
                await c.download(src.SourceRequest(url="memory://nope"))
            except DFError as exc:
                out["miss"] = exc.code.name
            return out

        try:
            return _run(pkg, go)
        finally:
            for k in blobs:
                mem.delete_blob(k)

    got, want = go_for("port"), go_for("reference")
    assert got == want
    assert [e[1] for e in got["list"]] == [f"ds/shard-{i}" for i in range(3)]
    assert got["miss"] == "SOURCE_NOT_FOUND"


# ---------------------------------------------------------------- gcs

def test_gcs_request_shaping_as_the_reference(monkeypatch):
    """``TestGCSClient``: the media path, ``alt=media``, the range and the
    bearer token; both packages send the same requests."""
    data = _bytes(20_000, 5)
    monkeypatch.setenv("GOOGLE_APPLICATION_TOKEN", "tok123")
    out = {}
    for pkg in PKGS:
        with _server(lambda req: _ranged(data, req)) as (base, seen):
            monkeypatch.setenv("DF_GCS_ENDPOINT", base)

            async def go(src, cli, Range, DFError):
                req = src.SourceRequest(
                    url="gs://mybucket/models/w.safetensors",
                    range=Range(100, 200))
                resp = await src.download(req)
                return await resp.read_all()

            body = _run(pkg, go)
            out[pkg] = [(m, p, h.get("Authorization"), h.get("Range"))
                        for m, p, h in seen]
        assert body == data[100:300]
    assert out["port"] == out["reference"] == [
        ("GET", "/storage/v1/b/mybucket/o/models%2Fw.safetensors?alt=media",
         "Bearer tok123", "bytes=100-299")]


def test_gcs_listing_metadata_and_length_from_the_stand_in(tmp_path,
                                                           monkeypatch):
    """One level of the listing as ``ListEntry``s, the metadata's
    ``updated`` and the media length (a HEAD with no body) through
    ``chip_smoke.GCSStandIn``, equal in both packages."""
    root = tmp_path / "gcs"
    files = {"pre/a.bin": _bytes(5000, 1), "pre/sub/b.bin": _bytes(70, 2),
             "pre/sub/c/d.bin": b"", "prefix2/no.bin": b"n"}
    for name, data in files.items():
        p = root / "bkt" / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
    store = chip_smoke.GCSStandIn(str(root), "tok")
    port = store.start()
    monkeypatch.setenv("DF_GCS_ENDPOINT", f"http://127.0.0.1:{port}")
    monkeypatch.setenv("GOOGLE_APPLICATION_TOKEN", "tok")

    async def go(src, cli, Range, DFError):
        c = src.client_for("gs://bkt/pre")
        return {
            "top": _entries(await c.list(
                src.SourceRequest(url="gs://bkt/pre"))),
            "sub": _entries(await c.list(
                src.SourceRequest(url="gs://bkt/pre/sub/"))),
            "updated": await c.last_modified(
                src.SourceRequest(url="gs://bkt/pre/a.bin")),
            "length": await c.content_length(
                src.SourceRequest(url="gs://bkt/pre/a.bin")),
            "ranged": await c.content_length(src.SourceRequest(
                url="gs://bkt/pre/a.bin", range=Range(4990, 100))),
            "empty": await c.content_length(
                src.SourceRequest(url="gs://bkt/pre/sub/c/d.bin")),
        }

    try:
        got, want = _run("port", go), _run("reference", go)
        stats = store.stats()
    finally:
        store.stop()
    assert got == want
    assert got["top"] == [("gs://bkt/pre/a.bin", "pre/a.bin", False, 5000),
                          ("gs://bkt/pre/sub/", "pre/sub/", True, -1)]
    assert [e[0] for e in got["sub"]] == ["gs://bkt/pre/sub/b.bin",
                                          "gs://bkt/pre/sub/c/"]
    assert got["updated"].endswith("Z") and got["length"] == 5000
    assert got["ranged"] == 10 and got["empty"] == 0
    assert stats["media_bytes"] == {} and stats["listings"] == 4
    assert stats["unauthorized"] == 0


def test_gcs_listing_reads_one_page(monkeypatch):
    """``nextPageToken`` is not followed (the reference's behaviour): the
    listing is the first page, from one request."""
    def handle(req):
        q = parse_qs(urlsplit(req.path).query)
        items = [{"name": "p/b", "size": "2"}] if "pageToken" in q else \
            [{"name": "p/a", "size": "1"}]
        return 200, {"Content-Type": "application/json"}, json.dumps(
            {"items": items, "nextPageToken": "page2"}).encode()

    out = {}
    for pkg in PKGS:
        with _server(handle) as (base, seen):
            monkeypatch.setenv("DF_GCS_ENDPOINT", base)

            async def go(src, cli, Range, DFError):
                return _entries(await src.client_for("gs://b/p").list(
                    src.SourceRequest(url="gs://b/p")))

            # compared decoded: aiohttp writes the query's %2F as "/"
            out[pkg] = (_run(pkg, go),
                        [(urlsplit(p).path, parse_qs(urlsplit(p).query))
                         for _m, p, _h in seen])
    assert out["port"] == out["reference"] == (
        [("gs://b/p/a", "p/a", False, 1)],
        [("/storage/v1/b/b/o", {"prefix": ["p/"], "delimiter": ["/"]})])


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("call", ["list", "download", "content_length"])
def test_gcs_bucket_root_is_refused(pkg, call):
    """``gs://bkt/`` names no object: ``_parse`` raises INVALID_ARGUMENT
    before any request."""
    async def go(src, cli, Range, DFError):
        c = src.client_for("gs://bkt/")
        try:
            await getattr(c, call)(src.SourceRequest(url="gs://bkt/"))
        except DFError as exc:
            return exc.code.name, exc.message
        return None

    assert _run(pkg, go) == ("INVALID_ARGUMENT", "bad gs url: gs://bkt/")


# ---------------------------------------------------------------- hdfs

def _namenode(blob: bytes):
    """A NameNode answering GETFILESTATUS and LISTSTATUS, and OPEN with a
    307 to a DataNode path on the same server, which serves the
    ``offset``/``length`` slice."""
    def handle(req):
        parts = urlsplit(req.path)
        q = {k: v[0] for k, v in parse_qs(parts.query).items()}
        if parts.path.startswith("/datanode/"):
            off = int(q.get("offset", "0"))
            ln = int(q.get("length", len(blob) - off))
            return 200, {}, blob[off:off + ln]
        op = q.get("op", "")
        js = {"Content-Type": "application/json"}
        if op == "GETFILESTATUS":
            return 200, js, json.dumps({"FileStatus": {
                "length": len(blob), "type": "FILE",
                "modificationTime": 123}}).encode()
        if op == "LISTSTATUS":
            return 200, js, json.dumps({"FileStatuses": {"FileStatus": [
                {"pathSuffix": "a.bin", "type": "FILE", "length": 5},
                {"pathSuffix": "sub", "type": "DIRECTORY",
                 "length": 0}]}}).encode()
        if op == "OPEN":
            loc = f"http://127.0.0.1:{req.port}/datanode{parts.path}?" + \
                parts.query
            return 307, {"Location": loc}, b""
        return 400, {}, b""
    return handle


def test_hdfs_status_open_range_and_list_as_the_reference(monkeypatch):
    blob = _bytes(200_000, 9)
    monkeypatch.setenv("DF_HDFS_USER", "trainer")
    out = {}
    for pkg in PKGS:
        with _server(_namenode(blob)) as (base, seen):
            host = base.split("://", 1)[1]
            url = f"hdfs://{host}/data/weights.bin"

            async def go(src, cli, Range, DFError):
                c = src.client_for(url)
                whole = await c.download(src.SourceRequest(url=url))
                ranged = await c.download(src.SourceRequest(
                    url=url, range=Range(100, 500)))
                return {
                    "length": await c.content_length(
                        src.SourceRequest(url=url)),
                    "modified": await c.last_modified(
                        src.SourceRequest(url=url)),
                    "whole": (whole.status, whole.total_length,
                              await whole.read_all() == blob),
                    "ranged": (ranged.status, ranged.total_length,
                               ranged.content_length,
                               await ranged.read_all() == blob[100:600]),
                    "list": _entries(await c.list(
                        src.SourceRequest(url=url)), host),
                }

            got = _run(pkg, go)
            out[pkg] = (got, [(m, p, "Range" in h) for m, p, h in seen])
    assert out["port"] == out["reference"]
    got, requests = out["port"]
    assert got["whole"] == (200, -1, True)
    assert got["ranged"] == (206, -1, 500, True)
    assert got["length"] == len(blob) and got["modified"] == "123"
    assert [e[1:3] for e in got["list"]] == [("a.bin", False), ("sub", True)]
    # the range rides the query, never a header; OPEN is followed as a GET
    assert not any(has_range for _m, _p, has_range in requests)
    opens = [p for _m, p, _r in requests
             if p.startswith("/webhdfs/") and "op=OPEN" in p]
    assert opens[1].startswith("/webhdfs/v1/data/weights.bin?op=OPEN&"
                               "user.name=trainer&offset=100&length=500")
    assert any(p.startswith("/datanode/") and "offset=100" in p
               for _m, p, _r in requests)


# ---------------------------------------------------------------- oras

def _registry(blob: bytes, digest: str, tally: dict, *, ranges=True):
    """A registry requiring a bearer token, whose challenge carries a
    quoted scope holding a comma; it counts tokens issued and manifest
    GETs."""
    scope = "repository:ml/weights:pull,push"

    def handle(req):
        path = urlsplit(req.path).path
        if path == "/token":
            tally["scopes"].append(parse_qs(urlsplit(req.path).query)
                                   .get("scope", [""])[0])
            return 200, {"Content-Type": "application/json"}, json.dumps(
                {"token": "tok-123"}).encode()
        if req.headers.get("Authorization") != "Bearer tok-123":
            return 401, {"WWW-Authenticate":
                         f'Bearer realm="http://127.0.0.1:{req.port}/token",'
                         f'service="reg",scope="{scope}"'}, b""
        if path == "/v2/ml/weights/manifests/v1":
            tally["manifests"] += 1
            tally["accept"] = req.headers.get("Accept", "")
            return 200, {"Content-Type": "application/json"}, json.dumps({
                "schemaVersion": 2,
                "layers": [{"digest": digest, "size": len(blob),
                            "mediaType": "application/octet-stream"}]
            }).encode()
        if path == f"/v2/ml/weights/blobs/{digest}":
            if not ranges:
                return 200, {}, blob
            return _ranged(blob, req)
        return 404, {}, b""
    return handle


@pytest.mark.parametrize("ranges", [True, False],
                         ids=["blob-ranges", "range-ignored"])
def test_oras_challenge_blob_ranges_and_manifest_gets(monkeypatch, ranges):
    """The challenge is answered once with the whole quoted scope; the
    blob serves ranges, or a 200 for a range is SOURCE_RANGE_UNSUPPORTED;
    each download (one per piece group) GETs the manifest again."""
    import hashlib
    blob = _bytes(120_000, 4)
    digest = "sha256:" + hashlib.sha256(blob).hexdigest()
    monkeypatch.setenv("DF_ORAS_INSECURE", "1")
    monkeypatch.delenv("DF_ORAS_TOKEN", raising=False)
    out = {}
    for pkg in PKGS:
        tally = {"scopes": [], "manifests": 0}
        with _server(_registry(blob, digest, tally, ranges=ranges)) \
                as (base, _seen):
            host = base.split("://", 1)[1]
            url = f"oras://{host}/ml/weights:v1"

            async def go(src, cli, Range, DFError):
                c = src.client_for(url)
                c._tokens.clear()
                got = {"length": await c.content_length(
                    src.SourceRequest(url=url))}
                resp = await c.download(src.SourceRequest(url=url))
                got["whole"] = await resp.read_all() == blob
                m0 = tally["manifests"]
                got["ranges"] = []
                for start in (10, 40_000, 119_990):
                    try:
                        r = await c.download(src.SourceRequest(
                            url=url, range=Range(start, 100)))
                        got["ranges"].append(
                            (r.status, r.total_length,
                             await r.read_all() == blob[start:start + 100]))
                    except DFError as exc:
                        got["ranges"].append(exc.code.name)
                got["manifest_gets_per_range"] = (tally["manifests"] - m0) / 3
                got["list"] = _entries(await c.list(
                    src.SourceRequest(url=url)), host)
                return got

            out[pkg] = (_run(pkg, go), tally["scopes"],
                        "oci.image.manifest" in tally["accept"])
    assert out["port"] == out["reference"]
    got, scopes, oci = out["port"]
    assert scopes == ["repository:ml/weights:pull,push"] and oci
    assert got["length"] == len(blob) and got["whole"]
    assert got["manifest_gets_per_range"] == 1.0
    if ranges:
        assert got["ranges"] == [(206, len(blob), True)] * 3
    else:
        assert got["ranges"] == ["SOURCE_RANGE_UNSUPPORTED"] * 3


# ---------------------------------------------------------------- walk

class _Lister:
    """A source with a fixed listing (the reference's ``TestWalk``
    listers)."""

    def __init__(self, entries_cls, entries):
        self.entries = [entries_cls(**e) for e in entries]

    async def content_length(self, req):
        return 10

    async def supports_range(self, req):
        return False

    async def last_modified(self, req):
        return ""

    async def download(self, req):
        raise AssertionError("not fetched")

    async def list(self, req):
        return list(self.entries)


LISTERS = {
    "seg": [dict(url="seg://h/data2/f", name="f", is_dir=False,
                 content_length=10),
            dict(url="seg://h/data/..config", name="..config", is_dir=False,
                 content_length=10),
            dict(url="seg://h/data/ok.bin", name="ok.bin", is_dir=False,
                 content_length=10)],
    "evil": [dict(url="evil://b/a/../../../etc/cron.d/x", name="x",
                  is_dir=False, content_length=10),
             dict(url="evil://b/ok.bin", name="ok.bin", is_dir=False,
                  content_length=10)],
}


def _walk(pkg: str, url: str, **kw) -> list[tuple[str, str]]:
    async def go(src, cli, Range, DFError):
        return [(e.url, rel) async for e, rel in cli.walk(url, **kw)]
    return _run(pkg, go)


@pytest.mark.parametrize("scheme,url,want", [
    ("seg", "seg://h/data", ["..config", "data2/f", "ok.bin"]),
    ("evil", "evil://b/", ["ok.bin"]),
], ids=["segment-boundaries", "traversal-refused"])
def test_walk_listers_as_the_reference(scheme, url, want):
    """``TestWalk``'s listers: the base stripped at a segment boundary, a
    file named ``..config`` kept, a ``..`` segment refused."""
    got = {}
    for pkg, (src, cli, _r, _e) in PKGS.items():
        src.register_client(scheme, _Lister(src.ListEntry, LISTERS[scheme]))
        try:
            got[pkg] = _walk(pkg, url)
        finally:
            cli._REGISTRY.pop(scheme, None)
    assert got["port"] == got["reference"]
    assert sorted(rel for _u, rel in got["port"]) == want


def test_walk_breaks_a_symlink_cycle_as_the_reference(tmp_path):
    root = tmp_path / "tree"
    (root / "sub").mkdir(parents=True)
    (root / "a.bin").write_bytes(b"A" * 100)
    (root / "sub" / "b.bin").write_bytes(b"B" * 50)
    (root / "sub" / "loop").symlink_to(root)
    got = {pkg: _walk(pkg, f"file://{root}") for pkg in PKGS}
    assert got["port"] == got["reference"]
    rels = [rel for _u, rel in got["port"]]
    assert sorted(rels)[:2] == ["a.bin", "sub/b.bin"] and len(rels) <= 4


def test_walk_depth_cap_as_the_reference(tmp_path):
    root = tmp_path / "deep"
    d = root
    for i in range(5):
        d = d / f"d{i}"
    d.mkdir(parents=True)
    (d / "leaf").write_bytes(b"x")
    (root / "top").write_bytes(b"y")
    got = {pkg: (_walk(pkg, f"file://{root}", max_depth=3),
                 _walk(pkg, f"file://{root}"))
           for pkg in PKGS}
    assert got["port"] == got["reference"]
    capped, full = got["port"]
    assert [r for _u, r in capped] == ["top"]
    assert sorted(r for _u, r in full) == ["d0/d1/d2/d3/d4/leaf", "top"]


def test_walk_over_memory_gcs_and_http_as_the_reference(tmp_path,
                                                        monkeypatch):
    for mem in MEMORY.values():
        for i in range(3):
            mem.put_blob(f"w/part-{i}", b"p" * i)
    root = tmp_path / "gcs" / "bkt" / "ckpt"
    (root / "original").mkdir(parents=True)
    for rel in ("config.json", "original/params.json", ".gitattributes"):
        (root / rel).write_bytes(rel.encode() if "json" in rel else b"")
    store = chip_smoke.GCSStandIn(str(tmp_path / "gcs"), "t")
    port = store.start()
    monkeypatch.setenv("DF_GCS_ENDPOINT", f"http://127.0.0.1:{port}")
    monkeypatch.setenv("GOOGLE_APPLICATION_TOKEN", "t")
    try:
        with _server(lambda req: (200, {}, b"h" * 7)) as (base, _seen):
            got = {pkg: [_walk(pkg, "memory://w/"),
                         _walk(pkg, "gs://bkt/ckpt/"),
                         _walk(pkg, f"{base}/one/file.bin")]
                   for pkg in PKGS}
    finally:
        store.stop()
        for mem in MEMORY.values():
            for i in range(3):
                mem.delete_blob(f"w/part-{i}")
    assert got["port"] == got["reference"]
    mem_walk, gcs_walk, http_walk = got["port"]
    assert [rel for _u, rel in mem_walk] == ["part-0", "part-1", "part-2"]
    assert gcs_walk == [
        ("gs://bkt/ckpt/.gitattributes", ".gitattributes"),
        ("gs://bkt/ckpt/config.json", "config.json"),
        ("gs://bkt/ckpt/original/params.json", "original/params.json")]
    assert [rel for _u, rel in http_walk] == ["file.bin"]


# ---------------------------------------------------------------- faultgate

FAULTGATES = {"reference": ref_faultgate, "port": port_faultgate}


@pytest.mark.parametrize("pkg", PKGS)
def test_source_fetch_script_fails_one_url(pkg):
    """The literal script fires once, for the keyed URL only: the next
    download of it and a download of another URL pass."""
    mem = MEMORY[pkg]
    a, b = mem.put_blob("fetch/a", b"aa"), mem.put_blob("fetch/b", b"bb")
    fg = FAULTGATES[pkg]
    fg.arm_script(f"source.fetch@{a}=error:code=SOURCE_ERROR")

    async def go(src, cli, Range, DFError):
        out = []
        for url in (b, a, a):
            try:
                out.append(await (await src.download(
                    src.SourceRequest(url=url))).read_all())
            except DFError as exc:
                out.append(exc.code.name)
        return out

    try:
        assert _run(pkg, go) == [b"bb", "SOURCE_ERROR", b"aa"]
    finally:
        fg.reset()
        mem.delete_blob("fetch/a")
        mem.delete_blob("fetch/b")


def test_source_fetch_fails_one_back_source_pull_in_both(tmp_path):
    """Armed on every attempt, the site fails the daemon's back-source
    pull of that URL after its retries, with the same code in both
    packages, while a pull of another URL completes."""
    for name in ("armed.bin", "other.bin"):
        (tmp_path / name).write_bytes(_bytes(300_000, len(name)))
    armed = f"file://{tmp_path}/armed.bin"
    other = f"file://{tmp_path}/other.bin"

    async def pull(daemon, msg, url):
        try:
            async for resp in daemon.ptm.start_file_task(msg.DownloadRequest(
                    url=url, output=str(tmp_path / f"out-{id(daemon)}-"
                                        f"{os.path.basename(url)}"),
                    timeout_s=20.0)):
                if resp.done:
                    return "done", resp.completed_length
        except Exception as exc:  # noqa: BLE001 - either package's DFError
            return "failed", exc.code.name

    async def go():
        ref = RefDaemon(ref_config.DaemonConfig(
            workdir=str(tmp_path / "ref"), host_ip="127.0.0.1",
            hostname="ref",
            storage=ref_config.StorageSection(gc_interval_s=3600)))
        port = Daemon(DaemonConfig(workdir=str(tmp_path / "port"),
                                   hostname="port", device="cpu"))
        await ref.start()
        await port.start()
        script = f"source.fetch@{armed}=error:code=SOURCE_ERROR:n=-1"
        ref_faultgate.arm_script(script)
        port_faultgate.arm_script(script)
        try:
            return {"reference": (await pull(ref, ref_msg, armed),
                                  await pull(ref, ref_msg, other)),
                    "port": (await pull(port, port_msg, armed),
                             await pull(port, port_msg, other))}
        finally:
            ref_faultgate.reset()
            port_faultgate.reset()
            await port.stop()
            await ref.stop()

    got = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
    assert got["port"] == got["reference"]
    assert got["port"][0] == ("failed", "SOURCE_ERROR")
    assert got["port"][1] == ("done", 300_000)


def test_source_fetch_is_a_known_site():
    assert "source.fetch" in port_faultgate.SITES
    assert port_faultgate.SITES == ref_faultgate.SITES
    script = port_faultgate.arm_script("source.fetch=error:after_ms=400")[0]
    assert (script.site, script.after_ms) == ("source.fetch", 400)
    port_faultgate.reset()
    assert Code.SOURCE_ERROR.name == "SOURCE_ERROR"
