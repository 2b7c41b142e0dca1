"""JSON bodies and their ``Content-Type``, against the reference (ROADMAP
Queue 3 entry 69).

The reference reads three kinds of JSON answer with aiohttp's
``resp.json()``, whose default refuses a body whose raw, lower-cased
``Content-Type`` does not start as ``application/json`` or an
``application/...+json`` type (``ContentTypeError``, a missing header
included) and raises ``json.JSONDecodeError`` for a JSON-typed body that
is no JSON. The port parses them with ``source/http_client.py``
``json_body``, which holds the same rule. One standard-library stand-in
per place serves both packages, and each case's outcome is pinned:

* the registry token of an image preheat (``JobRunner.
  _resolve_image_layers``), and the job an image preheat leaves
  ``failed`` when the token is refused;
* the ORAS bearer token (``oras://`` ``content_length``);
* WebHDFS ``GETFILESTATUS`` and ``LISTSTATUS`` (``hdfs://``
  ``content_length`` and ``list``), and a daemon's back-source pull of an
  ``hdfs://`` URL, which both packages fail with ``UNKNOWN`` and the
  error's text.

The cases: JSON as ``text/plain``, with no ``Content-Type``, as a
``+json`` type, as ``application/json; charset=utf-8``, and a JSON type
over a body that is no JSON. The exceptions' texts are equal, the URL in
them included. Tolerances are exact.
"""

import asyncio
import json
from urllib.parse import parse_qs, urlsplit

import pytest

from dragonfly2_tpu.daemon import config as ref_config
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.idl import messages as ref_msg
from dragonfly2_tpu.manager.jobs import JobRunner as RefJobRunner
from dragonfly2_tpu.manager.store import Store as RefStore
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl import messages as port_msg
from dragonfly2_tpu_torch.manager.jobs import JobRunner
from dragonfly2_tpu_torch.manager.store import Store
from dragonfly2_tpu_torch.source.http_client import (ContentTypeError,
                                                     json_body)

from test_torch_sources import LIMIT_S, PKGS, _bytes, _run, _server

TOKEN = "tok-69"
# case -> (Content-Type or None, the token body, the outcome both give)
CASES = {
    "text-plain": ("text/plain", json.dumps({"token": TOKEN}).encode(),
                   "ContentTypeError"),
    "no-type": (None, json.dumps({"token": TOKEN}).encode(),
                "ContentTypeError"),
    "plus-json": ("application/vnd.example.token+json",
                  json.dumps({"token": TOKEN}).encode(), "ok"),
    "json-charset": ("application/json; charset=utf-8",
                     json.dumps({"token": TOKEN}).encode(), "ok"),
    "json-not-json": ("application/json", b"<html>no token</html>",
                      "JSONDecodeError"),
}
RUNNERS = {"reference": (RefJobRunner, RefStore), "port": (JobRunner, Store)}


def _typed(ctype: str | None) -> dict:
    return {"Content-Type": ctype} if ctype else {}


def _outcome(exc: BaseException) -> tuple[str, str]:
    return type(exc).__name__, str(exc)


class _HeadersCI(dict):
    """Headers under lower-case names, looked up in any case."""

    def get(self, key, default=None):
        return super().get(key.lower(), default)


@pytest.mark.parametrize("ctype,body,want", [
    ("application/json", b'{"a": 1}', {"a": 1}),
    ("Application/JSON", b'{"a": 1}', {"a": 1}),
    ("application/problem+json", b'{"a": 1}', {"a": 1}),
    ("application/jsonx", b'{"a": 1}', {"a": 1}),
    ("application/json; charset=utf-16", '{"a": 1}'.encode("utf-16"),
     {"a": 1}),
    ("application/json", b"  \r\n", None),
    ("text/json", b'{"a": 1}', "ContentTypeError"),
    ("", b'{"a": 1}', "ContentTypeError"),
    (" application/json", b'{"a": 1}', "ContentTypeError"),
])
def test_json_body_holds_aiohttps_rule(ctype, body, want):
    """``json_body`` against aiohttp's own check: the raw header lower
    cased and matched at its start (parameters and a longer subtype
    pass), a blank body None, the charset honoured."""
    from aiohttp.client_reqrep import _is_expected_content_type
    assert (_is_expected_content_type(ctype.lower(), "application/json")
            == (want != "ContentTypeError"))
    headers = {"content-type": ctype} if ctype else {}
    if want == "ContentTypeError":
        with pytest.raises(ContentTypeError) as exc:
            json_body(200, _HeadersCI(headers), body, "http://h/x")
        assert str(exc.value) == (
            "200, message='Attempt to decode JSON with unexpected mimetype: "
            f"{ctype.lower()}', url='http://h/x'")
    else:
        assert json_body(200, _HeadersCI(headers), body, "http://h/x") \
            == want


# ---------------------------------------------------------------- jobs

def _registry(ctype, token_body, layer: bytes):
    """A registry requiring ``Bearer TOKEN``: a 401 with a challenge whose
    realm is its ``/token`` (service only, so the realm URL is one text
    in both packages), answered with ``token_body`` under ``ctype``; a
    manifest of one layer."""
    digest = "sha256:" + "ab" * 32
    manifest = json.dumps({"schemaVersion": 2, "layers": [
        {"digest": digest, "size": len(layer)}]}).encode()

    def handle(req):
        path = urlsplit(req.path).path
        if path == "/token":
            return 200, _typed(ctype), token_body
        if req.headers.get("Authorization") != f"Bearer {TOKEN}":
            return 401, {"WWW-Authenticate":
                         f'Bearer realm="http://127.0.0.1:{req.port}/token",'
                         'service="reg"'}, b""
        if path == "/v2/img/manifests/v1":
            return 200, {"Content-Type": "application/vnd.oci.image."
                         "manifest.v1+json"}, manifest
        return 404, {}, b""
    return handle, digest


@pytest.mark.parametrize("case", CASES)
def test_image_resolution_token_types_as_the_reference(case):
    ctype, token_body, want = CASES[case]
    handle, digest = _registry(ctype, token_body, b"x" * 10)
    with _server(handle) as (base, _seen):
        url = f"{base}/v2/img/manifests/v1"

        async def resolve(runner_cls, store_cls):
            runner = runner_cls(store_cls())
            try:
                return "ok", await runner._resolve_image_layers(url, None,
                                                                "")
            except Exception as exc:  # noqa: BLE001 - the outcome pinned
                return _outcome(exc)
            finally:
                await runner.close()

        got = {pkg: asyncio.run(asyncio.wait_for(resolve(*cls), LIMIT_S))
               for pkg, cls in RUNNERS.items()}
    assert got["port"] == got["reference"]
    if want == "ok":
        assert got["port"] == ("ok", ([f"{base}/v2/img/blobs/{digest}"],
                                      {"Authorization": f"Bearer {TOKEN}"}))
    else:
        assert got["port"][0] == want
    if want == "ContentTypeError":
        assert got["port"][1] == (
            "200, message='Attempt to decode JSON with unexpected mimetype: "
            f"{(ctype or '').lower()}', url='{base}/token?service=reg'")


def test_a_refused_token_fails_the_image_job_as_the_reference(tmp_path):
    """An image preheat whose realm answers its token as ``text/plain``
    ends ``failed`` in both packages, with the same error."""
    ctype, token_body, _want = CASES["text-plain"]
    handle, _digest = _registry(ctype, token_body, b"x" * 10)
    with _server(handle) as (base, _seen):
        url = f"{base}/v2/img/manifests/v1"

        async def job(pkg):
            runner_cls, store_cls = RUNNERS[pkg]
            store = store_cls(str(tmp_path / f"{pkg}.db"))
            runner = runner_cls(store)
            try:
                jid = await runner.submit_preheat(url=url, type_="image")
                for _ in range(400):
                    row = store.job(jid)
                    if row["state"] in ("succeeded", "failed"):
                        return row["state"], json.loads(row["result"])
                    await asyncio.sleep(0.02)
                return row["state"], None
            finally:
                await runner.close()
                store.close()

        got = {pkg: asyncio.run(asyncio.wait_for(job(pkg), LIMIT_S))
               for pkg in RUNNERS}
    assert got["port"] == got["reference"]
    assert got["port"] == ("failed", {"error": (
        "image resolution failed: 200, message='Attempt to decode JSON with "
        f"unexpected mimetype: text/plain', url='{base}/token?service=reg'")})


# ---------------------------------------------------------------- oras

def _oras(ctype, token_body, blob: bytes):
    def handle(req):
        path = urlsplit(req.path).path
        if path == "/token":
            return 200, _typed(ctype), token_body
        if req.headers.get("Authorization") != f"Bearer {TOKEN}":
            return 401, {"WWW-Authenticate":
                         f'Bearer realm="http://127.0.0.1:{req.port}/token",'
                         'service="reg"'}, b""
        if path == "/v2/ml/weights/manifests/v1":
            return 200, {"Content-Type": "application/json"}, json.dumps({
                "schemaVersion": 2, "layers": [
                    {"digest": "sha256:" + "cd" * 32, "size": len(blob)}]}
            ).encode()
        return 404, {}, b""
    return handle


@pytest.mark.parametrize("case", CASES)
def test_oras_token_types_as_the_reference(case, monkeypatch):
    ctype, token_body, want = CASES[case]
    blob = _bytes(1000, 69)
    monkeypatch.setenv("DF_ORAS_INSECURE", "1")
    monkeypatch.delenv("DF_ORAS_TOKEN", raising=False)
    with _server(_oras(ctype, token_body, blob)) as (base, _seen):
        url = f"oras://{base.split('://', 1)[1]}/ml/weights:v1"

        async def go(src, cli, Range, DFError):
            c = src.client_for(url)
            c._tokens.clear()
            try:
                return "ok", await c.content_length(src.SourceRequest(url=url))
            except Exception as exc:  # noqa: BLE001 - the outcome pinned
                return _outcome(exc)

        got = {pkg: _run(pkg, go) for pkg in PKGS}
    assert got["port"] == got["reference"]
    if want == "ok":
        assert got["port"] == ("ok", len(blob))
    else:
        assert got["port"][0] == want
    if want == "ContentTypeError":
        assert got["port"][1].endswith(f", url='{base}/token?service=reg'")


# ---------------------------------------------------------------- hdfs

def _namenode(ctype, body: bytes | None):
    """GETFILESTATUS and LISTSTATUS answered under ``ctype``; ``body``
    None answers their JSON, else ``body`` as it is."""
    def handle(req):
        op = parse_qs(urlsplit(req.path).query).get("op", [""])[0]
        if op == "GETFILESTATUS":
            js = {"FileStatus": {"length": 4096, "type": "FILE",
                                 "modificationTime": 7}}
        elif op == "LISTSTATUS":
            js = {"FileStatuses": {"FileStatus": [
                {"pathSuffix": "a.bin", "type": "FILE", "length": 5}]}}
        else:
            return 400, {}, b""
        return 200, _typed(ctype), body if body is not None \
            else json.dumps(js).encode()
    return handle


@pytest.mark.parametrize("case", CASES)
def test_hdfs_status_and_listing_types_as_the_reference(case, monkeypatch):
    ctype, token_body, want = CASES[case]
    monkeypatch.delenv("DF_HDFS_USER", raising=False)
    body = token_body if want == "JSONDecodeError" else None
    with _server(_namenode(ctype, body)) as (base, _seen):
        host = base.split("://", 1)[1]
        url = f"hdfs://{host}/data/w.bin"

        async def go(src, cli, Range, DFError):
            c = src.client_for(url)
            out = {}
            for name, call in (("length", c.content_length),
                               ("list", c.list)):
                try:
                    got = await call(src.SourceRequest(url=url))
                    out[name] = ("ok", got if name == "length"
                                 else [e.name for e in got])
                except Exception as exc:  # noqa: BLE001 - the outcome pinned
                    out[name] = _outcome(exc)
            return out

        got = {pkg: _run(pkg, go) for pkg in PKGS}
    assert got["port"] == got["reference"]
    if want == "ok":
        assert got["port"] == {"length": ("ok", 4096),
                               "list": ("ok", ["a.bin"])}
    else:
        assert {v[0] for v in got["port"].values()} == {want}
    if want == "ContentTypeError":
        assert got["port"]["length"][1] == (
            "200, message='Attempt to decode JSON with unexpected mimetype: "
            f"{(ctype or '').lower()}', "
            f"url='{base}/webhdfs/v1/data/w.bin?op=GETFILESTATUS'")


def test_a_text_typed_status_fails_the_hdfs_pull_as_the_reference(
        tmp_path, monkeypatch):
    """A daemon's back-source pull of an ``hdfs://`` URL whose
    ``GETFILESTATUS`` is JSON under ``text/plain``: both packages' pulls
    fail with ``UNKNOWN`` and the refusal's text."""
    ctype, _body, _want = CASES["text-plain"]

    async def pull(daemon, msg, url):
        try:
            async for resp in daemon.ptm.start_file_task(msg.DownloadRequest(
                    url=url, output=str(tmp_path / f"out-{id(daemon)}"),
                    timeout_s=20.0)):
                if resp.done:
                    return "done", resp.completed_length
        except Exception as exc:  # noqa: BLE001 - either package's DFError
            return "failed", exc.code.name, exc.message

    with _server(_namenode(ctype, None)) as (base, _seen):
        url = f"hdfs://{base.split('://', 1)[1]}/data/w.bin"

        async def go():
            ref = RefDaemon(ref_config.DaemonConfig(
                workdir=str(tmp_path / "ref"), host_ip="127.0.0.1",
                hostname="ref",
                storage=ref_config.StorageSection(gc_interval_s=3600)))
            port = Daemon(DaemonConfig(workdir=str(tmp_path / "port"),
                                       hostname="port", device="cpu"))
            await ref.start()
            await port.start()
            try:
                return {"reference": await pull(ref, ref_msg, url),
                        "port": await pull(port, port_msg, url)}
            finally:
                await port.stop()
                await ref.stop()

        monkeypatch.delenv("DF_HDFS_USER", raising=False)
        got = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
    assert got["port"] == got["reference"]
    assert got["port"] == ("failed", "UNKNOWN", (
        "200, message='Attempt to decode JSON with unexpected mimetype: "
        f"text/plain', url='{base}/webhdfs/v1/data/w.bin?op=GETFILESTATUS'"))
