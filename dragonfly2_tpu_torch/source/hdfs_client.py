"""hdfs:// origin client over the WebHDFS REST surface.

Counterpart of ``dragonfly2_tpu/source/hdfs_client.py`` (reference
``pkg/source/clients/hdfs``), on the port's HTTP client where the
reference uses aiohttp. Every Hadoop distribution serves WebHDFS, and it
needs no protocol library:

- ``GETFILESTATUS`` gives the length and ``modificationTime``;
- ``OPEN`` streams the file; a range rides the query as ``offset`` and
  ``length`` (WebHDFS does not honour a ``Range`` header), and the
  NameNode's 307 to a DataNode is followed as a GET. A ranged response
  reports status 206 with an unknown total (-1);
- ``LISTSTATUS`` lists one directory.

URL form: ``hdfs://namenode:9870/path/to/file`` (the NameNode's HTTP
port). Auth: ``user.name`` from ``DF_HDFS_USER`` (simple auth).
"""

from __future__ import annotations

import os
from typing import AsyncIterator
from urllib.parse import quote

from ..common.errors import Code, DFError
from .client import ListEntry, SourceRequest, SourceResponse, register_client
from .http_client import HTTPSourceClient, _ProtocolError, json_body

_CHUNK = 1 << 20


def _split(url: str) -> tuple[str, str]:
    rest = url.split("://", 1)[1]
    authority, _, path = rest.partition("/")
    if not authority or not path:
        raise DFError(Code.INVALID_ARGUMENT, f"bad hdfs url: {url}")
    return authority, "/" + path


def _api(url: str, op: str, **params: str) -> str:
    authority, path = _split(url)
    q = f"op={op}"
    user = os.environ.get("DF_HDFS_USER", "")
    if user:
        q += f"&user.name={quote(user)}"
    for k, v in params.items():
        q += f"&{k}={quote(str(v))}"
    return (f"http://{authority}/webhdfs/v1"
            f"{quote(path, safe='/-_.~')}?{q}")


class HDFSSourceClient:
    def __init__(self) -> None:
        self._http = HTTPSourceClient()

    async def close(self) -> None:
        await self._http.close()

    async def _json(self, req: SourceRequest, op: str) -> dict:
        """The NameNode's JSON answer to ``op``; one not typed as JSON
        raises ``ContentTypeError``, as the reference's ``resp.json()``."""
        url = _api(req.url, op)
        resp = await self._http.request("GET", url, req.header,
                                        timeout_s=req.timeout_s)
        body = await resp.read()
        if resp.status == 404 and op == "GETFILESTATUS":
            raise DFError(Code.SOURCE_NOT_FOUND, req.url)
        if resp.status >= 400:
            raise DFError(Code.SOURCE_ERROR,
                          f"webhdfs {op} {resp.status}: {req.url}")
        return json_body(resp.status, resp.headers, body, url)

    async def _status(self, req: SourceRequest) -> dict:
        return (await self._json(req, "GETFILESTATUS")).get("FileStatus", {})

    async def content_length(self, req: SourceRequest) -> int:
        total = int((await self._status(req)).get("length", -1))
        if req.range is not None and total >= 0:
            return min(req.range.length, max(0, total - req.range.start))
        return total

    async def supports_range(self, req: SourceRequest) -> bool:
        return True                   # offset/length on op=OPEN

    async def last_modified(self, req: SourceRequest) -> str:
        return str((await self._status(req)).get("modificationTime", 0))

    async def download(self, req: SourceRequest) -> SourceResponse:
        params: dict[str, str] = {}
        if req.range is not None:
            params["offset"] = str(req.range.start)
            params["length"] = str(req.range.length)
        # OPEN answers with a 307 to a DataNode, followed as a GET
        resp = await self._http.request("GET", _api(req.url, "OPEN",
                                                    **params),
                                        req.header, timeout_s=req.timeout_s)
        if resp.status >= 400:
            status = resp.status
            resp.close()
            if status == 404:
                raise DFError(Code.SOURCE_NOT_FOUND, req.url)
            raise DFError(Code.SOURCE_ERROR,
                          f"webhdfs OPEN {status}: {req.url}")

        async def chunks() -> AsyncIterator[bytes]:
            try:
                async for data in resp.chunks(_CHUNK):
                    yield data
            except (OSError, TimeoutError, _ProtocolError) as exc:
                raise DFError(Code.SOURCE_ERROR,
                              f"webhdfs body failed: {exc!r}") from None
            finally:
                resp.close()       # a body abandoned midway (no-op at EOF)

        return SourceResponse(
            status=206 if req.range is not None else resp.status,
            content_length=int(resp.headers.get("Content-Length", "-1")),
            total_length=-1, supports_range=True, header=resp.headers,
            chunks=chunks())

    async def list(self, req: SourceRequest) -> list[ListEntry]:
        body = await self._json(req, "LISTSTATUS")
        out = []
        for st in body.get("FileStatuses", {}).get("FileStatus", []):
            name = st.get("pathSuffix", "")
            out.append(ListEntry(
                url=req.url.rstrip("/") + "/" + name, name=name,
                is_dir=st.get("type") == "DIRECTORY",
                content_length=int(st.get("length", -1))))
        return out


register_client(["hdfs"], HDFSSourceClient())
