"""s3:// origin client: SigV4-signed reads from S3-compatible stores.

Counterpart of ``dragonfly2_tpu/source/s3_client.py`` (reference
``pkg/source/clients/s3/s3.go``). Covers AWS S3, MinIO, Ceph RGW and the
OSS/OBS-compatible endpoints through path-style URLs; credentials from
the gateway's backend config (``set_credentials``) or the environment
(``common.objectstorage.S3Credentials``); anonymous for public buckets.
Requests go through the port's own HTTP/1.1 client, where the reference
uses aiohttp.

URL forms:
  s3://bucket/key                       the endpoint from DF_S3_ENDPOINT,
                                        else the AWS default for AWS_REGION
  s3+http(s)://host[:port]/bucket/key   the endpoint inline (the object
                                        gateway reads this way, so reads
                                        hit the backend its writes go to)
"""

from __future__ import annotations

import os
from typing import AsyncIterator
from urllib.parse import quote

from ..common.errors import Code, DFError
from ..common.objectstorage import S3Credentials, _sha256_hex, sign_v4
from .client import ListEntry, SourceRequest, SourceResponse, register_client
from .http_client import HTTPSourceClient, _ProtocolError

_CHUNK = 1 << 20


def _endpoint() -> str:
    ep = os.environ.get("DF_S3_ENDPOINT", "")
    if ep:
        return ep.rstrip("/")
    region = os.environ.get("AWS_REGION",
                            os.environ.get("AWS_DEFAULT_REGION", ""))
    host = f"s3.{region}.amazonaws.com" if region else "s3.amazonaws.com"
    return f"https://{host}"


def _parse(url: str) -> tuple[str, str, str]:
    """(endpoint, bucket, key)."""
    scheme, rest = url.split("://", 1)
    if scheme in ("s3+http", "s3+https"):
        host, _, rest = rest.partition("/")
        endpoint = f"{scheme[3:]}://{host}"
    else:
        endpoint = _endpoint()
    bucket, _, key = rest.partition("/")
    if not bucket or not key:
        raise DFError(Code.INVALID_ARGUMENT, f"bad s3 url: {url}")
    return endpoint, bucket, key


def _http_url(url: str) -> str:
    endpoint, bucket, key = _parse(url)
    return (f"{endpoint}/{quote(bucket)}/"
            f"{quote(key, safe='/-_.~')}")


def _status_error(status: int, what: str, url: str) -> DFError:
    if status == 404:
        return DFError(Code.SOURCE_NOT_FOUND, url)
    if status in (401, 403):
        return DFError(Code.SOURCE_AUTH_ERROR, f"s3 {status}: {url}")
    return DFError(Code.SOURCE_ERROR, f"s3 {what} {status}: {url}")


class S3SourceClient:
    def __init__(self) -> None:
        self._http = HTTPSourceClient()
        self._creds: S3Credentials | None = None

    def set_credentials(self, creds: S3Credentials) -> None:
        self._creds = creds

    def _credentials(self) -> S3Credentials:
        return self._creds or S3Credentials.from_env()

    async def close(self) -> None:
        await self._http.close()

    def _signed(self, method: str, url: str,
                headers: dict[str, str]) -> dict[str, str]:
        creds = self._credentials()
        if not creds.access_key:
            return headers                  # anonymous bucket
        return sign_v4(creds, method, url, headers, _sha256_hex(b""))

    async def content_length(self, req: SourceRequest) -> int:
        meta = await self._head(req)
        total = int(meta.get("Content-Length", "-1"))
        if req.range is not None and total >= 0:
            return min(req.range.length, max(0, total - req.range.start))
        return total

    async def supports_range(self, req: SourceRequest) -> bool:
        return True                          # S3 always serves ranges

    async def last_modified(self, req: SourceRequest) -> str:
        meta = await self._head(req)
        return meta.get("Last-Modified", "")

    async def _head(self, req: SourceRequest):
        url = _http_url(req.url)
        headers = self._signed("HEAD", url, dict(req.header))
        resp = await self._http.request("HEAD", url, headers,
                                        timeout_s=req.timeout_s)
        await resp.read()
        if resp.status >= 400:
            raise _status_error(resp.status, "HEAD", req.url)
        return resp.headers

    async def download(self, req: SourceRequest) -> SourceResponse:
        url = _http_url(req.url)
        headers = dict(req.header)
        if req.range is not None:
            headers["range"] = req.range.http_header()
        headers = self._signed("GET", url, headers)
        resp = await self._http.request("GET", url, headers,
                                        timeout_s=req.timeout_s)
        if resp.status >= 300:
            resp.close()
            raise _status_error(resp.status, "GET", req.url)
        length = int(resp.headers.get("Content-Length", "-1"))
        total = length
        cr = resp.headers.get("Content-Range", "")
        if "/" in cr and cr.rsplit("/", 1)[1].isdigit():
            total = int(cr.rsplit("/", 1)[1])

        async def chunks() -> AsyncIterator[bytes]:
            try:
                async for data in resp.chunks(_CHUNK):
                    yield data
            except (OSError, TimeoutError, _ProtocolError) as exc:
                raise DFError(Code.SOURCE_ERROR,
                              f"s3 body failed: {exc!r}") from None
            finally:
                resp.close()       # a body abandoned midway (no-op at EOF)

        return SourceResponse(
            status=resp.status, content_length=length, total_length=total,
            supports_range=True,
            last_modified=resp.headers.get("Last-Modified", ""),
            header=resp.headers, chunks=chunks())

    async def list(self, req: SourceRequest) -> list[ListEntry]:
        return [ListEntry(url=req.url, name=req.url.rsplit("/", 1)[-1],
                          is_dir=False,
                          content_length=await self.content_length(req))]


register_client(["s3", "s3+http", "s3+https"], S3SourceClient())
