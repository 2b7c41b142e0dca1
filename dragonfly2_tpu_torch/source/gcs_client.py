"""gs:// origin client: Google Cloud Storage over its JSON API.

Counterpart of ``dragonfly2_tpu/source/gcs_client.py``. Seed peers read
model weights and dataset shards from GCS; the requests go through the
port's own HTTP client (``http_client.HTTPSourceClient``):

- metadata: ``GET {endpoint}/storage/v1/b/{bucket}/o/{object}``, whose
  ``updated`` is the last-modified time;
- media:    ``.../o/{object}?alt=media`` with a standard ``Range``; its
  length is probed with the HTTP client's HEAD (a ranged GET where HEAD
  is refused);
- listing:  ``.../o?prefix={prefix}&delimiter=%2F``, whose ``items`` are
  files and ``prefixes`` directories. As in the reference, one page is
  read: ``nextPageToken`` is not followed.

Auth: a bearer token from ``GOOGLE_APPLICATION_TOKEN``, anonymous without
one. ``DF_GCS_ENDPOINT`` overrides the endpoint (a local stand-in, a
private service connect).
"""

from __future__ import annotations

import json
import os
from urllib.parse import quote

from ..common.errors import Code, DFError
from .client import ListEntry, SourceRequest, SourceResponse, register_client
from .http_client import HTTPSourceClient

_DEFAULT_ENDPOINT = "https://storage.googleapis.com"


def _endpoint() -> str:
    return os.environ.get("DF_GCS_ENDPOINT", _DEFAULT_ENDPOINT).rstrip("/")


def _parse(url: str) -> tuple[str, str]:
    """(bucket, object); a URL naming no object is refused."""
    rest = url.split("://", 1)[1]
    bucket, _, obj = rest.partition("/")
    if not bucket or not obj:
        raise DFError(Code.INVALID_ARGUMENT, f"bad gs url: {url}")
    return bucket, obj


def _media_url(url: str) -> str:
    bucket, obj = _parse(url)
    return (f"{_endpoint()}/storage/v1/b/{bucket}/o/"
            f"{quote(obj, safe='')}?alt=media")


def _meta_url(url: str) -> str:
    bucket, obj = _parse(url)
    return f"{_endpoint()}/storage/v1/b/{bucket}/o/{quote(obj, safe='')}"


def _auth_header() -> dict[str, str]:
    token = os.environ.get("GOOGLE_APPLICATION_TOKEN", "")
    return {"Authorization": f"Bearer {token}"} if token else {}


class GCSSourceClient:
    def __init__(self) -> None:
        self._http = HTTPSourceClient()

    async def close(self) -> None:
        await self._http.close()

    @staticmethod
    def _req(req: SourceRequest, url: str) -> SourceRequest:
        return SourceRequest(url=url, header={**_auth_header(), **req.header},
                             range=req.range, timeout_s=req.timeout_s)

    async def content_length(self, req: SourceRequest) -> int:
        return await self._http.content_length(
            self._req(req, _media_url(req.url)))

    async def supports_range(self, req: SourceRequest) -> bool:
        return True                    # media downloads always honour Range

    async def last_modified(self, req: SourceRequest) -> str:
        meta = await self._http.download(self._req(req, _meta_url(req.url)))
        try:
            return json.loads(await meta.read_all()).get("updated", "")
        except (json.JSONDecodeError, UnicodeDecodeError):
            return ""

    async def download(self, req: SourceRequest) -> SourceResponse:
        return await self._http.download(
            self._req(req, _media_url(req.url)))

    async def list(self, req: SourceRequest) -> list[ListEntry]:
        """One level under the URL's prefix (the first page only)."""
        bucket, prefix = _parse(req.url if req.url.endswith("/")
                                else req.url + "/")
        url = (f"{_endpoint()}/storage/v1/b/{bucket}/o"
               f"?prefix={quote(prefix, safe='')}&delimiter=%2F")
        resp = await self._http.download(self._req(
            SourceRequest(url=req.url, header=req.header), url))
        data = json.loads(await resp.read_all())
        out = [ListEntry(url=f"gs://{bucket}/{item['name']}",
                         name=item["name"], is_dir=False,
                         content_length=int(item.get("size", -1)))
               for item in data.get("items", [])]
        out += [ListEntry(url=f"gs://{bucket}/{sub}", name=sub, is_dir=True)
                for sub in data.get("prefixes", [])]
        return out


register_client(["gs", "gcs"], GCSSourceClient())
