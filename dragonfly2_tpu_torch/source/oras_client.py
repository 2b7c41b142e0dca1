"""oras:// origin client: OCI-registry artifacts as download sources.

Counterpart of ``dragonfly2_tpu/source/oras_client.py`` (reference
``pkg/source/clients/oras``), on the port's HTTP client where the
reference uses aiohttp. URL form:

    oras://registry.example.com/repo/name:tag

Resolution: ``GET /v2/<repo>/manifests/<tag>`` with the OCI and Docker
manifest ``Accept`` types; the payload is the manifest's first layer (the
ORAS file convention), streamed from ``/v2/<repo>/blobs/<digest>`` with a
standard ``Range``. A blob that answers a ranged GET with 200 is refused
(``SOURCE_RANGE_UNSUPPORTED``): every piece-group slice would otherwise
take bytes from offset 0. As in the reference, every ``download`` and
``content_length`` resolves the manifest again, so each piece-group range
costs one manifest GET.

Auth: anonymous, answering one ``WWW-Authenticate: Bearer`` challenge per
request with a token from its ``realm`` (``service`` and ``scope``
passed on; parameters split on commas outside quotes, so
``scope="repository:x:pull,push"`` stays whole); a static token from
``DF_ORAS_TOKEN``. ``DF_ORAS_INSECURE=1`` speaks plain http.
"""

from __future__ import annotations

import json
import os
import re
from typing import AsyncIterator
from urllib.parse import urlencode

from ..common.errors import Code, DFError
from .client import ListEntry, SourceRequest, SourceResponse, register_client
from .http_client import HTTPSourceClient, _ProtocolError, json_body

_CHUNK = 1 << 20
_MANIFEST_ACCEPT = ", ".join([
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.oci.artifact.manifest.v1+json",
])
# key="quoted value" or key=bare-value, the quoted form first
_CHALLENGE_PARAM = re.compile(r'(\w+)="([^"]*)"|(\w+)=([^,\s]+)')


def _scheme() -> str:
    return "http" if os.environ.get("DF_ORAS_INSECURE") else "https"


def _parse(url: str) -> tuple[str, str, str]:
    """(registry, repo, tag)."""
    rest = url.split("://", 1)[1]
    registry, _, repo_tag = rest.partition("/")
    repo, _, tag = repo_tag.rpartition(":")
    if not registry or not repo or not tag:
        raise DFError(Code.INVALID_ARGUMENT,
                      f"bad oras url (registry/repo:tag): {url}")
    return registry, repo, tag


class ORASSourceClient:
    def __init__(self) -> None:
        self._http = HTTPSourceClient()
        self._tokens: dict[str, str] = {}      # registry -> bearer token

    async def close(self) -> None:
        await self._http.close()

    def _auth_headers(self, registry: str) -> dict[str, str]:
        token = self._tokens.get(registry) or os.environ.get(
            "DF_ORAS_TOKEN", "")
        return {"Authorization": f"Bearer {token}"} if token else {}

    async def _bearer_dance(self, registry: str, challenge: str) -> bool:
        """``WWW-Authenticate: Bearer realm=...,service=...,scope=...``:
        fetch an anonymous token from the realm (the public-registry
        flow)."""
        if not challenge.lower().startswith("bearer"):
            return False
        _, _, param_str = challenge.partition(" ")
        if not param_str:
            return False                # a bare "Bearer": nothing to ask
        fields = {(a or c): (b or d)
                  for a, b, c, d in _CHALLENGE_PARAM.findall(param_str)}
        realm = fields.get("realm", "")
        if not realm:
            return False
        params = {k: v for k, v in fields.items()
                  if k in ("service", "scope")}
        url = realm + (("&" if "?" in realm else "?") + urlencode(params)
                       if params else "")
        resp = await self._http.request("GET", url)
        body = await resp.read()
        if resp.status >= 400:
            return False
        # a body that is no JSON, or not typed as JSON, raises out of the
        # request, as the reference's resp.json() does
        data = json_body(resp.status, resp.headers, body, url)
        token = data.get("token") or data.get("access_token", "")
        if not token:
            return False
        self._tokens[registry] = token
        return True

    async def _get(self, registry: str, path: str, headers: dict[str, str],
                   req: SourceRequest | None = None):
        """GET with one answer to a bearer challenge."""
        url = f"{_scheme()}://{registry}{path}"
        timeout_s = req.timeout_s if req is not None else 0.0
        for attempt in (0, 1):
            h = {**headers, **self._auth_headers(registry)}
            resp = await self._http.request("GET", url, h,
                                            timeout_s=timeout_s)
            if resp.status == 401 and attempt == 0:
                challenge = resp.headers.get("WWW-Authenticate", "")
                await resp.discard()
                if await self._bearer_dance(registry, challenge):
                    continue
                raise DFError(Code.SOURCE_AUTH_ERROR, f"oras 401: {url}")
            return resp
        raise DFError(Code.SOURCE_AUTH_ERROR, url)   # pragma: no cover

    async def _resolve_layer(self, req: SourceRequest
                             ) -> tuple[str, str, dict]:
        """(registry, blob path, layer descriptor) of the artifact's
        payload layer."""
        registry, repo, tag = _parse(req.url)
        resp = await self._get(registry, f"/v2/{repo}/manifests/{tag}",
                               {"Accept": _MANIFEST_ACCEPT, **req.header},
                               req=req)
        body = await resp.read()
        if resp.status == 404:
            raise DFError(Code.SOURCE_NOT_FOUND, req.url)
        if resp.status >= 400:
            raise DFError(Code.SOURCE_ERROR,
                          f"oras manifest {resp.status}: {req.url}")
        manifest = json.loads(body)
        layers = manifest.get("layers") or manifest.get("blobs") or []
        if not layers:
            raise DFError(Code.SOURCE_ERROR,
                          f"oras manifest has no layers: {req.url}")
        layer = layers[0]
        digest = layer.get("digest", "")
        if not digest:
            raise DFError(Code.SOURCE_ERROR,
                          f"layer missing digest: {req.url}")
        return registry, f"/v2/{repo}/blobs/{digest}", layer

    async def content_length(self, req: SourceRequest) -> int:
        _, _, layer = await self._resolve_layer(req)
        total = int(layer.get("size", -1))
        if req.range is not None and total >= 0:
            return min(req.range.length, max(0, total - req.range.start))
        return total

    async def supports_range(self, req: SourceRequest) -> bool:
        return True                    # OCI blob GETs serve ranges

    async def last_modified(self, req: SourceRequest) -> str:
        return ""                      # content-addressed: the digest

    async def download(self, req: SourceRequest) -> SourceResponse:
        registry, blob_path, layer = await self._resolve_layer(req)
        headers = dict(req.header)
        if req.range is not None:
            headers["Range"] = req.range.http_header()
        resp = await self._get(registry, blob_path, headers, req=req)
        if resp.status >= 400:
            status = resp.status
            resp.close()
            raise DFError(Code.SOURCE_ERROR,
                          f"oras blob {status}: {req.url}")
        if req.range is not None and resp.status != 206:
            # OCI makes blob ranges optional: a 200 with the whole body
            # would slice every piece group from offset 0
            resp.close()
            raise DFError(Code.SOURCE_RANGE_UNSUPPORTED,
                          f"registry ignored Range: {req.url}")

        async def chunks() -> AsyncIterator[bytes]:
            try:
                async for data in resp.chunks(_CHUNK):
                    yield data
            except (OSError, TimeoutError, _ProtocolError) as exc:
                raise DFError(Code.SOURCE_ERROR,
                              f"oras body failed: {exc!r}") from None
            finally:
                resp.close()       # a body abandoned midway (no-op at EOF)

        return SourceResponse(
            status=resp.status,
            content_length=int(resp.headers.get("Content-Length", "-1")),
            total_length=int(layer.get("size", -1)), supports_range=True,
            header=resp.headers, chunks=chunks())

    async def list(self, req: SourceRequest) -> list[ListEntry]:
        return [ListEntry(url=req.url, name=req.url.rsplit("/", 1)[-1],
                          is_dir=False,
                          content_length=await self.content_length(req))]


register_client(["oras"], ORASSourceClient())
