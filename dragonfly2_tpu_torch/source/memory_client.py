"""memory:// origin client: an in-process blob registry, for tests and for
content injected locally and then distributed over P2P.

Counterpart of ``dragonfly2_tpu/source/memory_client.py``; the port keeps
its own registry (``_BLOBS``), so the two packages' blobs never mix.
"""

from __future__ import annotations

from typing import AsyncIterator

from ..common.errors import Code, DFError
from .client import ListEntry, SourceRequest, SourceResponse, register_client

_BLOBS: dict[str, bytes] = {}
_CHUNK = 1 << 18


def put_blob(name: str, data: bytes) -> str:
    """Register a blob; returns its memory:// URL."""
    _BLOBS[name] = data
    return f"memory://{name}"


def delete_blob(name: str) -> None:
    _BLOBS.pop(name, None)


def _name(url: str) -> str:
    return url.split("://", 1)[1] if "://" in url else url


def _blob(url: str) -> bytes:
    blob = _BLOBS.get(_name(url))
    if blob is None:
        raise DFError(Code.SOURCE_NOT_FOUND, f"no blob {url}")
    return blob


class MemorySourceClient:
    async def content_length(self, req: SourceRequest) -> int:
        blob = _blob(req.url)
        if req.range is not None:
            return min(req.range.length, max(0, len(blob) - req.range.start))
        return len(blob)

    async def supports_range(self, req: SourceRequest) -> bool:
        return True

    async def last_modified(self, req: SourceRequest) -> str:
        return ""

    async def download(self, req: SourceRequest) -> SourceResponse:
        blob = _blob(req.url)
        total = len(blob)
        if req.range is not None:
            blob = blob[req.range.start:req.range.end]

        async def chunks() -> AsyncIterator[bytes]:
            for i in range(0, len(blob), _CHUNK):
                yield blob[i:i + _CHUNK]

        return SourceResponse(status=200, content_length=len(blob),
                              total_length=total, supports_range=True,
                              chunks=chunks())

    async def list(self, req: SourceRequest) -> list[ListEntry]:
        """Every blob whose name starts with the URL's, in name order."""
        prefix = _name(req.url)
        return [ListEntry(url=f"memory://{k}", name=k, is_dir=False,
                          content_length=len(v))
                for k, v in sorted(_BLOBS.items()) if k.startswith(prefix)]


register_client(["memory"], MemorySourceClient())
