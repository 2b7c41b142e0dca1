"""ResourceClient protocol + scheme registry.

Counterpart of ``dragonfly2_tpu/source/client.py`` cut to what the
back-source path calls: content length, range support, last-modified and a
download that streams chunks, so the daemon hashes and stores while bytes
arrive. ``ListEntry`` and a client's one-level ``list`` serve the object
gateway's object listing (the ``file`` and ``s3`` clients have it); the
recursive walk waits for recursive downloads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import AsyncIterator, Protocol

from ..common.errors import Code, DFError
from ..common.piece import Range


@dataclass
class SourceRequest:
    url: str
    header: dict[str, str] = field(default_factory=dict)
    range: Range | None = None
    timeout_s: float = 0.0


@dataclass
class SourceResponse:
    """Handle on an in-flight origin download."""

    status: int = 200
    content_length: int = -1       # of THIS response body (range-aware)
    total_length: int = -1         # of the whole resource when known
    supports_range: bool = False
    last_modified: str = ""
    header: dict[str, str] = field(default_factory=dict)
    chunks: AsyncIterator[bytes] | None = None

    async def read_all(self) -> bytes:
        out = bytearray()
        assert self.chunks is not None
        async for c in self.chunks:
            out.extend(c)
        return bytes(out)


@dataclass
class ListEntry:
    url: str
    name: str
    is_dir: bool
    content_length: int = -1


class ResourceClient(Protocol):
    async def content_length(self, req: SourceRequest) -> int: ...
    async def supports_range(self, req: SourceRequest) -> bool: ...
    async def download(self, req: SourceRequest) -> SourceResponse: ...
    async def last_modified(self, req: SourceRequest) -> str: ...


_REGISTRY: dict[str, ResourceClient] = {}


def register_client(schemes: list[str] | str, client: ResourceClient) -> None:
    if isinstance(schemes, str):
        schemes = [schemes]
    for s in schemes:
        _REGISTRY[s.lower()] = client


def client_for(url: str) -> ResourceClient:
    scheme = url.split("://", 1)[0].lower() if "://" in url else "file"
    client = _REGISTRY.get(scheme)
    if client is None:
        raise DFError(Code.SOURCE_ERROR, f"no source client for scheme {scheme!r}")
    return client


async def content_length(req: SourceRequest) -> int:
    return await client_for(req.url).content_length(req)


async def supports_range(req: SourceRequest) -> bool:
    return await client_for(req.url).supports_range(req)


async def download(req: SourceRequest) -> SourceResponse:
    return await client_for(req.url).download(req)


async def close_clients() -> None:
    """Close every registered client's connections bound to the running
    loop (in-process daemons share the process-wide registry)."""
    seen: set[int] = set()
    for client in _REGISTRY.values():
        if id(client) in seen:
            continue
        seen.add(id(client))
        close = getattr(client, "close", None)
        if close is not None:
            await close()
