"""ResourceClient protocol + scheme registry.

Counterpart of ``dragonfly2_tpu/source/client.py`` cut to what the
back-source path calls: content length, range support, last-modified and a
download that streams chunks, so the daemon hashes and stores while bytes
arrive. ``ListEntry`` and a client's one-level ``list`` serve the object
gateway's object listing; ``walk`` lists a tree breadth-first for
recursive downloads (``dfget --recursive``, the daemon's recursive
``Download``). The module-level ``download`` is the ``source.fetch``
faultgate site.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncIterator, Protocol
from urllib.parse import urlparse

from ..common import faultgate
from ..common.errors import Code, DFError
from ..common.piece import Range

log = logging.getLogger("df.source")


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
    async def list(self, req: SourceRequest) -> list[ListEntry]: ...


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
    if faultgate.ARMED:
        # the back-to-source entry, keyed by the URL: an error script
        # plays an origin failure for that URL alone
        await faultgate.fire("source.fetch", key=req.url)
    return await client_for(req.url).download(req)


async def walk(url: str, *, timeout_s: float = 0.0,
               header: dict | None = None, max_depth: int = 64
               ) -> AsyncIterator[tuple[ListEntry, str]]:
    """List the tree under ``url`` breadth-first, yielding ``(entry,
    relative path)`` for every file (the reference's ``walk``). The
    origin's ``header`` rides every listing request. A ``file://``
    directory symlink cycle is broken by realpath, every scheme's by a
    depth cap. The base path is stripped only at a segment boundary, and
    a name that would escape the output directory (a ``..`` segment, an
    absolute path) is refused."""
    client = client_for(url)
    base = urlparse(url).path.rstrip("/")

    def ident(u: str) -> str:
        p = urlparse(u)
        if p.scheme in ("", "file"):
            return "file://" + os.path.realpath(p.path)
        return u

    queue = deque([(url, 0)])
    seen = {ident(url)}
    while queue:
        cur, depth = queue.popleft()
        entries = await client.list(SourceRequest(
            url=cur, header=dict(header or {}), timeout_s=timeout_s))
        for e in entries:
            if e.is_dir:
                key = ident(e.url)
                if key in seen:
                    continue
                if depth + 1 > max_depth:
                    log.warning("walk: skipping %s (deeper than max_depth"
                                "=%d): the mirror will be incomplete",
                                e.url, max_depth)
                    continue
                seen.add(key)
                queue.append((e.url, depth + 1))
                continue
            rel = urlparse(e.url).path
            # "/data2/f" listed from base "/data" stays "data2/f"
            if base:
                if rel == base:
                    rel = ""
                elif rel.startswith(base + "/"):
                    rel = rel[len(base):]
            rel = os.path.normpath(rel.lstrip("/") or e.name)
            # by segment: "../x" escapes, a file named "..config" does not
            if rel.split(os.sep, 1)[0] == ".." or os.path.isabs(rel):
                log.warning("walk: refusing traversal entry %r", e.url)
                continue
            yield e, rel


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
