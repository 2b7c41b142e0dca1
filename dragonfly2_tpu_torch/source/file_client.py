"""file:// origin client (also the default for bare paths).

Counterpart of ``dragonfly2_tpu/source/file_client.py``. All filesystem
work hops through the default executor: a file:// origin feeds the same
back-source path as a network origin, and its multi-MiB reads must not
run on the daemon's event loop.
"""

from __future__ import annotations

import asyncio
import os
from typing import AsyncIterator
from urllib.parse import unquote, urlsplit

from ..common.errors import Code, DFError
from .client import ListEntry, SourceRequest, SourceResponse, register_client

_CHUNK = 1 << 20


def _path(url: str) -> str:
    if "://" in url:
        parts = urlsplit(url)
        return unquote(parts.path)
    return url


class FileSourceClient:
    async def content_length(self, req: SourceRequest) -> int:
        loop = asyncio.get_running_loop()
        try:
            size = await loop.run_in_executor(None, os.path.getsize,
                                              _path(req.url))
        except OSError:
            raise DFError(Code.SOURCE_NOT_FOUND, f"no such file: {req.url}") from None
        if req.range is not None:
            return min(req.range.length, max(0, size - req.range.start))
        return size

    async def supports_range(self, req: SourceRequest) -> bool:
        return True

    async def last_modified(self, req: SourceRequest) -> str:
        try:
            return str(await asyncio.get_running_loop().run_in_executor(
                None, os.path.getmtime, _path(req.url)))
        except OSError:
            return ""

    async def download(self, req: SourceRequest) -> SourceResponse:
        path = _path(req.url)
        loop = asyncio.get_running_loop()
        try:
            total = await loop.run_in_executor(None, os.path.getsize, path)
        except OSError:
            raise DFError(Code.SOURCE_NOT_FOUND, f"no such file: {req.url}") from None
        start, length = 0, total
        if req.range is not None:
            start = req.range.start
            length = min(req.range.length, max(0, total - start))

        async def chunks() -> AsyncIterator[bytes]:
            def _open():
                f = open(path, "rb")
                f.seek(start)
                return f

            f = await loop.run_in_executor(None, _open)
            try:
                remaining = length
                while remaining > 0:
                    data = await loop.run_in_executor(
                        None, f.read, min(_CHUNK, remaining))
                    if not data:
                        return
                    remaining -= len(data)
                    yield data
            finally:
                f.close()

        return SourceResponse(status=200, content_length=length, total_length=total,
                              supports_range=True, chunks=chunks())


    async def list(self, req: SourceRequest) -> list[ListEntry]:
        """One directory level (or the file itself)."""
        path = _path(req.url)

        def _scan() -> list[ListEntry] | None:
            if not os.path.isdir(path):
                return None
            out = []
            for name in sorted(os.listdir(path)):
                full = os.path.join(path, name)
                is_dir = os.path.isdir(full)
                out.append(ListEntry(
                    url=f"file://{full}", name=name, is_dir=is_dir,
                    content_length=-1 if is_dir else os.path.getsize(full)))
            return out

        entries = await asyncio.get_running_loop().run_in_executor(None,
                                                                   _scan)
        if entries is None:
            return [ListEntry(url=req.url, name=os.path.basename(path),
                              is_dir=False,
                              content_length=await self.content_length(req))]
        return entries


register_client(["file"], FileSourceClient())
