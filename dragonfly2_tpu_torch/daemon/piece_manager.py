"""PieceManager: moves a task's needed pieces from its origin into storage.

Counterpart of the back-source half of
``dragonfly2_tpu/daemon/piece_manager.py``: ``download_source`` cuts the
origin stream into pieces, either as one stream or as a work queue of
contiguous piece groups read in parallel, and hands each piece to the
conductor to land. Pieces the task's storage already holds are adopted
first, and the origin is asked only for the holes of the NEEDED set (the
pieces covering a requested shard subset, or every piece). An origin that
reports no length is streamed to its end as one stream, cut at the
default piece size, and the total learned at the end. Each piece
being cut is an in-flight relay span (``relay.py``) while it fills, which
the upload server can stream to the landing watermark; such spans carry
no digest, as in the reference (a child landing one computes its own, the
trust it would give the origin). Every origin read passes the task's
bucket from the traffic shaper (``conductor.rate_limiter``: the shaper
splits ``download.total_rate_limit_bps`` by class and task, and the same
bucket paces the task's P2P fetches), or the daemon-wide
``total_limiter`` when no shaper is attached. ``import_file`` lands a
local file's pieces the same way (the object gateway's PUT).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import TYPE_CHECKING

from ..common.errors import Code, DFError
from ..common.rate import TokenBucket
from ..common.piece import (INGEST_DMA_UNIT_BYTES, Range, parse_http_range,
                            piece_count, piece_range)
from ..idl.messages import PieceInfo
from ..source import SourceRequest, client_for
from ..source import download as source_download
from .config import DownloadConfig

if TYPE_CHECKING:  # pragma: no cover
    from .conductor import PeerTaskConductor

log = logging.getLogger("df.core.piece")

_SOURCE_ATTEMPTS = 3
_SOURCE_BACKOFF_S = 0.5


async def _open_source(req: SourceRequest):
    """Open an origin stream, retrying transient failures with exponential
    backoff, or after the origin's own ``Retry-After`` when it sent one.
    Only the OPEN retries: pieces already landed from a stream that died
    midway are deduped at landing."""
    for attempt in range(_SOURCE_ATTEMPTS):
        try:
            return await source_download(req)
        except DFError as exc:
            transient = exc.code in (Code.SOURCE_ERROR, Code.UNAVAILABLE,
                                     Code.DEADLINE_EXCEEDED)
            if not transient or attempt == _SOURCE_ATTEMPTS - 1:
                raise
            log.info("origin open failed (%s); retrying", exc.message)
            hint_ms = getattr(exc, "retry_after_ms", 0)
            await asyncio.sleep(hint_ms / 1000.0 if hint_ms
                                else _SOURCE_BACKOFF_S * 2 ** attempt)


def _relay_for(conductor):
    """The relay hub when the conductor registered with it: origin bytes
    then serve onward while the piece is still arriving."""
    if getattr(conductor, "_relay_tracked", False):
        return conductor.relay
    return None


class _PieceCutter:
    """Cuts an origin byte stream into per-piece buffers and lands each one
    as it fills; each buffer is a relay span while it fills (the span's
    watermark maps onto the buffer one to one). ``want(num, rel)`` returns
    the next piece's size; <= 0 stops consuming (origin over-delivery, or
    the group bound)."""

    def __init__(self, conductor, *, start_num: int, start_rel: int, want):
        self.conductor = conductor
        self.relay = _relay_for(conductor)
        self.want = want
        self.num = start_num
        self.rel = start_rel
        self.cur: bytearray | None = None
        self.span = None
        self.filled = 0
        self.t0 = time.monotonic()

    async def feed(self, chunk) -> None:
        coff = 0
        while coff < len(chunk):
            if self.cur is None:
                want = self.want(self.num, self.rel)
                if want <= 0:
                    return
                self.cur = bytearray(want)
                self.filled = 0
                if self.relay is not None:
                    self.span = self.relay.open_span(
                        self.conductor.task_id, self.rel, want, self.cur,
                        [PieceInfo(piece_num=self.num, range_start=self.rel,
                                   range_size=want)])
            take = min(len(self.cur) - self.filled, len(chunk) - coff)
            self.cur[self.filled:self.filled + take] = \
                chunk[coff:coff + take]
            self.filled += take
            coff += take
            if self.span is not None:
                self.span.advance(self.filled)
            if self.filled == len(self.cur):
                await self._land(bytes(self.cur))
                self.cur = None

    async def _land(self, data: bytes) -> None:
        cost = int((time.monotonic() - self.t0) * 1000)
        await self.conductor.on_piece_from_source(self.num, self.rel,
                                                  data, cost)
        if self.relay is not None:
            self.relay.retire(self.span)   # landed: serves from disk
        self.span = None
        self.num += 1
        self.rel += len(data)
        self.t0 = time.monotonic()

    async def flush_tail(self) -> None:
        """Origin ended short of the expected piece size: land what came
        (single-stream semantics; group streams treat short as an error)."""
        if self.cur is not None and self.filled:
            await self._land(bytes(self.cur[:self.filled]))
            self.cur = None

    def close(self) -> None:
        """The stream died mid-piece: retire the leftover span."""
        if self.relay is not None and self.span is not None:
            self.relay.retire(self.span)
            self.span = None


class PieceManager:
    def __init__(self, cfg: DownloadConfig):
        self.cfg = cfg
        self.total_limiter = TokenBucket(cfg.total_rate_limit_bps or 0)

    def _limiter(self, conductor) -> TokenBucket:
        # a shaper's per-task bucket when one is attached, else the
        # daemon-wide bucket
        return getattr(conductor, "rate_limiter", None) or self.total_limiter

    async def download_source(self, conductor: "PeerTaskConductor") -> None:
        """Fetch the conductor's full content (or sub-range) from the origin."""
        client = client_for(conductor.url)
        header = dict(conductor.url_meta.header or {})
        probe = SourceRequest(url=conductor.url, header=header)
        total = await client.content_length(probe)
        ranged = await client.supports_range(probe)

        # resolve a requested sub-range against the real total: the
        # conductor then stores ONLY the range, at range-relative offsets
        if conductor.url_meta.range and conductor.content_range is None:
            if not ranged:
                raise DFError(Code.SOURCE_RANGE_UNSUPPORTED,
                              "origin cannot serve the requested range")
            limit = total if total >= 0 else (1 << 62)
            try:
                conductor.content_range = parse_http_range(
                    conductor.url_meta.range, limit)
            except ValueError as exc:
                raise DFError(Code.INVALID_ARGUMENT, str(exc)) from None
        req = SourceRequest(url=conductor.url, header=header,
                            range=conductor.content_range)
        effective = (conductor.content_range.length
                     if conductor.content_range is not None else total)
        if effective < 0:
            await self._download_unknown_length(conductor, req)
            return

        piece_size = conductor.set_content_info(effective)
        n = piece_count(effective, piece_size)
        # warm adoption BEFORE any origin byte moves: pieces this task
        # already holds on disk (a finished subset's warm partial) land
        # without a transfer, and the origin is asked only for the holes
        if conductor.storage is not None and conductor.storage.md.pieces:
            await conductor.place_from_store(
                [m.to_info() for m in
                 list(conductor.storage.md.pieces.values())])
        # Looped: a joiner may WIDEN the needed set mid-fetch
        # (conductor.widen_to_whole_file), so the holes are re-derived
        # after each round; the commit flag is set in the same
        # synchronous block as the final emptiness check, so a widen can
        # never slip between "covered" and finalize
        prev_missing: list[int] | None = None
        while True:
            missing = [i for i in conductor.needed_piece_nums(n)
                       if i not in conductor.ready]
            if not missing:
                conductor._finishing = True
                break
            if missing == prev_missing:
                # a round moved nothing: surface it instead of spinning
                raise DFError(Code.SOURCE_ERROR,
                              f"origin round landed none of "
                              f"{len(missing)} missing pieces")
            prev_missing = missing
            if (ranged and self.cfg.back_source_parallelism > 1
                    and (len(missing) < n
                         or effective
                         >= self.cfg.back_source_group_min_bytes)):
                # the piece-group path also fills holes: its range reads
                # skip everything already landed or not needed
                await self._download_piece_groups(conductor, req, effective,
                                                  piece_size, missing)
            else:
                await self._download_stream(conductor, req, piece_size)

    async def _download_unknown_length(self, conductor,
                                       req: SourceRequest) -> None:
        """An origin with no length: one stream to its end, cut at the
        default piece size with a short last piece, and the total learned
        at the end (reference ``_download_unknown_length``)."""
        piece_size = conductor.set_content_info(-1)
        resp = await _open_source(req)
        cutter = _PieceCutter(conductor, start_num=0, start_rel=0,
                              want=lambda _num, _rel: piece_size)
        limiter = self._limiter(conductor)
        try:
            async for chunk in resp.chunks:
                await limiter.acquire(len(chunk))
                await cutter.feed(chunk)
            await cutter.flush_tail()
        finally:
            cutter.close()
        conductor.on_source_complete(cutter.rel)

    async def _download_stream(self, conductor, req: SourceRequest,
                               piece_size: int) -> None:
        """One origin stream of the whole content, cut into pieces as
        bytes arrive (pieces already landed are deduped at landing)."""
        resp = await _open_source(req)
        total = conductor.content_length
        # offsets are range-relative: the task stores just its range
        cutter = _PieceCutter(
            conductor, start_num=0, start_rel=0,
            want=lambda _num, rel: min(piece_size, total - rel))
        limiter = self._limiter(conductor)
        try:
            async for chunk in resp.chunks:
                await limiter.acquire(len(chunk))
                await cutter.feed(chunk)
            # origin ended short of the expected size: land what came
            await cutter.flush_tail()
        finally:
            cutter.close()

    async def _download_piece_groups(self, conductor, req: SourceRequest,
                                     total: int, piece_size: int,
                                     missing: list[int]) -> None:
        """Work-queue of contiguous piece groups over the MISSING pieces:
        each worker streams the next unclaimed group (parallel range
        reads). Pieces outside ``missing`` split the runs, so the origin
        only ever serves the holes.

        Dynamic claiming instead of a static per-worker partition makes
        coverage advance front to back, so device-sink shards complete
        progressively and their host-to-device copies overlap the download;
        with static quarters every worker finishes at once and every copy
        fires after the last byte."""
        m = len(missing)
        workers = min(self.cfg.back_source_parallelism, m)
        # one copy unit per group: big enough that per-request origin
        # overhead is noise, small enough that groups never span sink
        # shards. The tail stretch (last ~2 rounds of the worker pool)
        # halves the group size so streams finish staggered and the tail
        # copies overlap too.
        group_pieces = max(1, min(INGEST_DMA_UNIT_BYTES // piece_size,
                                  -(-m // workers)))
        bounds: list[tuple[int, int]] = []
        idx = 0
        while idx < m:
            size = group_pieces
            if m - idx <= 2 * workers * group_pieces and group_pieces > 1:
                size = max(1, group_pieces // 2)
            # clip the group to the contiguous run starting here: a group
            # must be one origin Range, and held pieces break the run
            end = idx + 1
            while end < min(idx + size, m) \
                    and missing[end] == missing[end - 1] + 1:
                end += 1
            bounds.append((missing[idx], missing[end - 1] + 1))
            idx = end
        queue = collections.deque(bounds)
        base = req.range.start if req.range else 0

        async def group(first: int, last: int) -> None:
            g_off, _ = piece_range(first, piece_size, total)
            g_end_off, g_end_len = piece_range(last - 1, piece_size, total)
            sub = SourceRequest(
                url=req.url, header=dict(req.header),
                range=Range(base + g_off, g_end_off + g_end_len - g_off),
                timeout_s=req.timeout_s)
            resp = await _open_source(sub)
            cutter = _PieceCutter(
                conductor, start_num=first, start_rel=g_off,
                want=lambda num, _rel: (piece_range(num, piece_size,
                                                    total)[1]
                                        if num < last else 0))
            limiter = self._limiter(conductor)
            try:
                async for chunk in resp.chunks:
                    await limiter.acquire(len(chunk))
                    await cutter.feed(chunk)
            finally:
                cutter.close()
            if cutter.num != last:
                raise DFError(Code.CLIENT_BACK_SOURCE_ERROR,
                              f"short origin range read: group stopped at "
                              f"piece {cutter.num}/{last}")

        async def worker() -> None:
            while queue:
                first, last = queue.popleft()
                await group(first, last)

        results = await asyncio.gather(*(worker() for _ in range(workers)),
                                       return_exceptions=True)
        errs = [r for r in results if isinstance(r, BaseException)]
        if errs:
            raise errs[0]

    async def import_file(self, conductor: "PeerTaskConductor",
                          path: str) -> None:
        """A local file into the conductor's storage, cut at the task's
        piece size (the gateway's PUT; reference ``import_file``). The
        reads go through the default executor, not the storage pool, so a
        multi-GB import never parks the piece landings queued there."""
        import os

        loop = asyncio.get_running_loop()
        total = await loop.run_in_executor(None, os.path.getsize, path)
        piece_size = conductor.set_content_info(total)
        f = await loop.run_in_executor(None, lambda: open(path, "rb"))
        try:
            num, off = 0, 0
            while True:
                data = await loop.run_in_executor(None, f.read, piece_size)
                if not data:
                    break
                await conductor.on_piece_from_source(num, off, data, 0)
                num += 1
                off += len(data)
        finally:
            f.close()
        conductor.on_source_complete(total)
