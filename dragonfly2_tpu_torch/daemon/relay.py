"""Cut-through relay plane: serve a piece while it is still arriving.

Counterpart of ``dragonfly2_tpu/daemon/relay.py``, whole. Store-and-forward
P2P makes every hop wait for a whole piece to land before a child may
fetch it, so a chain of hosts pays one piece time per hop. This module is
the daemon-side state that removes that barrier:

* every in-flight downloaded span (a P2P pull in ``piece_engine`` or a
  back-source piece in ``piece_manager``) registers a ``RelaySpan``: the
  pooled buffer its bytes land in plus a **watermark** of how many have
  arrived. The downloader advances the watermark as the socket fills the
  buffer (one integer store per read; nothing is copied to keep it), and
  the upload server's streaming range path serves bytes up to it and
  awaits the rest with a bounded deadline instead of refusing an
  incomplete piece (``upload_server._serve_relay``);
* landed progress is visible through ``TaskStorage.covered_prefix``; the
  hub combines both so a reader sees one contiguous frontier, verified
  bytes on disk first, then the live span's watermark;
* progress waiters are plain futures resolved by ``pulse()``, never a
  cross-task ``Condition.wait``;
* ``inflight_infos`` exposes the spans' piece metadata so the rpcserver
  can announce pieces that are about to exist (announce-ahead: a child
  may begin pulling from a partial holder).

Safety: the buffer belongs to the downloader (``common/bufpool.py``). A
span is retired, on the event loop, after its pieces have landed (or
failed verification) and before the buffer returns to the pool. Readers
copy with plain ``bytes(buf[lo:hi])`` slices and keep no ``memoryview``
(an exported buffer is dropped by the pool), and re-check ``retired``
before every copy; after retirement the same bytes are either on disk
(served from storage) or gone (corrupt: the waiting reader times out and
the child requeues the piece against another holder).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Iterable

from ..common.metrics import REGISTRY
from ..idl.messages import PieceInfo

log = logging.getLogger("df.flow.relay")

_relay_spans = REGISTRY.gauge(
    "df_relay_open_spans", "in-flight downloaded spans readable by the "
    "cut-through relay path")
_relay_tasks = REGISTRY.gauge(
    "df_relay_tasks", "tasks currently tracked by the relay hub "
    "(receiving, relay-servable)")
_relay_pulses = REGISTRY.counter(
    "df_relay_progress_pulses_total",
    "landing-progress pulses delivered to relay waiters")


class RelaySpan:
    """One in-flight downloaded span: the landing buffer + a watermark of
    bytes received so far. ``advance`` is the downloader's per-chunk hot
    path — one attribute store and a (cheap, often waiter-less) pulse."""

    __slots__ = ("task_id", "base", "size", "buf", "pieces", "watermark",
                 "retired", "_hub")

    def __init__(self, hub: "RelayHub", task_id: str, base: int, size: int,
                 buf, pieces: list[PieceInfo]):
        self._hub = hub
        self.task_id = task_id
        self.base = base              # absolute content offset of buf[0]
        self.size = size
        self.buf = buf                # pooled bytearray (downloader-owned)
        self.pieces = pieces          # PieceInfo list (digests may be "")
        self.watermark = 0            # bytes of buf valid so far
        self.retired = False

    def advance(self, watermark: int) -> None:
        if watermark > self.watermark:
            self.watermark = watermark
            self._hub.pulse(self.task_id)

    def end(self) -> int:
        return self.base + self.watermark

    def close(self) -> None:
        self._hub.retire(self)

    def read(self, pos: int, limit: int) -> bytes | None:
        """Copy up to ``limit`` bytes at absolute offset ``pos`` from the
        live buffer; None when this span (no longer) covers ``pos``."""
        if self.retired or pos < self.base or pos >= self.end():
            return None
        lo = pos - self.base
        hi = min(lo + limit, self.watermark)
        # plain slice copy — a memoryview export here would survive into
        # POOL.release's probe and discard the buffer from the pool
        return bytes(self.buf[lo:hi])


class _TaskRelay:
    __slots__ = ("spans", "waiters", "refs", "total_pieces", "on_open")

    def __init__(self):
        self.spans: list[RelaySpan] = []
        self.waiters: list[asyncio.Future] = []
        self.refs = 0                 # conductors landing this task
        self.total_pieces = -1
        self.on_open = None           # announce-ahead hook (conductor)


class RelayHub:
    """Daemon-wide registry: task_id -> in-flight landing state. All
    methods are synchronous event-loop dict work except ``wait_progress``;
    the per-chunk cost on the download hot path is one attribute store."""

    def __init__(self):
        self._tasks: dict[str, _TaskRelay] = {}

    # -- lifecycle (conductor) -----------------------------------------

    def track(self, task_id: str, *, total_pieces: int = -1,
              on_open=None) -> None:
        tr = self._tasks.get(task_id)
        if tr is None:
            tr = self._tasks[task_id] = _TaskRelay()
            _relay_tasks.set(len(self._tasks))
        tr.refs += 1
        if total_pieces >= 0:
            tr.total_pieces = total_pieces
        if on_open is not None:
            tr.on_open = on_open

    def untrack(self, task_id: str) -> None:
        """Conductor finished (success OR fail): wake every waiter so a
        streaming serve parked on this task re-checks and winds down
        instead of riding out its full stall deadline."""
        tr = self._tasks.get(task_id)
        if tr is None:
            return
        tr.refs -= 1
        if tr.refs > 0:
            return
        del self._tasks[task_id]
        _relay_tasks.set(len(self._tasks))
        for span in tr.spans:
            span.retired = True
        self._wake(tr)
        _relay_spans.set(self._span_count())

    def active(self, task_id: str) -> bool:
        return task_id in self._tasks

    # -- spans (downloader / engine / piece manager) -------------------

    def open_span(self, task_id: str, base: int, size: int, buf,
                  pieces: Iterable[PieceInfo]) -> RelaySpan | None:
        tr = self._tasks.get(task_id)
        if tr is None:
            return None
        span = RelaySpan(self, task_id, base, size, buf, list(pieces))
        tr.spans.append(span)
        _relay_spans.set(self._span_count())
        if tr.on_open is not None:
            try:
                tr.on_open(span)
            except Exception:  # noqa: BLE001 - announce is best-effort
                log.exception("relay on_open hook failed")
        return span

    def retire(self, span: RelaySpan | None) -> None:
        """Close a span out of the readable set — called AFTER its pieces
        landed in storage (so the frontier never steps backwards) and
        BEFORE the buffer returns to the pool (so no reader can copy from
        recycled memory). Pulses: the landed bytes are now disk-covered
        and a reader waiting past the old watermark may proceed."""
        if span is None or span.retired:
            return
        span.retired = True
        tr = self._tasks.get(span.task_id)
        if tr is not None:
            try:
                tr.spans.remove(span)
            except ValueError:
                pass
            self._wake(tr)
        _relay_spans.set(self._span_count())

    # -- progress ------------------------------------------------------

    def pulse(self, task_id: str) -> None:
        tr = self._tasks.get(task_id)
        if tr is not None and tr.waiters:
            self._wake(tr)

    def _wake(self, tr: _TaskRelay) -> None:
        if not tr.waiters:
            return
        waiters, tr.waiters = tr.waiters, []
        woken = 0
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)
                woken += 1
        if woken:
            _relay_pulses.inc(woken)

    async def wait_progress(self, task_id: str, timeout_s: float) -> bool:
        """Park until the task's landing frontier moves (watermark advance,
        piece landed, span retired, task finished). False on timeout or
        when the task is not tracked (nothing will ever pulse)."""
        tr = self._tasks.get(task_id)
        if tr is None:
            return False
        fut = asyncio.get_running_loop().create_future()
        tr.waiters.append(fut)
        try:
            await asyncio.wait_for(fut, timeout_s)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            if not fut.done():
                fut.cancel()

    # -- readers (upload server) ---------------------------------------

    def available_end(self, task_id: str, storage, pos: int,
                      end: int) -> int:
        """The contiguous frontier from ``pos``: how far a reader can go
        right now, combining verified-on-disk pieces and live span
        watermarks (they interleave: a span lands, the next one opens)."""
        cur = pos
        spans = ()
        tr = self._tasks.get(task_id)
        if tr is not None:
            spans = tr.spans
        covered = getattr(storage, "covered_prefix", None)
        while cur < end:
            nxt = cur
            if covered is not None:
                nxt = max(nxt, covered(cur, end))
            for span in spans:
                if not span.retired and span.base <= cur < span.end():
                    nxt = max(nxt, min(span.end(), end))
            if nxt == cur:
                break
            cur = nxt
        return cur

    def read_span(self, task_id: str, pos: int, limit: int) -> bytes | None:
        """Bytes at ``pos`` from a live span (the not-yet-on-disk part of
        the frontier); None when only storage covers it."""
        tr = self._tasks.get(task_id)
        if tr is None:
            return None
        for span in tr.spans:
            out = span.read(pos, limit)
            if out:
                return out
        return None

    def inflight_infos(self, task_id: str) -> list[PieceInfo]:
        """Piece metadata of every live span — the announce-ahead signal:
        these pieces are arriving NOW and a child may begin pulling them
        (the streaming range path serves to the watermark). Digests ride
        along when the span knows them (P2P pulls do; back-source spans
        may not — the child then lands with a computed digest, the same
        trust it gets fetching the origin itself)."""
        tr = self._tasks.get(task_id)
        if tr is None:
            return []
        out: list[PieceInfo] = []
        for span in tr.spans:
            if not span.retired:
                out.extend(span.pieces)
        return out

    def progress(self, task_id: str, storage) -> tuple[int, int]:
        """(landed_pieces, total_pieces) — the advertised watermark for
        the ``X-DF-Piece-Progress`` header and PEX digests."""
        landed = len(getattr(storage.md, "pieces", ()) or ())
        tr = self._tasks.get(task_id)
        total = getattr(storage.md, "total_piece_count", -1)
        if total < 0 and tr is not None:
            total = tr.total_pieces
        return landed, total

    # -- debug ---------------------------------------------------------

    def _span_count(self) -> int:
        return sum(len(tr.spans) for tr in self._tasks.values())

    def snapshot(self) -> dict:
        return {
            "tasks": {
                tid: {
                    "refs": tr.refs,
                    "waiters": len(tr.waiters),
                    "spans": [{"base": s.base, "size": s.size,
                               "watermark": s.watermark,
                               "pieces": [p.piece_num for p in s.pieces]}
                              for s in tr.spans],
                }
                for tid, tr in self._tasks.items()
            },
            "ts": time.time(),
        }
