"""Sharded-task math: manifest geometry, piece mapping, readiness.

Counterpart of ``dragonfly2_tpu/common/sharding.py`` without the
scheduler's affinity split. A shard is a NAMED contiguous byte range of
the task's content (``idl.ShardInfo``: name + [start, start+size) +
dtype/shape + an optional per-shard digest). ``ShardTracker`` watches
verified byte spans land (any order, any overlap) and answers which
shards just became fully covered. Requested shard subsets (and the piece
mapping they need) wait for the P2P slice. Synchronous and wall-clock-free: it
runs on the daemon's landing path.
"""

from __future__ import annotations

from typing import Sequence


def validate_manifest(shards: Sequence, content_length: int = -1) -> None:
    """Raise ValueError on a malformed manifest: empty/duplicate names,
    non-positive sizes, overlapping ranges, or ranges beyond the content
    (when its length is known). Gaps are LEGAL — a manifest may name only
    the tensors worth landing (optimizer state can stay unnamed)."""
    seen: set[str] = set()
    spans: list[tuple[int, int, str]] = []
    for s in shards:
        if not s.name:
            raise ValueError("shard with empty name")
        if s.name in seen:
            raise ValueError(f"duplicate shard name {s.name!r}")
        seen.add(s.name)
        if s.range_size <= 0:
            raise ValueError(f"shard {s.name}: non-positive size")
        if s.range_start < 0:
            raise ValueError(f"shard {s.name}: negative start")
        if content_length >= 0 and s.range_start + s.range_size > content_length:
            raise ValueError(
                f"shard {s.name}: [{s.range_start}, "
                f"{s.range_start + s.range_size}) beyond content "
                f"{content_length}")
        spans.append((s.range_start, s.range_start + s.range_size, s.name))
    spans.sort()
    for (_, e0, n0), (s1, _, n1) in zip(spans, spans[1:]):
        if s1 < e0:
            raise ValueError(f"shards {n0} and {n1} overlap")


class _Coverage:
    """Merged [start, end) interval set — the same arithmetic as
    ``tpu.hbm_sink.CoverageMap`` without its thread lock (the tracker
    runs on the daemon's event loop)."""

    __slots__ = ("_ranges",)

    def __init__(self) -> None:
        self._ranges: list[tuple[int, int]] = []

    def add(self, start: int, end: int) -> None:
        if start >= end:
            return
        lo, hi = start, end
        out: list[tuple[int, int]] = []
        for s, e in self._ranges:
            if e < lo or s > hi:
                out.append((s, e))
            else:
                lo, hi = min(lo, s), max(hi, e)
        out.append((lo, hi))
        out.sort()
        self._ranges = out

    def covered(self) -> int:
        return sum(e - s for s, e in self._ranges)


class ShardTracker:
    """Watches verified byte spans land; answers which shards completed.

    ``shards`` are ShardInfo-likes (name/range_start/range_size), kept in
    manifest order. Spans may arrive in any order, overlap, duplicate, or
    straddle shard boundaries; a shard is READY exactly once, when its
    byte range is fully covered."""

    def __init__(self, shards: Sequence):
        self.shards = list(shards)
        # sorted by range for the overlap scan
        self._order = sorted(self.shards, key=lambda s: s.range_start)
        self._cov: dict[str, _Coverage] = {s.name: _Coverage()
                                           for s in self.shards}
        self.ready: dict[str, float] = {}       # name -> t of completion

    @property
    def total(self) -> int:
        return len(self.shards)

    def shard_for(self, name: str):
        for s in self.shards:
            if s.name == name:
                return s
        return None

    def on_span(self, start: int, end: int, t: float = 0.0) -> list[str]:
        """A verified byte span landed; returns names of shards this span
        COMPLETED (empty for most spans). Duplicate/overlapping spans are
        merged; an already-ready shard can never re-complete."""
        done: list[str] = []
        for s in self._order:
            s_end = s.range_start + s.range_size
            if s_end <= start:
                continue
            if s.range_start >= end:
                break
            if s.name in self.ready:
                continue
            cov = self._cov[s.name]
            cov.add(max(start, s.range_start), min(end, s_end))
            if cov.covered() >= s.range_size:
                self.ready[s.name] = t
                done.append(s.name)
        return done
