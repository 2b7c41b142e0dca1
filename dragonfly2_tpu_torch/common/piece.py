"""Piece math: how a content length is cut into pieces.

Behavior parity with the reference's adaptive sizing
(``internal/util/util.go:24-40``): 4 MiB base; for content beyond 200 MiB the
piece size grows ~1 MiB per extra 100 MiB, capped at 15 MiB. Sizes here are
additionally rounded to a 4 MiB multiple when grown so pieces stay aligned for
device transfer (host-to-device copies like large aligned chunks).
"""

from __future__ import annotations

from dataclasses import dataclass

from .unit import MiB

DEFAULT_PIECE_SIZE = 4 * MiB
MAX_PIECE_SIZE = 16 * MiB          # reference caps at 15 MiB; we keep a pow2 cap

# One host-to-device copy unit. Shared by the DeviceIngest auto-sizer (daemon) and
# the back-source group sizer (piece_manager): ingest shards complete
# progressively — and their transfers overlap the download — only while a
# back-source work-queue group is no larger than one ingest shard, so the two
# sizes must move together.
INGEST_DMA_UNIT_BYTES = 32 * MiB
_GROWTH_STEP_BYTES = 100 * MiB     # grow 1 MiB per 100 MiB beyond the threshold
_GROWTH_THRESHOLD = 200 * MiB


def compute_piece_size(content_length: int) -> int:
    """Adaptive piece size for a task of ``content_length`` bytes."""
    if content_length <= _GROWTH_THRESHOLD:
        return DEFAULT_PIECE_SIZE
    grown = DEFAULT_PIECE_SIZE + ((content_length - _GROWTH_THRESHOLD) // _GROWTH_STEP_BYTES) * MiB
    # round up to 4 MiB multiples: aligned pieces coalesce into clean device shards
    aligned = ((grown + 4 * MiB - 1) // (4 * MiB)) * (4 * MiB)
    return min(aligned, MAX_PIECE_SIZE)


def piece_count(content_length: int, piece_size: int) -> int:
    if content_length <= 0:
        return 0
    return (content_length + piece_size - 1) // piece_size


def piece_range(piece_num: int, piece_size: int, content_length: int) -> tuple[int, int]:
    """(offset, length) of piece ``piece_num``; final piece may be short."""
    off = piece_num * piece_size
    if off >= content_length:
        raise ValueError(f"piece {piece_num} out of range for length {content_length}")
    return off, min(piece_size, content_length - off)


@dataclass(frozen=True)
class Range:
    """A half-open byte range [start, start+length) of a task's content."""

    start: int
    length: int

    @property
    def end(self) -> int:  # exclusive
        return self.start + self.length

    def http_header(self) -> str:
        return f"bytes={self.start}-{self.start + self.length - 1}"


def parse_http_range(header: str, total: int) -> Range:
    """Parse an HTTP Range header value against a known total length.

    Supports "bytes=a-b", "bytes=a-", "bytes=-n" (suffix). Single range only.
    """
    if not header.startswith("bytes="):
        raise ValueError(f"unsupported range unit: {header!r}")
    spec = header[len("bytes="):]
    if "," in spec:
        raise ValueError("multi-range not supported")
    first, _, last = spec.partition("-")
    if first == "":                      # suffix: last N bytes
        if not last.isdigit():
            raise ValueError(f"invalid suffix range: {header!r}")
        n = min(int(last), total)
        if n == 0:
            raise ValueError("zero-length suffix range")
        return Range(total - n, n)
    if not first.isdigit() or (last and not last.isdigit()):
        raise ValueError(f"invalid range: {header!r}")
    start = int(first)
    if start >= total:
        raise ValueError(f"range start {start} beyond total {total}")
    if last == "":
        return Range(start, total - start)
    end = int(last)                      # inclusive per HTTP
    if end < start:
        raise ValueError(f"range end {end} before start {start}")
    return Range(start, min(end + 1, total) - start)
