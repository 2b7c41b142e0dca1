"""Sharded-task math: manifest geometry, piece mapping, readiness, affinity.

Counterpart of ``dragonfly2_tpu/common/sharding.py``. A shard is a NAMED
contiguous byte range of the task's content (``idl.ShardInfo``: name +
[start, start+size) + dtype/shape + an optional per-shard digest).

  * ``pieces_for_shards`` maps a requested shard subset onto the piece
    numbers that cover it (a boundary mid-piece claims the whole piece);
  * ``ShardTracker`` watches verified byte spans land (any order, any
    overlap) and answers which shards just became fully covered;
  * ``split_affinity`` is the scheduler's deterministic disjoint
    assignment (bounded-load rendezvous hashing of shard names over the
    co-located replicas), byte for byte the reference's: two schedulers,
    or a replay, rule identically with no shared state.

Synchronous and wall-clock-free: it runs on the daemon's landing path.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence


def parse_shard_names(csv: str) -> list[str]:
    """``UrlMeta.shards`` wire form ("a,b,c") -> names, order kept,
    duplicates dropped."""
    out: list[str] = []
    for name in csv.split(","):
        name = name.strip()
        if name and name not in out:
            out.append(name)
    return out


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


def pieces_for_shards(shards: Iterable, piece_size: int,
                      total_pieces: int) -> set[int]:
    """Piece numbers covering the given shards. A shard boundary mid-piece
    claims the whole piece (the piece is the transfer/verify unit)."""
    if piece_size <= 0:
        raise ValueError("piece_size must be known")
    out: set[int] = set()
    for s in shards:
        first = s.range_start // piece_size
        last = (s.range_start + s.range_size - 1) // piece_size
        if total_pieces >= 0:
            last = min(last, total_pieces - 1)
        out.update(range(first, last + 1))
    return out


def split_affinity(shard_names: Sequence[str],
                   members: Iterable[str]) -> dict[str, str]:
    """Deterministic BALANCED disjoint assignment: shard name -> owner.

    Bounded-load rendezvous: every member scores every shard via
    sha256(member | shard); shards are processed in a deterministic hash
    order and each goes to its highest-scoring member still under the
    per-member cap of ceil(shards / members). No coordination, no state
    — any party holding the same (shards, members) computes the same
    split, and membership churn moves only a ~1/n slice. The cap is the
    point: naked rendezvous is uniform in expectation but a 6-shard /
    2-replica rollout can land every shard on one host (observed live),
    which re-raises exactly the tree fetch the affinity exists to
    split — bounded load makes the spread exact, not probabilistic.
    Independent of input order (the processing order is hash-derived)."""
    pool = sorted(set(members))
    if not pool:
        return {}
    names = list(dict.fromkeys(shard_names))
    cap = -(-len(names) // len(pool))
    load = {m: 0 for m in pool}
    out: dict[str, str] = {}

    def score(m: str, n: str) -> bytes:
        return hashlib.sha256(f"{m}|{n}".encode()).digest()

    for name in sorted(names,
                       key=lambda n: hashlib.sha256(n.encode()).digest()):
        ranked = sorted(pool, key=lambda m: score(m, name), reverse=True)
        owner = next((m for m in ranked if load[m] < cap), ranked[0])
        load[owner] += 1
        out[name] = owner
    return out


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

    ``shards`` are ShardInfo-likes (name/range_start/range_size) — the
    manifest order is preserved in ``index_of``. ``requested`` narrows
    tracking to a subset (None = every shard). Spans may arrive in any
    order, overlap, duplicate, or straddle shard boundaries; a shard is
    READY exactly once, when its byte range is fully covered."""

    def __init__(self, shards: Sequence, requested: Sequence[str] | None = None):
        want = set(requested) if requested is not None else None
        self.shards = [s for s in shards
                       if want is None or s.name in want]
        if requested is not None:
            missing = set(requested) - {s.name for s in shards}
            if missing:
                raise ValueError(
                    f"requested shards not in manifest: {sorted(missing)}")
        # sorted by range for the overlap scan
        self._order = sorted(self.shards, key=lambda s: s.range_start)
        self._cov: dict[str, _Coverage] = {s.name: _Coverage()
                                           for s in self.shards}
        self.ready: dict[str, float] = {}       # name -> t of completion

    @property
    def total(self) -> int:
        return len(self.shards)

    def pending(self) -> list[str]:
        return [s.name for s in self.shards if s.name not in self.ready]

    def requested_bytes(self) -> int:
        return sum(s.range_size for s in self.shards)

    def shard_bytes_in(self, start: int, end: int) -> int:
        """Bytes of [start, end) that fall inside TRACKED shards — the
        honest denominator for byte accounting (manifest gaps and
        un-requested shards contribute nothing)."""
        total = 0
        for s in self._order:
            s_end = s.range_start + s.range_size
            if s_end <= start:
                continue
            if s.range_start >= end:
                break
            total += min(end, s_end) - max(start, s.range_start)
        return total

    def needed_pieces(self, piece_size: int, total_pieces: int) -> set[int]:
        return pieces_for_shards(self.shards, piece_size, total_pieces)

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
