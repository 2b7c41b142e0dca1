"""Digest parsing and verification ("algo:hex" strings).

Counterpart of ``dragonfly2_tpu/common/digest.py`` without the native
library: hashlib and zlib only. Per-piece digests are zlib's crc32 (the
reference's own choice when its native crc32c library is not built).
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Iterator

SUPPORTED = ("sha256", "sha512", "sha1", "md5", "crc32", "blake2b")

_HEX_LEN = {"sha256": 64, "sha512": 128, "sha1": 40, "md5": 32, "crc32": 8,
            "blake2b": 64}
_HEX_CHARS = set("0123456789abcdef")

PIECE_ALGO = "crc32"


def parse(digest: str) -> tuple[str, str]:
    """Split "sha256:abcd..." into (algo, hexvalue); validates algo + hex + length."""
    algo, sep, value = digest.partition(":")
    if not sep or not value:
        raise ValueError(f"invalid digest {digest!r}; want 'algo:hex'")
    algo = algo.lower()
    if algo not in SUPPORTED:
        raise ValueError(f"unsupported digest algorithm {algo!r}")
    value = value.lower()
    if len(value) != _HEX_LEN[algo] or not set(value) <= _HEX_CHARS:
        raise ValueError(f"invalid {algo} digest value {value!r}")
    return algo, value


class Hasher:
    """Incremental hasher covering all SUPPORTED algos."""

    def __init__(self, algo: str):
        self.algo = algo
        self._crc: int | None = None
        self._h = None
        if algo == "crc32":
            self._crc = 0
        elif algo == "blake2b":
            self._h = hashlib.blake2b(digest_size=32)
        else:
            self._h = hashlib.new(algo)

    def update(self, data: bytes | memoryview) -> None:
        if self._crc is not None:
            self._crc = zlib.crc32(data, self._crc) & 0xFFFFFFFF
        else:
            self._h.update(data)

    def hexdigest(self) -> str:
        if self._crc is not None:
            return f"{self._crc:08x}"
        return self._h.hexdigest()


def hash_bytes(algo: str, data: bytes | memoryview) -> str:
    h = Hasher(algo)
    h.update(data)
    return h.hexdigest()


def hash_stream(algo: str, chunks: Iterator[bytes]) -> str:
    h = Hasher(algo)
    for c in chunks:
        h.update(c)
    return h.hexdigest()


def verify(digest: str, data: bytes | memoryview) -> bool:
    algo, want = parse(digest)
    return hash_bytes(algo, data) == want


def for_bytes(algo: str, data: bytes | memoryview) -> str:
    return f"{algo}:{hash_bytes(algo, data)}"
