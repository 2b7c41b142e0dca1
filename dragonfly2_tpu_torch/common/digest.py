"""Digest parsing and verification ("algo:hex" strings).

Counterpart of ``dragonfly2_tpu/common/digest.py``. Per-piece digests
are hardware crc32c from the native storage library when it loads, zlib's
crc32 otherwise (``preferred_piece_algo``), as in the reference; a crc32c
digest is checked with the pure-Python loop only when the library is
absent.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Iterator

from ..storage import native

SUPPORTED = ("sha256", "sha512", "sha1", "md5", "crc32c", "crc32",
             "blake2b")

_HEX_LEN = {"sha256": 64, "sha512": 128, "sha1": 40, "md5": 32, "crc32c": 8,
            "crc32": 8, "blake2b": 64}
_HEX_CHARS = set("0123456789abcdef")


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
        if algo in ("crc32c", "crc32"):
            self._crc = 0
        elif algo == "blake2b":
            self._h = hashlib.blake2b(digest_size=32)
        else:
            self._h = hashlib.new(algo)

    def update(self, data: bytes | memoryview) -> None:
        if self.algo == "crc32":
            self._crc = zlib.crc32(data, self._crc) & 0xFFFFFFFF
        elif self.algo == "crc32c":
            crc = native.crc32c_update(data, self._crc)
            self._crc = crc if crc is not None else _crc32c_py(data,
                                                               self._crc)
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


def preferred_piece_algo() -> str:
    """Per-piece digest default: hardware crc32c when the native library
    loads, zlib's C crc32 otherwise, never the pure-Python crc32c loop."""
    return "crc32c" if native.available() else "crc32"


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


# -- pure-Python crc32c (Castagnoli), used when the library is absent ------

_CRC32C_POLY = 0x82F63B78


def _crc32c_table() -> list[int]:
    tbl = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        tbl.append(c)
    return tbl


_CRC32C_TABLE = _crc32c_table()


def _crc32c_py(data, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    tbl = _CRC32C_TABLE
    for b in memoryview(data).cast("B"):
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF
