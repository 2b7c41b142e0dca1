"""ctypes bindings to the daemon's native storage library.

Counterpart of ``dragonfly2_tpu/storage/native.py``. The library is the
port's own copy of the reference's C++ source (``native/dfnative.cc``
beside this module): hardware crc32c, sha256 and md5 piece hashing, and
fused pwrite-plus-crc32c piece and span landing. It is built from that
source at first use, with ``g++ -O3 -fPIC -std=c++17`` (plus ``-msse4.2``
on x86_64, as the reference's Makefile builds it), into ``native/build/``,
and rebuilt when the source is newer than the library. Every caller has a
Python path for when no compiler is present (``load()`` is None then).
"""

from __future__ import annotations

import ctypes
import logging
import os
import platform
import subprocess
import threading

log = logging.getLogger("df.storage.native")

_HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
SOURCE = os.path.join(_HERE, "dfnative.cc")
LIBRARY = os.path.join(_HERE, "build", "libdfnative.so")
BUILD_TIMEOUT_S = 300.0

_lib = None
_lib_lock = threading.Lock()
_load_attempted = False


def build_command(out: str) -> list[str]:
    cmd = ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]
    if platform.machine() == "x86_64":
        cmd.append("-msse4.2")       # the hardware crc32c instruction
    return cmd + ["-shared", "-o", out, SOURCE]


def build() -> str:
    """Build the library from ``SOURCE`` unless an up-to-date one exists;
    return its path. Processes that build at once each write a file of
    their own and rename it into place. Raises ``OSError`` when no
    compiler is found, ``subprocess.CalledProcessError`` when it fails."""
    try:
        if os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
            return LIBRARY
    except OSError:
        pass
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(build_command(tmp), check=True, capture_output=True,
                       timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIBRARY


def load():
    """Build (when needed) and load the library once; None when it cannot
    be built or loaded. A thread that calls while another builds or loads
    waits for that attempt's outcome: the attempt is marked done only
    after ``_lib`` is set, so no piece lands with the fallback digest
    while the library is still loading."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_attempted:
            return _lib
        try:
            lib = ctypes.CDLL(build())
            _bind(lib)
            _lib = lib
        except (OSError, subprocess.SubprocessError) as exc:
            detail = getattr(exc, "stderr", b"") or b""
            log.warning("native storage library unavailable (%s) %s", exc,
                        detail.decode(errors="replace")[-2000:])
        finally:
            _load_attempted = True
    return _lib


def _bind(lib) -> None:
    # int df_hash(const char* algo, const uint8_t* data, size_t n,
    #             char* hex_out, size_t hex_cap)
    lib.df_hash.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
                            ctypes.c_char_p, ctypes.c_size_t]
    lib.df_hash.restype = ctypes.c_int
    # uint32 df_crc32c(const uint8_t* data, size_t n, uint32 seed): chainable
    lib.df_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_uint32]
    lib.df_crc32c.restype = ctypes.c_uint32
    # int df_piece_write(path, offset, data, n, uint32* crc_out)
    lib.df_piece_write.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.POINTER(ctypes.c_uint32)]
    lib.df_piece_write.restype = ctypes.c_int
    # int64 df_piece_read(path, offset, uint8* out, n)
    lib.df_piece_read.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_char_p, ctypes.c_size_t]
    lib.df_piece_read.restype = ctypes.c_int64
    # int df_span_write(fd, offset, data, uint64* piece_sizes, n_pieces,
    #                   uint32* crcs_out): one pwrite traversal, per-piece
    # crc32c folded in
    lib.df_span_write.argtypes = [ctypes.c_int, ctypes.c_uint64,
                                  ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_uint32)]
    lib.df_span_write.restype = ctypes.c_int


def available() -> bool:
    return load() is not None


def _buf_arg(data) -> tuple:
    """(c_char_p-compatible argument, length) without copying writable
    buffers: bytes pass through; bytearray and writable memoryviews expose
    their storage as a ctypes array over them. Only readonly views pay a
    copy. The array is handed over as it is, never through
    ``ctypes.cast``, whose result and source reference each other: that
    cycle outlives the call until the garbage collector runs, and its
    buffer export keeps the piece buffer pool from reusing the buffer."""
    if isinstance(data, bytes):
        return data, len(data)
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.readonly or not mv.contiguous:
        b = mv.tobytes()
        return b, len(b)
    n = mv.nbytes
    return (ctypes.c_char * n).from_buffer(mv), n


def crc32c_update(data: bytes | bytearray | memoryview,
                  seed: int) -> int | None:
    """Chainable crc32c, or None when the library is absent."""
    lib = load()
    if lib is None:
        return None
    ptr, n = _buf_arg(data)
    return int(lib.df_crc32c(ptr, n, seed))


def hash_bytes(algo: str, data: bytes | bytearray | memoryview) -> str | None:
    """Hex digest (sha256, md5 or crc32c), or None to signal fallback."""
    lib = load()
    if lib is None:
        return None
    ptr, n = _buf_arg(data)
    out = ctypes.create_string_buffer(129)
    if lib.df_hash(algo.encode(), ptr, n, out, len(out)) != 0:
        return None
    return out.value.decode()


def piece_write(path: str, offset: int,
                data: bytes | bytearray | memoryview) -> str | None:
    """pwrite ``data`` at ``offset`` while computing its crc32c in the same
    pass. Returns the crc32c hex, or None when the library is absent.
    Raises OSError on IO failure."""
    lib = load()
    if lib is None:
        return None
    ptr, n = _buf_arg(data)
    crc = ctypes.c_uint32(0)
    rc = lib.df_piece_write(path.encode(), offset, ptr, n, ctypes.byref(crc))
    if rc < 0:
        raise OSError(-rc, os.strerror(-rc), path)
    return f"{crc.value:08x}"


def span_write(fd: int, offset: int, data: bytes | bytearray | memoryview,
               piece_sizes: list[int]) -> list[str] | None:
    """One pwrite traversal of a contiguous span at ``offset`` through an
    open ``fd``, folding each piece's crc32c as it goes. Returns the
    per-piece crc32c hex list, or None when the library is absent.
    Raises OSError on IO failure."""
    lib = load()
    if lib is None:
        return None
    ptr, n = _buf_arg(data)
    if n != sum(piece_sizes):
        raise ValueError(f"span buffer {n} != sum(piece_sizes) "
                         f"{sum(piece_sizes)}")
    sizes = (ctypes.c_uint64 * len(piece_sizes))(*piece_sizes)
    crcs = (ctypes.c_uint32 * len(piece_sizes))()
    rc = lib.df_span_write(fd, offset, ptr, sizes, len(piece_sizes), crcs)
    if rc < 0:
        raise OSError(-rc, os.strerror(-rc))
    return [f"{c:08x}" for c in crcs]


def piece_read(path: str, offset: int, length: int) -> bytes | None:
    """pread a piece into a fresh buffer, or None when the library is
    absent. Raises OSError on IO failure; a read past EOF returns the
    bytes available."""
    lib = load()
    if lib is None:
        return None
    buf = bytearray(length)
    got = lib.df_piece_read(path.encode(), offset,
                            (ctypes.c_char * length).from_buffer(buf),
                            length)
    if got < 0:
        raise OSError(-got, os.strerror(-got), path)
    return bytes(buf) if got == length else bytes(buf[:got])
