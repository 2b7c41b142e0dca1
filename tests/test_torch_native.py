"""The port's native storage library, held against the JAX package's.

The port builds ``dragonfly2_tpu_torch/storage/native/dfnative.cc`` (its
own copy of ``native/dfnative.cc``) at first use with g++. Checked here on
the same seeded buffers, made with numpy:

* the library is built from the port's copy, and its crc32c equals the
  reference's pure-Python ``_crc32c_py`` on buffers of 0 B, 1 B, 4 MiB and
  an odd size (also chained over uneven chunks);
* ``span_write`` and ``piece_write`` leave the same file bytes and crcs
  as the reference's ``native.py`` bound to the reference's own source,
  and leave the caller's buffer free of exports;
* ``preferred_piece_algo()`` is crc32c once the library loads, and a
  task's piece digests are then crc32c, as the reference's are when its
  library is built;
* a thread that asks for the library while another is loading it waits
  for the load, so no piece takes the fallback digest meanwhile (the
  reference's ``load`` answers None there).

Tolerances are exact. The ``ref_native_lib`` fixture builds the
reference's ``native/dfnative.cc`` into the test's temporary directory
(nothing is written under ``native/``) and binds it to the reference's
``native`` module for the test only.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np
import pytest

from dragonfly2_tpu.common import digest as ref_digest
from dragonfly2_tpu.storage import native as ref_native
from dragonfly2_tpu.storage.manager import StorageConfig as RefStorageConfig
from dragonfly2_tpu.storage.manager import StorageManager as RefStorageManager
from dragonfly2_tpu.storage.metadata import TaskMetadata as RefTaskMetadata
from dragonfly2_tpu_torch.common import digest
from dragonfly2_tpu_torch.storage import native
from dragonfly2_tpu_torch.storage.manager import StorageConfig, StorageManager
from dragonfly2_tpu_torch.storage.metadata import TaskMetadata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SOURCE = os.path.join(REPO, "native", "dfnative.cc")
MiB = 1 << 20
SIZES = [0, 1, 4 * MiB, 3 * MiB + 12345]


@pytest.fixture
def ref_native_lib(tmp_path, monkeypatch):
    """The reference's library, built from its own source into
    ``tmp_path`` with the port's compiler flags, bound for this test."""
    out = str(tmp_path / "libdfnative-ref.so")
    subprocess.run(native.build_command(out)[:-1] + [REF_SOURCE],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    ref_native._bind(lib)
    monkeypatch.setattr(ref_native, "_lib", lib)
    return lib


def _buf(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def test_library_builds_from_the_ports_copy():
    assert native.SOURCE.startswith(os.path.join(REPO,
                                                 "dragonfly2_tpu_torch"))
    with open(native.SOURCE) as f, open(REF_SOURCE) as g:
        ours, theirs = f.read(), g.read()
    # the same code: only the file's header comment names its own package
    body = ours.index("#include")
    assert ours[body:] == theirs[theirs.index("#include"):]
    assert native.build() == native.LIBRARY
    assert os.path.getmtime(native.LIBRARY) >= os.path.getmtime(
        native.SOURCE)
    assert native.available()
    for sym in ("df_hash", "df_crc32c", "df_piece_write", "df_span_write",
                "df_piece_read"):
        assert hasattr(native.load(), sym)


@pytest.mark.parametrize("size", SIZES)
def test_crc32c_matches_the_reference_python_loop(size):
    data = _buf(size, seed=size)
    want = f"{ref_digest._crc32c_py(data):08x}"
    assert native.hash_bytes("crc32c", data) == want
    assert digest.hash_bytes("crc32c", data) == want
    assert f"{digest._crc32c_py(data):08x}" == want
    # chained over uneven chunks, as Hasher.update feeds it
    h = digest.Hasher("crc32c")
    for lo in range(0, size, 1_000_003):
        h.update(data[lo:lo + 1_000_003])
    assert h.hexdigest() == want


@pytest.mark.parametrize("size", SIZES)
def test_sha256_and_md5_match_the_reference(size, ref_native_lib):
    data = _buf(size, seed=size + 1)
    for algo in ("sha256", "md5"):
        assert native.hash_bytes(algo, data) == ref_native.hash_bytes(
            algo, data)


@pytest.mark.parametrize("sizes", [[4 * MiB], [1, 4 * MiB, 777],
                                   [3 * MiB + 12345, 2 * MiB, 5]])
def test_span_and_piece_write_match_the_reference(tmp_path, sizes,
                                                  ref_native_lib):
    data = _buf(sum(sizes), seed=len(sizes))
    offset = 4096
    out = {}
    for name, mod in (("port", native), ("ref", ref_native)):
        span_path = tmp_path / f"{name}-span"
        piece_path = tmp_path / f"{name}-piece"
        for p in (span_path, piece_path):
            p.write_bytes(b"\0" * 100)
        fd = os.open(span_path, os.O_RDWR)
        try:
            crcs = mod.span_write(fd, offset, bytearray(data), sizes)
        finally:
            os.close(fd)
        piece_crcs = []
        pos = 0
        for n in sizes:
            piece_crcs.append(mod.piece_write(
                str(piece_path), offset + pos, memoryview(data)[pos:pos + n]))
            pos += n
        out[name] = (crcs, piece_crcs, span_path.read_bytes(),
                     piece_path.read_bytes(),
                     mod.piece_read(str(span_path), offset, len(data)))
    assert out["port"] == out["ref"]
    crcs, piece_crcs, span_bytes, piece_bytes, back = out["port"]
    assert crcs == piece_crcs == [
        f"{ref_digest._crc32c_py(data[lo:lo + n]):08x}"
        for lo, n in zip(np.cumsum([0] + sizes[:-1]), sizes)]
    assert span_bytes == piece_bytes == b"\0" * 100 + b"\0" * (
        offset - 100) + data
    assert back == data


def test_span_write_leaves_the_buffer_reusable(tmp_path):
    """A landed piece buffer goes back to the piece-buffer pool: the call
    leaves no buffer export behind (the pool drops an exported buffer, and
    a fresh 32 MiB allocation per span halved the fetch rate of four
    replicas on one host)."""
    buf = bytearray(_buf(2 * MiB, seed=3))
    fd = os.open(tmp_path / "f", os.O_RDWR | os.O_CREAT)
    try:
        view = memoryview(buf)
        native.span_write(fd, 0, view[:MiB], [MiB])
        native.span_write(fd, MiB, buf, [2 * MiB])
        native.crc32c_update(view, 0)
        view.release()
    finally:
        os.close(fd)
    buf.append(0)                # raises BufferError while exported
    assert buf.pop() == 0


def test_span_write_refuses_a_short_buffer():
    with pytest.raises(ValueError):
        native.span_write(0, 0, b"abc", [2, 2])


def test_stores_land_crc32c_digests_in_both_packages(tmp_path,
                                                     ref_native_lib):
    """With both libraries loaded, both packages' stores prefer crc32c and
    record the same piece digests for the same span and pieces."""
    assert digest.preferred_piece_algo() == "crc32c"
    assert ref_digest.preferred_piece_algo() == "crc32c"
    data = _buf(10 * MiB + 3, seed=9)
    size = 4 * MiB
    spans = [(n, n * size, min(size, len(data) - n * size), "")
             for n in range(3)]
    got = {}
    for name, mgr, md_cls in (
            ("port", StorageManager(StorageConfig(
                data_dir=str(tmp_path / "port"))), TaskMetadata),
            ("ref", RefStorageManager(RefStorageConfig(
                data_dir=str(tmp_path / "ref"))), RefTaskMetadata)):
        ts = mgr.register_task(md_cls(task_id="a" * 64))
        metas = ts.write_span(spans[:2], data[:2 * size])[0]
        metas.append(ts.write_piece(2, 2 * size, data[2 * size:]))
        got[name] = ([m.digest for m in metas],
                     open(ts.data_path(), "rb").read())
    assert got["port"] == got["ref"]
    assert all(d.startswith("crc32c:") for d in got["port"][0])
    assert got["port"][1] == data


def test_a_caller_during_the_first_load_waits_for_it(monkeypatch):
    """Storage threads land a pull's first pieces at once; each asks for
    the library. One that asks while another is still loading it must get
    the library, not None (which would give its piece a crc32 digest)."""
    path = native.build()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    entered, release = threading.Event(), threading.Event()

    def slow_build():
        entered.set()
        release.wait(10)
        return path

    monkeypatch.setattr(native, "build", slow_build)
    got = {}
    first = threading.Thread(target=lambda: got.setdefault(
        "first", native.load()))
    first.start()
    assert entered.wait(10)
    second = threading.Thread(target=lambda: got.setdefault(
        "second", (native.load(), digest.preferred_piece_algo())))
    second.start()
    second.join(0.3)
    assert second.is_alive()            # waits for the load in flight
    release.set()
    first.join(10)
    second.join(10)
    lib, algo = got["second"]
    assert got["first"] is not None and lib is got["first"]
    assert algo == "crc32c"
