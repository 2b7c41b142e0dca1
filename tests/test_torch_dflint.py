"""dflint on the port: the static analyzer's tier-1 gate and per-rule
fixtures through ``dragonfly2_tpu_torch.tools.dflint_rules``, with the
port's engine and the reference's held to each other.

* The reference's ``tests/test_dflint.py`` cases, each with the same
  assertions on the port's engine. ``lint_source``, ``lint_file`` and
  ``lint_paths`` below run the port's engine and the reference's on the
  same input and fail unless the two lists of ``Finding.as_dict()`` are
  equal (for ``lint_paths``, the file and cache counts too): every
  fixture goes through both engines.
* The CLI: ``python -m dragonfly2_tpu_torch.tools.dflint`` exit codes,
  ``--json``, ``--stats``, ``--changed``, and ``changed_files`` scoped to
  the port's root.
* Package-wide parity and the gate, on one cold run per package and
  engine (module-scoped fixtures): the port's engine over
  ``dragonfly2_tpu/`` equals the reference's, the reference's engine over
  ``dragonfly2_tpu_torch/`` equals the port's, the port package is clean,
  its suppressions carry reasons and number
  ``chip_smoke.DFLINT_SUPPRESSED``, and its cold run stays under the
  reference's 15 s budget.
* The triage: the scheduler announcer's ``bind_model`` hashes its blob
  off the loop, and the piece downloader's ``progress``/``failed``
  closures never touch a buffer after it is back in the pool.

The reference's suite owns ``.dflint_cache.json`` and may run beside this
file, so the reference engine's package-wide runs here neither read nor
write it; the port's engine keeps ``.dflint_torch_cache.json``.
"""

import asyncio
import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import types

import pytest

import chip_smoke
import dragonfly2_tpu.tools.dflint_rules as ref_rules
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.daemon import piece_downloader as pd
from dragonfly2_tpu_torch.idl.messages import PieceInfo
from dragonfly2_tpu_torch.scheduler import announcer as announcer_mod
from dragonfly2_tpu_torch.tools import dflint_rules as port_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dragonfly2_tpu_torch")
REF_PKG = os.path.join(REPO, "dragonfly2_tpu")
# the reference's gate: its package with every finding suppressed
REF_SUPPRESSED = 61
_STAT_KEYS = ("files", "modules_indexed", "cache_hits", "cache_misses")


def _dicts(findings):
    return [f.as_dict() for f in findings]


def _same(port, ref):
    assert _dicts(port) == _dicts(ref)
    return port


def lint_source(src, path, **kw):
    return _same(port_rules.lint_source(src, path, **kw),
                 ref_rules.lint_source(src, path, **kw))


def lint_file(path, **kw):
    return _same(port_rules.lint_file(path, **kw),
                 ref_rules.lint_file(path, **kw))


def lint_paths(paths, *, stats=None, **kw):
    """Both engines over ``paths``. Each keeps its own cache file under
    ``repo_root``, so the two caches go through the same history and
    their hit and miss counts must agree as well."""
    port_stats, ref_stats = {}, {}
    port = port_rules.lint_paths(paths, stats=port_stats, **kw)
    ref = ref_rules.lint_paths(paths, stats=ref_stats, **kw)
    _same(port, ref)
    assert ({k: port_stats[k] for k in _STAT_KEYS}
            == {k: ref_stats[k] for k in _STAT_KEYS})
    if stats is not None:
        stats.update(port_stats)
    return port



def run_lint(src: str, path: str = "mod.py", **kw):
    return lint_source(textwrap.dedent(src), path, **kw)


def active(findings):
    return [f for f in findings if not f.suppressed]


def codes(findings):
    return [f.code for f in active(findings)]


# ---------------------------------------------------------------------------
# DF001 — blocking call on the event loop
# ---------------------------------------------------------------------------

class TestDF001:
    def test_flags_open_sleep_and_handle_reads_in_async(self):
        fs = run_lint("""
            import time

            async def work(path):
                time.sleep(1)
                with open(path) as f:
                    data = f.read()
                return data
        """)
        assert codes(fs) == ["DF001", "DF001", "DF001"]
        msgs = " ".join(f.message for f in fs)
        assert "time.sleep" in msgs and "open()" in msgs and "f.read" in msgs

    def test_flags_sync_helper_reachable_from_coroutine(self):
        # the announcer shape: coroutine -> sync method -> sync helper
        fs = run_lint("""
            def _memory():
                with open("/proc/meminfo") as f:
                    return f.read()

            class Announcer:
                def host_with_stats(self):
                    return _memory()

                async def _loop(self):
                    while True:
                        self.host_with_stats()
        """)
        assert codes(fs) == ["DF001", "DF001"]
        assert "called from coroutine Announcer._loop" in fs[0].message

    def test_executor_thunk_and_pure_sync_are_clean(self):
        fs = run_lint("""
            import asyncio

            def cli_main(path):          # never called from a coroutine
                return open(path).read()

            async def work(loop, path):
                def _thunk():            # executor thunk: the FIX for DF001
                    with open(path, "rb") as f:
                        return f.read()
                return await loop.run_in_executor(None, _thunk)
        """)
        assert codes(fs) == []

    def test_flags_nested_async_def(self):
        # a coroutine defined INSIDE another function (file_client's
        # `chunks()` shape) still runs on the loop — the blind spot a
        # review pass found: without nested roots, reverting the
        # file_client fix would have kept the gate green
        fs = run_lint("""
            async def download(path):
                async def chunks():
                    with open(path, "rb") as f:
                        yield f.read(1 << 20)
                return chunks()
        """)
        assert "DF001" in codes(fs)

    def test_hashlib_whole_buffer_and_update(self):
        fs = run_lint("""
            import hashlib

            async def digest(buf):
                h = hashlib.sha256()
                h.update(buf)
                return hashlib.sha256(buf).hexdigest()
        """)
        assert codes(fs) == ["DF001", "DF001"]

    def test_suppression_with_reason(self):
        fs = run_lint("""
            async def announce():
                # dflint: disable=DF001 — tiny /proc read, cheaper than the executor hop
                with open("/proc/meminfo") as f:
                    pass
        """)
        assert codes(fs) == []
        sup = [f for f in fs if f.suppressed]
        assert len(sup) == 1
        assert sup[0].suppression.reason.startswith("tiny /proc read")


# ---------------------------------------------------------------------------
# DF002 — orphaned create_task
# ---------------------------------------------------------------------------

class TestDF002:
    def test_flags_fire_and_forget(self):
        fs = run_lint("""
            import asyncio

            async def go():
                asyncio.get_running_loop().create_task(work())
        """)
        assert codes(fs) == ["DF002"]

    def test_retained_awaited_and_taskgroup_are_clean(self):
        fs = run_lint("""
            import asyncio

            async def go(self):
                t = asyncio.get_running_loop().create_task(work())
                self._tasks.add(t)
                t.add_done_callback(self._tasks.discard)
                await asyncio.create_task(other())
                async with asyncio.TaskGroup() as tg:
                    tg.create_task(third())
        """)
        assert codes(fs) == []

    def test_suppressed(self):
        fs = run_lint("""
            import asyncio

            async def go():
                # dflint: disable=DF002 — daemon-lifetime loop; dies with the process by design
                asyncio.get_running_loop().create_task(work())
        """)
        assert codes(fs) == []
        assert [f.code for f in fs if f.suppressed] == ["DF002"]


# ---------------------------------------------------------------------------
# DF003 — wait_for around Condition.wait
# ---------------------------------------------------------------------------

# the dispatcher's silent-deadlock shape, verbatim: lock scope in the caller,
# cond.wait parked in a second task via wait_for — a cancellation leaves
# the inner wait to die holding the re-acquired condition lock
DISPATCHER_DEADLOCK = """
import asyncio

class PieceDispatcher:
    def __init__(self):
        self._cond = asyncio.Condition()

    async def get(self, timeout):
        async with self._cond:
            await asyncio.wait_for(self._cond.wait(), timeout)
"""


class TestDF003:
    def test_catches_dispatcher_deadlock_pattern_verbatim(self):
        fs = run_lint(DISPATCHER_DEADLOCK)
        assert "DF003" in codes(fs)
        hit = next(f for f in active(fs) if f.code == "DF003")
        assert "atomic acquire+wait" in hit.message

    def test_event_wait_is_exempt(self):
        fs = run_lint("""
            import asyncio

            class GC:
                def __init__(self):
                    self._stopped = asyncio.Event()

                async def _loop(self, interval):
                    await asyncio.wait_for(self._stopped.wait(), interval)
        """)
        assert "DF003" not in codes(fs)

    def test_condish_name_flags_without_ctor_evidence(self):
        fs = run_lint("""
            import asyncio

            async def poll(cond, t):
                await asyncio.wait_for(cond.wait(), t)
        """)
        assert "DF003" in codes(fs)

    def test_suppressed(self):
        fs = run_lint("""
            import asyncio

            async def poll(cond, t):
                # dflint: disable=DF003,DF005 — fixture reproducing the bug for a chaos test
                await asyncio.wait_for(cond.wait(), t)
        """)
        assert codes(fs) == []


# ---------------------------------------------------------------------------
# DF004 — cancellation-swallowing except in a coroutine
# ---------------------------------------------------------------------------

class TestDF004:
    def test_flags_bare_and_base_exception(self):
        fs = run_lint("""
            async def a():
                try:
                    await work()
                except:
                    pass

            async def b():
                try:
                    await work()
                except BaseException:
                    log.exception("boom")
        """)
        assert codes(fs) == ["DF004", "DF004"]

    def test_reraise_earlier_cancelled_arm_and_sync_are_clean(self):
        fs = run_lint("""
            import asyncio

            async def reraises():
                try:
                    await work()
                except BaseException:
                    cleanup()
                    raise

            async def cancelled_arm_first():
                try:
                    await work()
                except asyncio.CancelledError:
                    raise
                except BaseException:
                    pass

            async def narrow():
                try:
                    await work()
                except Exception:
                    pass

            def sync_main():
                try:
                    work()
                except:          # not a coroutine: CancelledError can't land here
                    pass
        """)
        assert codes(fs) == []

    def test_suppressed(self):
        fs = run_lint("""
            async def reap(t):
                t.cancel()
                try:
                    await t
                # dflint: disable=DF004 — cancel-and-reap: we just cancelled t ourselves
                except BaseException:
                    pass
        """)
        assert codes(fs) == []


# ---------------------------------------------------------------------------
# DF005 — slow await while holding an async lock
# ---------------------------------------------------------------------------

class TestDF005:
    def test_flags_sleep_and_network_under_lock(self):
        fs = run_lint("""
            import asyncio

            class Shaper:
                def __init__(self):
                    self._lock = asyncio.Lock()

                async def tick(self, session, url):
                    async with self._lock:
                        await asyncio.sleep(1.0)
                        await session.get(url)
        """)
        assert codes(fs) == ["DF005", "DF005"]

    def test_cond_wait_on_held_lock_and_plain_ctx_are_clean(self):
        fs = run_lint("""
            import asyncio

            class D:
                def __init__(self):
                    self._cond = asyncio.Condition()

                async def wait_notified(self):
                    async with self._cond:
                        await self._cond.wait()

                async def fetch(self, session, url):
                    async with session.get(url) as resp:   # not a lock
                        return await resp.read()
        """)
        assert codes(fs) == []

    def test_suppressed(self):
        fs = run_lint("""
            import asyncio

            _profile_lock = asyncio.Lock()

            async def profile(seconds):
                async with _profile_lock:
                    # dflint: disable=DF005 — the sleep IS the critical section
                    await asyncio.sleep(seconds)
        """)
        assert codes(fs) == []


# ---------------------------------------------------------------------------
# DF007 — pooled-buffer lifecycle
# ---------------------------------------------------------------------------

class TestDF007:
    def test_flags_leak_retention_and_use_after_release(self):
        fs = run_lint("""
            from pkg.bufpool import POOL

            async def leaks(size):
                buf = POOL.acquire(size)
                await fill(buf)                # unwinds holding buf
                POOL.release(buf)              # …skipping this

            class Engine:
                async def retains(self, size):
                    buf = POOL.acquire(size)
                    self._stash = buf          # second owner after release
                    POOL.release(buf)

            async def use_after(size):
                buf = POOL.acquire(size)
                POOL.release(buf)
                return bytes(buf)              # another download's bytes
        """)
        got = codes(fs)
        assert got.count("DF007") >= 3
        msgs = " ".join(f.message for f in active(fs))
        assert "leak on the exception path" in msgs
        assert "retained on self" in msgs
        assert "used after POOL.release" in msgs

    def test_flags_closure_capture_and_plain_leak(self):
        fs = run_lint("""
            from pkg.bufpool import POOL

            async def captured(loop, size):
                buf = POOL.acquire(size)
                def thunk():
                    return buf[0]              # closure outlives release
                await loop.run_in_executor(None, thunk)
                POOL.release(buf)

            async def never_released(size):
                buf = POOL.acquire(size)
                await fill(buf)
        """)
        msgs = " ".join(f.message for f in active(fs))
        assert "captured by a nested function" in msgs
        assert "never reaches" in msgs

    def test_blessed_shapes_are_clean(self):
        # the two shipped idioms: try/finally (piece_engine) and
        # except+release+raise with return-transfer (_read_body)
        fs = run_lint("""
            from pkg.bufpool import POOL

            async def finally_shape(size):
                buf = POOL.acquire(size)
                try:
                    await land(buf)
                finally:
                    POOL.release(buf)

            async def read_body(size):
                buf = POOL.acquire(size)
                try:
                    await fill(buf)
                except BaseException:
                    POOL.release(buf)
                    raise
                return buf                     # ownership -> caller
        """)
        assert codes(fs) == []

    def test_suppressed(self):
        fs = run_lint("""
            from pkg.bufpool import POOL

            async def chaos_fixture(size):
                # dflint: disable=DF007 — chaos test leaks on purpose to prove the discard metric
                buf = POOL.acquire(size)
                await fill(buf)
        """)
        assert codes(fs) == []
        assert [f.code for f in fs if f.suppressed] == ["DF007"]


# ---------------------------------------------------------------------------
# DF008 — acquire/refund pairing
# ---------------------------------------------------------------------------

class TestDF008:
    def test_flags_uncovered_optimistic_acquire(self):
        # the function refunds the limiter in one place, so its acquires
        # are optimistic — the bare one leaks tokens on a failed write
        fs = run_lint("""
            async def serve(limiter, resp, chunks):
                for chunk in chunks:
                    await limiter.acquire(len(chunk))
                    await resp.write(chunk)        # raises -> tokens lost
                await limiter.acquire(1)
                try:
                    await resp.write(b"x")
                except ConnectionError:
                    limiter.refund(1)
                    raise
        """)
        assert codes(fs) == ["DF008"]
        assert "optimistic await limiter.acquire" in active(fs)[0].message

    def test_intervening_unwindable_try_breaks_coverage(self):
        # an unrelated try (with awaits the handlers may not catch)
        # between the acquire and the refunding try can unwind first —
        # the later refund is unreachable on that path
        fs = run_lint("""
            async def serve(limiter, resp, other, n):
                await limiter.acquire(n)
                try:
                    await other()            # ConnectionError escapes
                except ValueError:
                    pass
                try:
                    await resp.write(b"x")
                except ConnectionError:
                    limiter.refund(n)
                    raise
        """)
        assert codes(fs) == ["DF008"]

    def test_flags_leaky_lease(self):
        fs = run_lint("""
            async def leaky(gate):
                slot = await gate.acquire()
                await work()                       # unwinds holding slot
                slot.release()

            async def never(gate):
                slot = await gate.acquire()
                await work()
        """)
        got = codes(fs)
        assert got == ["DF008", "DF008"]
        msgs = " ".join(f.message for f in active(fs))
        assert "leak on the exception path" in msgs
        assert "never released" in msgs

    def test_paired_and_nonoptimistic_shapes_are_clean(self):
        fs = run_lint("""
            async def upload(limiter, resp, chunks):
                for chunk in chunks:
                    await limiter.acquire(len(chunk))
                    try:
                        await resp.write(chunk)
                    except ConnectionError:
                        limiter.refund(len(chunk))  # the refund contract
                        raise

            async def accounting_only(limiter, chunks):
                # no refund anywhere: tokens pay for bytes already moved
                for chunk in chunks:
                    await limiter.acquire(len(chunk))

            async def finally_lease(gate):
                slot = await gate.acquire()
                try:
                    await work()
                finally:
                    slot.release()

            async def handed_off(gate, registry):
                slot = await gate.acquire()
                registry.adopt(slot)               # ownership transfer
        """)
        assert codes(fs) == []

    def test_suppressed(self):
        fs = run_lint("""
            async def serve(limiter, resp, chunk):
                limiter.refund(0)
                # dflint: disable=DF008 — fixture: the refund path is exercised by the chaos test directly
                await limiter.acquire(len(chunk))
                await resp.write(chunk)
        """)
        assert codes(fs) == []


class TestDF008TmpFd:
    """tmp-file fd release on tmp+rename persist paths (the state store)."""

    def test_flags_straight_line_close(self):
        # the write raises on a full disk BEFORE the close runs — each
        # retry of the persist tick leaks one descriptor
        fs = run_lint("""
            import os

            def save(path, payload):
                tmp = path + ".tmp"
                f = open(tmp, "wb")
                f.write(payload)           # ENOSPC raises here
                os.fsync(f.fileno())
                f.close()                  # straight-line only
                os.replace(tmp, path)
        """)
        assert codes(fs) == ["DF008"]
        assert "straight-line path" in active(fs)[0].message

    def test_flags_missing_close(self):
        fs = run_lint("""
            import os

            def save(path, payload):
                tmp = path + ".tmp"
                f = open(tmp, "wb")
                f.write(payload)
                os.replace(tmp, path)      # fd leaks even on success
        """)
        assert codes(fs) == ["DF008"]
        assert "never closed" in active(fs)[0].message

    def test_protected_and_with_shapes_are_clean(self):
        fs = run_lint("""
            import os

            def save(path, payload):
                tmp = path + ".tmp"
                f = open(tmp, "wb")
                try:
                    f.write(payload)
                    os.fsync(f.fileno())
                finally:
                    f.close()              # statestore._write shape
                os.replace(tmp, path)

            def save_with(path, payload):
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(payload)
                    os.fsync(f.fileno())
                os.replace(tmp, path)

            def save_fd(path, payload, fd):
                tmp = path + ".tmp"
                f = os.fdopen(fd, "wb")
                try:
                    f.write(payload)
                finally:
                    f.close()
                os.replace(tmp, path)

            def not_a_persist_path(path, payload):
                # no os.replace -> outside the rule's incident class
                f = open(path, "wb")
                f.write(payload)
                f.close()
        """)
        assert codes(fs) == []


# ---------------------------------------------------------------------------
# DF009 — async lock-ordering (global rule)
# ---------------------------------------------------------------------------

class TestDF009:
    def test_flags_lock_order_cycle(self):
        fs = run_lint("""
            import asyncio

            lock_a = asyncio.Lock()
            lock_b = asyncio.Lock()

            async def one():
                async with lock_a:
                    async with lock_b:
                        pass

            async def two():
                async with lock_b:
                    async with lock_a:
                        pass
        """)
        hits = [f for f in active(fs) if f.code == "DF009"]
        assert len(hits) == 2
        assert "lock-order cycle" in hits[0].message

    def test_flags_transitive_reentry(self):
        # the deadlock DF005 can't see: f holds the lock and awaits a
        # helper that re-acquires it — non-reentrant, silent wedge
        fs = run_lint("""
            import asyncio

            _lock = asyncio.Lock()

            async def helper():
                async with _lock:
                    return 1

            async def f():
                async with _lock:
                    return await helper()
        """)
        hits = [f for f in active(fs) if f.code == "DF009"]
        assert len(hits) == 1
        assert "re-acquired" in hits[0].message

    def test_flags_admission_inversion_qos_shape(self):
        # the QoS-admission incident verbatim: awaiting a QoS admission (which
        # parks on a capacity future) while holding the manager lock
        fs = run_lint("""
            import asyncio

            class Governor:
                async def admit(self, cls):
                    fut = asyncio.get_running_loop().create_future()
                    self._waiters.append(fut)
                    await fut

            GOV = Governor()

            class Manager:
                def __init__(self):
                    self._lock = asyncio.Lock()

                async def get_or_create(self, cls):
                    async with self._lock:
                        await GOV.admit(cls)
        """)
        hits = [f for f in active(fs) if f.code == "DF009"]
        assert len(hits) == 1
        assert "priority inversion" in hits[0].message
        assert "OUTSIDE the lock" in hits[0].message

    def test_flags_direct_sem_acquire_under_lock(self):
        # the helper-free form: `await sem.acquire()` under a held lock
        # parks on capacity with nothing to resolve through — DF005's
        # name table doesn't know `acquire`, so DF009's direct arm must
        fs = run_lint("""
            import asyncio

            class Pool:
                def __init__(self):
                    self._lock = asyncio.Lock()
                    self._sem = asyncio.Semaphore(4)

                async def take(self):
                    async with self._lock:
                        await self._sem.acquire()
        """)
        hits = [f for f in active(fs) if f.code == "DF009"]
        assert len(hits) == 1
        assert "priority inversion" in hits[0].message

    def test_heuristic_admit_arm_flags_untyped_governor(self):
        # the governor arrives through an untyped ctor param (the real
        # peertask_manager shape) — name arm still catches admit-under-lock
        fs = run_lint("""
            import asyncio

            class Manager:
                def __init__(self, qos):
                    self.qos = qos
                    self._lock = asyncio.Lock()

                async def create(self, cls):
                    async with self._lock:
                        await self.qos.admit(cls)
        """)
        assert any(f.code == "DF009" for f in active(fs))

    def test_one_direction_nesting_and_own_cond_wait_are_clean(self):
        fs = run_lint("""
            import asyncio

            outer = asyncio.Lock()
            inner = asyncio.Lock()

            class D:
                def __init__(self):
                    self._cond = asyncio.Condition()

                async def consistent(self):
                    async with outer:
                        async with inner:
                            pass

                async def wait_notified(self):
                    async with self._cond:
                        await self._cond.wait()
        """)
        assert codes(fs) == []

    def test_suppressed(self):
        fs = run_lint("""
            import asyncio

            _lock = asyncio.Lock()

            async def helper():
                async with _lock:
                    return 1

            async def f():
                async with _lock:
                    # dflint: disable=DF009 — fixture reproducing the re-entry wedge for the chaos suite
                    return await helper()
        """)
        assert codes(fs) == []


# ---------------------------------------------------------------------------
# the interprocedural engine: cross-module resolution + caching
# ---------------------------------------------------------------------------

def _write_pkg(tmp_path, files: dict[str, str]):
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("")
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if not (p.parent / "__init__.py").exists():
            (p.parent / "__init__.py").write_text("")
        p.write_text(textwrap.dedent(src))
    return pkg


class TestCrossModule:
    """The engine-upgrade regression pin: hazards v1's module-local pass
    provably missed, caught by the package-wide index."""

    FEEDER = """
        from .io_helpers import read_all

        async def pump(path):
            return read_all(path)
    """
    IO_HELPERS = """
        def read_all(path):
            with open(path) as f:
                return f.read()
    """

    def test_v1_module_local_pass_misses_the_blocking_helper(self):
        # lint the caller module ALONE (v1 semantics): the import edge
        # is invisible, so no DF001 — this is the blindness the two-pass
        # engine exists to remove, pinned so it can't silently return
        fs = run_lint(self.FEEDER)
        assert "DF001" not in codes(fs)

    def test_package_pass_catches_cross_module_blocking_call(self, tmp_path):
        _write_pkg(tmp_path, {"feeder.py": self.FEEDER,
                              "io_helpers.py": self.IO_HELPERS})
        fs = lint_paths([str(tmp_path / "pkg")], repo_root=str(tmp_path))
        hits = [f for f in active(fs) if f.code == "DF001"
                and f.path.endswith("feeder.py")]
        assert len(hits) == 1
        assert "io_helpers.read_all" in hits[0].message
        assert "pump" in hits[0].message

    def test_cross_module_slow_await_under_lock(self, tmp_path):
        _write_pkg(tmp_path, {
            "net.py": """
                async def flush(session, url):
                    await session.post(url)
            """,
            "shaper.py": """
                import asyncio
                from .net import flush

                _lock = asyncio.Lock()

                async def tick(session, url):
                    async with _lock:
                        await flush(session, url)
            """})
        fs = lint_paths([str(tmp_path / "pkg")], repo_root=str(tmp_path))
        hits = [f for f in active(fs) if f.code == "DF005"]
        assert len(hits) == 1
        assert "net.flush" in hits[0].message

    def test_cross_module_lock_cycle(self, tmp_path):
        _write_pkg(tmp_path, {
            "a.py": """
                import asyncio
                lock_a = asyncio.Lock()

                async def use_b():
                    from .b import locked_b
                    async with lock_a:
                        await locked_b()
            """,
            "b.py": """
                import asyncio
                from .a import lock_a
                lock_b = asyncio.Lock()

                async def locked_b():
                    async with lock_b:
                        pass

                async def use_a():
                    async with lock_b:
                        async with lock_a:
                            pass
            """})
        fs = lint_paths([str(tmp_path / "pkg")], repo_root=str(tmp_path))
        hits = [f for f in active(fs) if f.code == "DF009"]
        assert hits, [f.render() for f in active(fs)]
        assert any("lock-order cycle" in f.message for f in hits)

    def test_definition_site_suppression_retires_hazard_package_wide(
            self, tmp_path):
        # one reasoned suppression at the helper's hazard line keeps
        # every cross-module caller quiet — and the DF000 unused audit
        # treats it as used even with no module-local finding
        _write_pkg(tmp_path, {
            "feeder.py": self.FEEDER,
            "io_helpers.py": """
                def read_all(path):
                    # dflint: disable=DF001 — tiny /proc read at the call sites, not worth a hop
                    with open(path) as f:
                        # dflint: disable=DF001 — see above: tiny read
                        return f.read()
            """})
        fs = lint_paths([str(tmp_path / "pkg")], repo_root=str(tmp_path))
        assert codes(fs) == [], [f.render() for f in active(fs)]


class TestResultCache:
    def test_cache_hits_after_unchanged_rerun(self, tmp_path):
        _write_pkg(tmp_path, {"feeder.py": TestCrossModule.FEEDER,
                              "io_helpers.py": TestCrossModule.IO_HELPERS})
        stats1: dict = {}
        fs1 = lint_paths([str(tmp_path / "pkg")],
                         repo_root=str(tmp_path), stats=stats1)
        assert stats1["cache_hits"] == 0 and stats1["cache_misses"] > 0
        stats2: dict = {}
        fs2 = lint_paths([str(tmp_path / "pkg")],
                         repo_root=str(tmp_path), stats=stats2)
        assert stats2["cache_misses"] == 0
        assert stats2["cache_hits"] == stats1["cache_misses"]
        assert [f.render() for f in fs1] == [f.render() for f in fs2]

    def test_dependency_interface_change_invalidates_dependents(
            self, tmp_path):
        # the helper is clean; the caller's results are cached. Making
        # the helper BLOCK changes its interface digest, so the cached
        # caller result must be discarded and the new finding surface.
        clean = {"feeder.py": TestCrossModule.FEEDER,
                 "io_helpers.py": "def read_all(path):\n    return ''\n"}
        _write_pkg(tmp_path, clean)
        fs = lint_paths([str(tmp_path / "pkg")], repo_root=str(tmp_path))
        assert [f for f in active(fs) if f.code == "DF001"] == []
        (tmp_path / "pkg" / "io_helpers.py").write_text(
            textwrap.dedent(TestCrossModule.IO_HELPERS))
        stats: dict = {}
        fs = lint_paths([str(tmp_path / "pkg")],
                        repo_root=str(tmp_path), stats=stats)
        hits = [f for f in active(fs) if f.code == "DF001"
                and f.path.endswith("feeder.py")]
        assert len(hits) == 1   # served fresh, not from the stale cache

    def test_scoped_run_does_not_evict_full_package_cache(self, tmp_path):
        # a --changed-style run over ONE file must merge into the cache,
        # not replace it — else every pre-commit run resets the gate to
        # a cold start
        pkg = _write_pkg(tmp_path,
                         {"feeder.py": TestCrossModule.FEEDER,
                          "io_helpers.py": TestCrossModule.IO_HELPERS})
        lint_paths([str(pkg)], repo_root=str(tmp_path))      # warm all
        lint_paths([str(pkg / "feeder.py")],
                   repo_root=str(tmp_path))                  # scoped run
        stats: dict = {}
        lint_paths([str(pkg)], repo_root=str(tmp_path), stats=stats)
        assert stats["cache_misses"] == 0, stats

    def test_singleton_reexport_dependency_invalidates_through_hop(
            self, tmp_path):
        # a.py resolves GOV.admit through b's re-exported singleton into
        # impl.py, which a.py never imports — impl gaining a parking
        # await must still invalidate a.py's cached (clean) result
        files = {
            "impl.py": """
                class Governor:
                    async def admit(self):
                        return 1
            """,
            "b.py": """
                from .impl import Governor
                GOV = Governor()
            """,
            "a.py": """
                import asyncio
                from .b import GOV
                _lock = asyncio.Lock()

                async def create():
                    async with _lock:
                        await GOV.admit()
            """}
        pkg = _write_pkg(tmp_path, files)
        fs = lint_paths([str(pkg)], repo_root=str(tmp_path))
        assert [f for f in active(fs) if f.code == "DF009"] == []
        (pkg / "impl.py").write_text(textwrap.dedent("""
            class Governor:
                async def admit(self):
                    fut = make_future()
                    await fut
        """))
        fs = lint_paths([str(pkg)], repo_root=str(tmp_path))
        hits = [f for f in active(fs) if f.code == "DF009"
                and f.path.endswith("a.py")]
        assert len(hits) == 1, [f.render() for f in active(fs)]

    def test_standalone_file_gets_global_rules_too(self, tmp_path):
        # the CLI path (lint_paths on a loose file) must agree with
        # lint_source on DF009 — solo files get the global pass as well
        loose = tmp_path / "loops.py"
        loose.write_text(textwrap.dedent("""
            import asyncio

            lock_a = asyncio.Lock()
            lock_b = asyncio.Lock()

            async def one():
                async with lock_a:
                    async with lock_b:
                        pass

            async def two():
                async with lock_b:
                    async with lock_a:
                        pass
        """))
        fs = lint_paths([str(loose)], repo_root=str(tmp_path))
        assert [f.code for f in active(fs)] == ["DF009", "DF009"]

    def test_suppression_grammar_in_docstring_does_not_retire_hazard(
            self, tmp_path):
        # the index pass reads comments via tokenize: grammar QUOTED in
        # a docstring (e.g. documentation showing the disable syntax)
        # must not silently retire a real hazard from the summary
        _write_pkg(tmp_path, {
            "feeder.py": TestCrossModule.FEEDER,
            "io_helpers.py": """
                def read_all(path):
                    doc = '# dflint: disable=DF001 — sample reason'
                    with open(path) as f:
                        doc2 = '# dflint: disable=DF001 — sample reason'
                        return f.read()
            """})
        fs = lint_paths([str(tmp_path / "pkg")], repo_root=str(tmp_path))
        hits = [f for f in active(fs) if f.code == "DF001"
                and f.path.endswith("feeder.py")]
        assert len(hits) == 1, [f.render() for f in active(fs)]

    def test_comment_only_dependency_edit_keeps_dependents_cached(
            self, tmp_path):
        _write_pkg(tmp_path, {"feeder.py": TestCrossModule.FEEDER,
                              "io_helpers.py": TestCrossModule.IO_HELPERS})
        lint_paths([str(tmp_path / "pkg")], repo_root=str(tmp_path))
        helper = tmp_path / "pkg" / "io_helpers.py"
        helper.write_text("# a comment\n" + helper.read_text())
        stats: dict = {}
        lint_paths([str(tmp_path / "pkg")], repo_root=str(tmp_path),
                   stats=stats)
        # the helper itself re-analyzes (content hash moved) but its
        # interface digest didn't — the caller stays cached
        assert stats["cache_misses"] == 1


# ---------------------------------------------------------------------------
# DF000 — the suppression grammar polices itself
# ---------------------------------------------------------------------------

class TestSuppressionGrammar:
    def test_missing_reason_is_a_finding_and_does_not_suppress(self):
        fs = run_lint("""
            async def go():
                # dflint: disable=DF001
                with open("x") as f:
                    pass
        """)
        got = codes(fs)
        assert "DF000" in got and "DF001" in got

    def test_df000_cannot_be_suppressed(self):
        fs = run_lint("""
            # dflint: disable=DF000 — trying to silence the police
            # dflint: disable=DF001
            x = 1
        """)
        assert "DF000" in codes(fs)

    def test_multi_code_and_banner_form(self):
        fs = run_lint("""
            import time

            async def go(path):
                # dflint: disable=DF001,DF002 — fixture: both hazards on one line
                time.sleep(1)
        """)
        assert codes(fs) == []

    def test_unused_suppression_is_a_finding(self):
        # the hazard was fixed but the disable stayed: stale suppressions
        # must surface, or they silently excuse the NEXT hazard here
        fs = run_lint("""
            # dflint: disable=DF001 — excuse with nothing left to excuse
            x = 1
        """)
        assert codes(fs) == ["DF000"]
        assert "unused suppression" in active(fs)[0].message

    def test_suppression_only_covers_its_own_lines(self):
        fs = run_lint("""
            import time

            async def go():
                # dflint: disable=DF001 — covers only the next line
                time.sleep(1)
                time.sleep(2)
        """)
        assert codes(fs) == ["DF001"]


# ---------------------------------------------------------------------------
# DF006 — catalogue rules (metrics / flight vocabulary / faultgate sites)
# ---------------------------------------------------------------------------

class TestDF006Metrics:
    def _lint(self, tmp_path, src, doc="catalogued: `df_ok_total`"):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text(doc)
        mod = tmp_path / "mod.py"
        mod.write_text(textwrap.dedent(src))
        return lint_file(str(mod), repo_root=str(tmp_path))

    def test_documented_df_metric_is_clean(self, tmp_path):
        fs = self._lint(tmp_path, """
            c = REGISTRY.counter("df_ok_total", "all good", ("kind",))
        """)
        assert codes(fs) == []

    def test_undocumented_bad_prefix_and_empty_help_flag(self, tmp_path):
        fs = self._lint(tmp_path, """
            a = REGISTRY.counter("df_mystery_total", "undocumented")
            b = REGISTRY.gauge("wrong_prefix", "x")
            c = REGISTRY.histogram("df_ok_total", "")
        """)
        assert codes(fs) == ["DF006", "DF006", "DF006"]
        msgs = " ".join(f.message for f in fs)
        assert "not documented" in msgs
        assert "df_ namespace" in msgs
        assert "without help" in msgs

    def test_suppressed(self, tmp_path):
        fs = self._lint(tmp_path, """
            # dflint: disable=DF006 — internal bench-only metric, not an operator surface
            a = REGISTRY.counter("df_bench_only_total", "bench")
        """)
        assert codes(fs) == []


class TestDF006FlightVocabulary:
    def _lint(self, tmp_path, src, obs="", res=""):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text(obs)
        (tmp_path / "docs" / "RESILIENCE.md").write_text(res)
        mod = tmp_path / "daemon"
        mod.mkdir(exist_ok=True)
        f = mod / "flight_recorder.py"
        f.write_text(textwrap.dedent(src))
        return lint_file(str(f), repo_root=str(tmp_path))

    def test_documented_kind_and_rung_clean(self, tmp_path):
        fs = self._lint(tmp_path, """
            WIRE_DONE = "wire_done"
            RUNG_PEX = "pex"
        """, obs="kinds: `wire_done`", res="ladder: `pex`")
        assert codes(fs) == []

    def test_undocumented_kind_and_rung_flag(self, tmp_path):
        fs = self._lint(tmp_path, """
            NEW_KIND = "teleported"
            RUNG_WARP = "warp"
        """)
        assert codes(fs) == ["DF006", "DF006"]

    def test_other_modules_are_not_vocabulary(self, tmp_path):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text("")
        mod = tmp_path / "other.py"
        mod.write_text('SOME_CONST = "not_a_flight_kind"\n')
        assert codes(lint_file(str(mod), repo_root=str(tmp_path))) == []


class TestDF006DecisionVocabulary:
    def _lint(self, tmp_path, src, obs=""):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text(obs)
        mod = tmp_path / "scheduler"
        mod.mkdir(exist_ok=True)
        f = mod / "scheduling.py"
        f.write_text(textwrap.dedent(src))
        return lint_file(str(f), repo_root=str(tmp_path))

    def test_registered_fired_documented_is_clean(self, tmp_path):
        fs = self._lint(tmp_path, """
            EXCLUSION_REASONS = ("no-slots",)
            class S:
                def f(self, child, parent, excluded):
                    self._trace(child, parent, "no-slots", excluded)
        """, obs="reasons: `no-slots`")
        assert codes(fs) == []

    def test_undocumented_dead_and_unregistered_flag(self, tmp_path):
        fs = self._lint(tmp_path, """
            EXCLUSION_REASONS = ("no-slots", "ghost-reason")
            class S:
                def f(self, child, parent, excluded):
                    self._trace(child, parent, "no-slots", excluded)
                    self._trace(child, parent, "rogue", excluded)
        """, obs="reasons: `no-slots`")
        msgs = " ".join(f.message for f in fs)
        assert codes(fs) == ["DF006", "DF006", "DF006"]
        assert "'ghost-reason' is registered" in msgs          # dead
        assert "'ghost-reason' is not documented" in msgs      # undoc'd
        assert "'rogue' but it is not in the EXCLUSION_REASONS" in msgs

    def test_other_modules_are_not_decision_vocabulary(self, tmp_path):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text("")
        mod = tmp_path / "other.py"
        mod.write_text('EXCLUSION_REASONS = ("whatever",)\n')
        assert codes(lint_file(str(mod), repo_root=str(tmp_path))) == []


class TestDF006PriorityClasses:
    def _tree(self, tmp_path, *, classes, used, obs_doc="", res_doc=""):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text(obs_doc)
        (tmp_path / "docs" / "RESILIENCE.md").write_text(res_doc)
        pkg = tmp_path / "pkg"
        (pkg / "idl").mkdir(parents=True, exist_ok=True)
        idl = pkg / "idl" / "messages.py"
        names = ", ".join(f'"{c}"' for c in classes)
        idl.write_text(f"PRIORITY_CLASSES = ({names},)\n")
        lines = "\n".join(f'    if cls == "{c}":\n        pass'
                          for c in used)
        (pkg / "governor.py").write_text(
            f"def admit(cls):\n{lines or '    pass'}\n")
        return idl

    def test_registered_used_documented_is_clean(self, tmp_path):
        idl = self._tree(tmp_path, classes=["critical", "bulk"],
                         used=["bulk"],
                         obs_doc="classes: `critical`",
                         res_doc="brownout sheds `bulk` first")
        assert codes(lint_file(str(idl), repo_root=str(tmp_path))) == []

    def test_undocumented_and_unregistered_flag(self, tmp_path):
        idl = self._tree(tmp_path, classes=["critical", "bulk"],
                         used=["bulk", "gold"],
                         obs_doc="classes: `critical`")
        fs = active(lint_file(str(idl), repo_root=str(tmp_path)))
        msgs = " ".join(f.message for f in fs)
        # 'bulk' declared but never backticked; 'gold' used at a
        # surface but absent from the registry
        assert "not backticked" in msgs
        assert "'gold'" in msgs and "PRIORITY_CLASSES" in msgs
        assert len(fs) == 2

    def test_other_modules_are_not_the_registry(self, tmp_path):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text("")
        mod = tmp_path / "other.py"
        mod.write_text('PRIORITY_CLASSES = ("whatever",)\n')
        assert codes(lint_file(str(mod), repo_root=str(tmp_path))) == []


class TestDF006Faultgate:
    def _tree(self, tmp_path, *, sites, fired, res_doc):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "RESILIENCE.md").write_text(res_doc)
        pkg = tmp_path / "pkg"
        (pkg / "common").mkdir(parents=True, exist_ok=True)
        gate = pkg / "common" / "faultgate.py"
        names = ",\n    ".join(f'"{s}"' for s in sites)
        gate.write_text(f"SITES = frozenset({{\n    {names},\n}})\n")
        calls = "\n".join(
            f'    await faultgate.fire("{s}", key=x)' for s in fired)
        (pkg / "caller.py").write_text(f"async def go(x):\n{calls or '    pass'}\n")
        return gate

    def test_in_sync_is_clean(self, tmp_path):
        gate = self._tree(tmp_path, sites=["rpc.unary"],
                          fired=["rpc.unary"], res_doc="site: `rpc.unary`")
        assert codes(lint_file(str(gate), repo_root=str(tmp_path))) == []

    def test_never_fired_undocumented_and_unregistered_flag(self, tmp_path):
        gate = self._tree(tmp_path, sites=["rpc.unary", "dead.site"],
                          fired=["rpc.unary", "ghost.site"],
                          res_doc="site: `rpc.unary`")
        fs = active(lint_file(str(gate), repo_root=str(tmp_path)))
        msgs = " ".join(f.message for f in fs)
        assert "never fired" in msgs            # dead.site
        assert "not documented" in msgs         # dead.site
        assert "not in the SITES registry" in msgs  # ghost.site
        assert len(fs) == 3


class TestDF006PhaseVocabulary:
    def _tree(self, tmp_path, *, phases, kinds, fired_phases,
              fired_kinds, doc):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text(doc)
        pkg = tmp_path / "pkg"
        (pkg / "common").mkdir(parents=True, exist_ok=True)
        timer = pkg / "common" / "phasetimer.py"
        timer.write_text(
            "PHASES = (%s)\nRULING_KINDS = (%s)\n" % (
                ", ".join(f'"{p}"' for p in phases) + ",",
                ", ".join(f'"{k}"' for k in kinds) + ","))
        lines = [f'    with phasetimer.phase("{p}"):\n        pass'
                 for p in fired_phases]
        lines += [f'    with phasetimer.ruling("{k}"):\n        pass'
                  for k in fired_kinds]
        (pkg / "caller.py").write_text(
            "from .common import phasetimer\n\n\ndef go():\n"
            + ("\n".join(lines) or "    pass") + "\n")
        return timer

    def test_in_sync_is_clean(self, tmp_path):
        timer = self._tree(tmp_path, phases=["filter"], kinds=["find"],
                           fired_phases=["filter"], fired_kinds=["find"],
                           doc="`filter` and `find`")
        assert codes(lint_file(str(timer), repo_root=str(tmp_path))) == []

    def test_dead_undocumented_and_unregistered_flag(self, tmp_path):
        timer = self._tree(
            tmp_path, phases=["filter", "dead-phase"], kinds=["find"],
            fired_phases=["filter", "ghost-phase"],
            fired_kinds=["find", "decree"],
            doc="`filter` and `find`")
        fs = active(lint_file(str(timer), repo_root=str(tmp_path)))
        msgs = " ".join(f.message for f in fs)
        assert "dead vocabulary" in msgs            # dead-phase never fired
        assert "not documented" in msgs             # dead-phase undocumented
        assert "not in the PHASES registry" in msgs      # ghost-phase
        assert "not in the RULING_KINDS registry" in msgs  # decree
        assert len(fs) == 4

    def test_undocumented_kind_flags(self, tmp_path):
        timer = self._tree(tmp_path, phases=["filter"],
                           kinds=["find", "preempt"],
                           fired_phases=["filter"],
                           fired_kinds=["find", "preempt"],
                           doc="`filter` and `find`")
        fs = active(lint_file(str(timer), repo_root=str(tmp_path)))
        assert len(fs) == 1
        assert "ruling kind 'preempt' is not documented" in fs[0].message

    def test_record_literal_is_swept(self, tmp_path):
        timer = self._tree(tmp_path, phases=["filter"], kinds=["find"],
                           fired_phases=["filter"], fired_kinds=["find"],
                           doc="`filter` `find`")
        caller = tmp_path / "pkg" / "caller.py"
        caller.write_text(caller.read_text()
                          + '\n\ndef hot():\n'
                            '    phasetimer.record("sneaky", 0.1)\n')
        fs = active(lint_file(str(timer), repo_root=str(tmp_path)))
        assert len(fs) == 1
        assert "'sneaky' is not in the PHASES registry" in fs[0].message


class TestDF006AnomalyVocabulary:
    def _tree(self, tmp_path, *, kinds, signal_kinds, fired, doc):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text(doc)
        pkg = tmp_path / "pkg"
        (pkg / "scheduler").mkdir(parents=True, exist_ok=True)
        fp = pkg / "scheduler" / "fleetpulse.py"
        signals = ",\n    ".join(
            f'"sig_{i}": ("{k}", 1.0)' for i, k in enumerate(signal_kinds))
        fires = "\n".join(
            f'        self._fire("{k}", host_id, "sig", 0.0, 0.0)'
            for k in fired)
        fp.write_text(
            "ANOMALY_KINDS = (%s)\n_SIGNALS = {\n    %s\n}\n\n\n"
            "class FleetPulse:\n    def tick(self, host_id):\n%s\n" % (
                ", ".join(f'"{k}"' for k in kinds) + ",",
                signals, fires or "        pass"))
        return fp

    def test_registered_fired_documented_is_clean(self, tmp_path):
        fp = self._tree(tmp_path, kinds=["loop-stall", "silent-daemon"],
                        signal_kinds=["loop-stall"],
                        fired=["silent-daemon"],
                        doc="kinds: `loop-stall` `silent-daemon`")
        assert codes(lint_file(str(fp), repo_root=str(tmp_path))) == []

    def test_dead_undocumented_and_unregistered_flag(self, tmp_path):
        fp = self._tree(
            tmp_path,
            kinds=["loop-stall", "dead-kind"],
            signal_kinds=["loop-stall"],
            fired=["ghost-kind"],
            doc="kinds: `loop-stall`")
        fs = active(lint_file(str(fp), repo_root=str(tmp_path)))
        msgs = " ".join(f.message for f in fs)
        assert "'dead-kind' is registered" in msgs          # never fired
        assert "'dead-kind' is not documented" in msgs      # undoc'd
        assert "not in the ANOMALY_KINDS registry" in msgs  # ghost-kind
        assert len(fs) == 3

    def test_signal_map_heads_count_as_fire_sites(self, tmp_path):
        # the z-score path fires through _SIGNALS, not a literal _fire —
        # the tuple heads must register as fired or every z-kind reads
        # as dead vocabulary (the bug this fixture pins)
        fp = self._tree(tmp_path, kinds=["slo-storm"],
                        signal_kinds=["slo-storm"], fired=[],
                        doc="`slo-storm`")
        assert codes(lint_file(str(fp), repo_root=str(tmp_path))) == []

    def test_other_modules_are_not_anomaly_vocabulary(self, tmp_path):
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OBSERVABILITY.md").write_text("")
        mod = tmp_path / "other.py"
        mod.write_text('ANOMALY_KINDS = ("whatever",)\n')
        assert codes(lint_file(str(mod), repo_root=str(tmp_path))) == []


# ---------------------------------------------------------------------------
# CLI: --json, --changed, exit codes
# ---------------------------------------------------------------------------

def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.tools.dflint", *args],
        capture_output=True, text=True, cwd=cwd, timeout=120)


class TestCLI:
    def test_json_output_and_exit_one_on_findings(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text(textwrap.dedent("""
            import time

            async def go():
                time.sleep(1)
                # dflint: disable=DF001 — justified example
                open("x")
        """))
        p = _cli("--json", str(bad))
        assert p.returncode == 1, p.stderr
        doc = json.loads(p.stdout)
        assert doc["counts"]["findings"] == 1
        assert doc["counts"]["by_code"] == {"DF001": 1}
        [sup] = doc["suppressed"]
        assert sup["reason"] == "justified example"   # reasons surface in --json
        [f] = doc["findings"]
        assert f["code"] == "DF001" and f["line"] == 5

    def test_exit_zero_on_clean_file(self, tmp_path):
        ok = tmp_path / "ok.py"
        ok.write_text("async def go():\n    return 1\n")
        p = _cli(str(ok))
        assert p.returncode == 0, p.stdout

    def test_missing_path_is_usage_error(self):
        p = _cli("/nonexistent/nope.py")
        assert p.returncode == 2

    def test_changed_mode_smoke(self):
        # --changed must run green against whatever the working tree holds
        # (package files are gated separately below; non-package files
        # aren't required to be clean, so accept 0 or 1 but not a crash)
        p = _cli("--changed", "--json")
        assert p.returncode in (0, 1), p.stderr
        json.loads(p.stdout)

    def test_stats_emits_counts_and_pass_times(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text("import time\n\nasync def go():\n    time.sleep(1)\n")
        p = _cli("--stats", str(bad))
        assert p.returncode == 1, p.stderr
        doc = json.loads(p.stdout)
        assert doc["counts"]["by_code"] == {"DF001": 1}
        assert doc["passes"]["index_s"] >= 0.0
        assert doc["passes"]["analysis_s"] >= 0.0
        assert doc["cache"]["hits"] + doc["cache"]["misses"] == 1

    @pytest.mark.parametrize("flag", ["as_json", "with_stats"])
    def test_output_documents_are_the_references(self, flag, tmp_path,
                                                 monkeypatch):
        # one file through both CLIs' run(): the same --json or --stats
        # document but for the pass times. In process, so that the
        # reference's run neither reads nor writes its suite's cache
        from dragonfly2_tpu.tools import dflint as ref_cli
        from dragonfly2_tpu_torch.tools import dflint as port_cli
        monkeypatch.setattr(ref_rules, "_load_cache", lambda root: {})
        monkeypatch.setattr(ref_rules, "_save_cache",
                            lambda root, cache: None)
        bad = tmp_path / "bad.py"
        bad.write_text("import time\n\nasync def go():\n    time.sleep(1)\n"
                       "    # dflint: disable=DF001 — justified example\n"
                       "    open('x')\n")
        docs = []
        for cli in (port_cli, ref_cli):
            out = io.StringIO()
            rc = cli.run([str(bad)], out=out, **{flag: True})
            doc = json.loads(out.getvalue())
            passes = doc.pop("passes", {})
            docs.append((rc, doc, sorted(passes)))
        assert docs[0] == docs[1]
        assert docs[0][0] == 1


class TestChangedResolution:
    """--changed scopes against the merge-base, never the index, and keeps
    only files under the port's root."""

    def _fake_git(self, outputs):
        calls = []

        def git(args):
            calls.append(args)
            for prefix, out in outputs.items():
                if tuple(args[:len(prefix)]) == prefix:
                    return out
            return None
        return git, calls

    def test_merge_base_diff_with_untracked_union(self):
        from dragonfly2_tpu_torch.tools.dflint import changed_files
        tracked = "dragonfly2_tpu_torch/common/ids.py"
        fresh = "dragonfly2_tpu_torch/common/rate.py"
        git, calls = self._fake_git({
            ("merge-base",): "abc123",
            ("diff",): f"{tracked}\n{fresh}",
            ("ls-files",): fresh,            # union + dedupe with diff
        })
        out = changed_files(git)
        assert [os.path.basename(p) for p in out] == ["ids.py", "rate.py"]
        diff_calls = [c for c in calls if c[0] == "diff"]
        # the one diff runs against the merge-base sha — branch commits
        # and working-tree edits in one listing
        assert diff_calls == [["diff", "--name-only", "abc123", "--",
                               "*.py"]]
        # the index is never consulted: staging state is laptop-local
        assert not any("--cached" in c for c in calls)

    def test_no_upstream_falls_back_to_head_not_index(self):
        from dragonfly2_tpu_torch.tools.dflint import changed_files
        git, calls = self._fake_git({
            ("diff",): "dragonfly2_tpu_torch/common/ids.py",
            ("ls-files",): "",
        })
        out = changed_files(git)
        assert [os.path.basename(p) for p in out] == ["ids.py"]
        assert ["diff", "--name-only", "HEAD", "--", "*.py"] in calls
        assert not any("--cached" in c for c in calls)

    def test_untracked_only_change_is_linted(self):
        # the untracked-file union: a brand-new module never appears in
        # `git diff`, and it is exactly the file most likely to carry a
        # fresh hazard
        from dragonfly2_tpu_torch.tools.dflint import changed_files
        git, _ = self._fake_git({
            ("merge-base",): "abc123",
            ("diff",): "",
            ("ls-files",): "dragonfly2_tpu_torch/common/rate.py",
        })
        out = changed_files(git)
        assert [os.path.basename(p) for p in out] == ["rate.py"]

    def test_only_the_port_package_is_in_scope(self):
        # the reference package, the tests and chip_smoke.py sit in the
        # same checkout: none of them is the port's gate to lint
        from dragonfly2_tpu_torch.tools.dflint import PKG_ROOT, changed_files
        git, _ = self._fake_git({
            ("merge-base",): "abc123",
            ("diff",): "dragonfly2_tpu/common/ids.py\n"
                       "dragonfly2_tpu_torch/common/ids.py\n"
                       "tests/test_torch_dflint.py\nchip_smoke.py",
            ("ls-files",): "",
        })
        out = changed_files(git)
        assert out == [os.path.join(PKG_ROOT, "common", "ids.py")]
        assert PKG_ROOT == PKG


# ---------------------------------------------------------------------------
# the engines side by side: constants, registry, separate caches
# ---------------------------------------------------------------------------

class TestEngineParity:
    def test_version_grammar_and_never_cached_modules_are_the_references(
            self):
        assert port_rules.ENGINE_VERSION == ref_rules.ENGINE_VERSION
        assert port_rules._NEVER_CACHE == ref_rules._NEVER_CACHE
        assert (port_rules._SUPPRESS_RE.pattern
                == ref_rules._SUPPRESS_RE.pattern)

    def test_rule_registries_are_the_references(self):
        def names(rules):
            return [(type(r).__name__, r.code, r.name) for r in rules]
        assert names(port_rules.RULES) == names(ref_rules.RULES)
        assert names(port_rules.GLOBAL_RULES) == names(ref_rules.GLOBAL_RULES)

    def test_each_engine_keeps_its_own_cache(self, tmp_path):
        # one repo root, one key format, one ENGINE_VERSION: a shared file
        # would serve the port the reference's results
        assert port_rules.CACHE_NAME == ".dflint_torch_cache.json"
        assert ref_rules.CACHE_NAME == ".dflint_cache.json"
        pkg = _write_pkg(tmp_path, {"feeder.py": TestCrossModule.FEEDER,
                                    "io_helpers.py": TestCrossModule.IO_HELPERS})
        ref_rules.lint_paths([str(pkg)], repo_root=str(tmp_path))
        stats: dict = {}
        port_rules.lint_paths([str(pkg)], repo_root=str(tmp_path),
                              stats=stats)
        assert stats["cache_hits"] == 0, stats
        assert (tmp_path / ".dflint_cache.json").exists()
        assert (tmp_path / ".dflint_torch_cache.json").exists()


# ---------------------------------------------------------------------------
# one cold package-wide run per package and engine
# ---------------------------------------------------------------------------

def _cold_port(pkg):
    """The port's engine over ``pkg`` with its cache deleted (this file
    is the only reader and writer of the port's cache in the suite).
    The third item is ``(cpu_s, wall_s)``: the engine's own CPU time,
    which other processes on the host do not inflate, and the wall time."""
    cache = os.path.join(REPO, port_rules.CACHE_NAME)
    if os.path.exists(cache):
        os.remove(cache)
    stats: dict = {}
    c0, t0 = time.process_time(), time.perf_counter()
    findings = port_rules.lint_paths([pkg], repo_root=REPO, stats=stats)
    return findings, stats, (time.process_time() - c0,
                             time.perf_counter() - t0)


def _cold_ref(pkg):
    """The reference's engine over ``pkg`` with no cache to read or
    write: its own suite may be warming or deleting ``.dflint_cache.json``
    at the same time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_rules, "_load_cache", lambda root: {})
        mp.setattr(ref_rules, "_save_cache", lambda root, cache: None)
        stats: dict = {}
        t0 = time.perf_counter()
        findings = ref_rules.lint_paths([pkg], repo_root=REPO, stats=stats)
        return findings, stats, time.perf_counter() - t0


@pytest.fixture(scope="module")
def port_over_port():
    return _cold_port(PKG)


@pytest.fixture(scope="module")
def port_over_ref():
    return _cold_port(REF_PKG)


@pytest.fixture(scope="module")
def ref_over_port():
    return _cold_ref(PKG)


@pytest.fixture(scope="module")
def ref_over_ref():
    return _cold_ref(REF_PKG)


class TestPackageParity:
    def test_port_engine_over_the_reference_package(self, port_over_ref,
                                                    ref_over_ref):
        port, port_stats, _ = port_over_ref
        ref, ref_stats, _ = ref_over_ref
        assert port_stats["cache_hits"] == 0 and ref_stats["cache_hits"] == 0
        assert _dicts(port) == _dicts(ref)
        assert not [f.render() for f in port if not f.suppressed]
        assert len(port) == REF_SUPPRESSED
        assert all(f.suppression.reason.strip() for f in port)

    def test_reference_engine_over_the_port_package(self, port_over_port,
                                                    ref_over_port):
        port, port_stats, _ = port_over_port
        ref, ref_stats, _ = ref_over_port
        assert port_stats["cache_hits"] == 0 and ref_stats["cache_hits"] == 0
        assert _dicts(ref) == _dicts(port)
        assert ({k: port_stats[k] for k in _STAT_KEYS}
                == {k: ref_stats[k] for k in _STAT_KEYS})


# ---------------------------------------------------------------------------
# THE GATE: zero unsuppressed findings over the whole port package
# ---------------------------------------------------------------------------

class TestTier1Gate:
    def test_package_is_clean_and_every_suppression_carries_a_reason(
            self, port_over_port):
        findings, _, _ = port_over_port
        bad = [f.render() for f in findings if not f.suppressed]
        assert not bad, (
            "unsuppressed dflint findings (fix the hazard or add "
            "`# dflint: disable=DF00X — <reason>` with a real reason; "
            "see docs/ANALYSIS.md):\n" + "\n".join(bad))
        # the grammar makes reasons mandatory; assert the invariant held
        for f in findings:
            if f.suppressed:
                assert f.suppression.reason.strip()
        # the count phase 26 of chip_smoke.py holds the card's host to
        assert len(findings) == chip_smoke.DFLINT_SUPPRESSED

    def test_gate_covers_known_incident_shapes(self):
        """The gate is only worth its runtime if the rules still catch
        the original incidents — re-lint the dispatcher-deadlock fixture
        here so a future rule refactor can't silently hollow the gate
        out."""
        assert "DF003" in codes(run_lint(DISPATCHER_DEADLOCK))

    def test_cold_package_run_stays_under_budget(self, port_over_port):
        """The per-module cache is what keeps the tier-1 gate cheap;
        this pins the COLD path (cache deleted) under 15 s so an engine
        change that silently quadratics the index or analysis pass fails
        here instead of slowly rotting the gate. The engine runs in one
        process and one thread, so its CPU time is that cost; wall time
        also counts every other test process on the host."""
        _, stats, (cpu_s, wall_s) = port_over_port
        assert stats["cache_hits"] == 0 and stats["cache_misses"] > 0
        assert cpu_s < 15.0, (
            f"cold package-wide dflint run took {cpu_s:.1f}s of CPU "
            f"({wall_s:.1f}s wall; budget 15s) — stats: {stats}")

    def test_default_cli_run_lints_the_port_package(self, port_over_port):
        # no paths: the whole port package, exit 0, the gate's counts
        p = _cli("--stats")
        assert p.returncode == 0, p.stdout + p.stderr
        doc = json.loads(p.stdout)
        _, stats, _ = port_over_port
        assert doc["files"] == stats["files"]
        assert doc["counts"]["findings"] == 0
        assert doc["counts"]["suppressed"] == chip_smoke.DFLINT_SUPPRESSED


# ---------------------------------------------------------------------------
# the triage of the port's findings
# ---------------------------------------------------------------------------

class TestTriage:
    def test_bind_model_hashes_the_blob_off_the_loop(self, monkeypatch):
        # the port-only direct bind hashed its blob on the loop thread
        # (DF001 through params_io.version_of); it now hops, as the
        # deserialize beside it does
        threads = []
        real = announcer_mod.version_of

        def version_of(blob):
            threads.append(threading.get_ident())
            return real(blob)

        monkeypatch.setattr(announcer_mod, "version_of", version_of)
        seen = []

        async def bind(version, blob, metrics):
            seen.append((version, blob, metrics))
            return True

        async def go():
            sched = types.SimpleNamespace(
                scheduling=types.SimpleNamespace(evaluator=None))
            ann = announcer_mod.SchedulerAnnouncer(sched)
            ann._bind = bind
            assert await ann.bind_model(b"blob bytes")
            return threading.get_ident()

        loop_thread = asyncio.run(go())
        assert len(threads) == 1 and threads[0] != loop_thread
        assert seen == [(real(b"blob bytes"), b"blob bytes", None)]

    @pytest.mark.parametrize("mode", ["ok", "timeout", "closed", "busy"])
    def test_downloader_closures_never_outlive_the_release(self, mode,
                                                           monkeypatch):
        """The DF007 suppression's claim: ``progress`` (which writes to
        the relay span and reads the buffer) runs only through
        ``_Conn._progress``, cleared by ``release_dst`` on every exit of
        ``_fetch``, and the buffer returns to the pool only after that,
        whether the body lands, the deadline cancels the read mid-body
        (the parent's late bytes arrive after it), the parent closes
        mid-body, or it answers 503."""
        size = 64 << 10
        body = bytes(range(256)) * (size // 256)
        events = []
        real_release_dst = pd._Conn.release_dst
        real_pool_release = pd.POOL.release

        def release_dst(conn):
            events.append("release_dst")
            real_release_dst(conn)

        def pool_release(buf):
            events.append("pool.release")
            real_pool_release(buf)

        monkeypatch.setattr(pd._Conn, "release_dst", release_dst)
        monkeypatch.setattr(pd.POOL, "release", pool_release)

        class Span:
            def advance(self, off):
                events.append("advance")

            def close(self):
                events.append("span.close")

        async def serve(reader, writer):
            try:
                await answer(reader, writer)
            finally:
                writer.close()

        async def answer(reader, writer):
            await reader.readuntil(b"\r\n\r\n")
            if mode == "busy":
                writer.write(b"HTTP/1.1 503 Busy\r\nContent-Length: 0\r\n"
                             b"x-retry-after-ms: 5\r\n\r\n")
                await writer.drain()
                return
            writer.write(b"HTTP/1.1 206 Partial Content\r\n"
                         b"Content-Length: %d\r\n\r\n" % size)
            if mode == "ok":
                writer.write(body)
                await writer.drain()
                return
            writer.write(body[:size // 2])
            await writer.drain()
            if mode == "closed":
                return
            await asyncio.sleep(0.5)        # past the client's deadline
            try:
                writer.write(body[size // 2:])
                await writer.drain()
            except ConnectionError:
                pass

        async def go():
            server = await asyncio.start_server(serve, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            dl = pd.PieceDownloader(timeout_s=0.2)
            try:
                piece = PieceInfo(piece_num=0, range_start=0,
                                  range_size=size)
                call = dl.download_span(
                    dst_addr=f"127.0.0.1:{port}", task_id="a" * 64,
                    src_peer_id="peer", pieces=[piece],
                    relay_open=lambda buf: Span())
                if mode == "ok":
                    buf, _ = await call
                    assert bytes(buf[:size]) == body
                    pd.POOL.release(buf)        # the caller, after landing
                else:
                    with pytest.raises(DFError) as exc:
                        await call
                    want = (Code.CLIENT_PEER_BUSY if mode == "busy"
                            else Code.CLIENT_PIECE_DOWNLOAD_FAIL)
                    assert exc.value.code == want
                    assert events[-2:] == ["span.close", "pool.release"]
                await asyncio.sleep(0.6)        # any late bytes land now
            finally:
                await dl.close()
                server.close()
                await server.wait_closed()

        asyncio.run(asyncio.wait_for(go(), 20.0))
        released = events.index("pool.release")
        assert events.count("pool.release") == 1, events
        assert "advance" not in events[released:], events
        assert "release_dst" in events[:released], events
        if mode != "busy":
            assert "advance" in events, events


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
