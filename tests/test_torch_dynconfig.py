"""``common/dynconfig.py`` against the reference's ``Dynconfig``.

* A seeded script of fetch results and exceptions, observer
  registrations, ``refresh`` and ``get`` calls runs through both classes,
  each over its own snapshot path: every observer's calls, every
  ``get()`` answer (or its error) and the snapshot file's bytes after
  each step are equal.
* A fresh instance whose fetch fails answers ``get()`` from the snapshot
  another one wrote, in both packages; with no snapshot, or a torn one,
  ``get()`` raises the same error.
* A snapshot that cannot be written, and an observer that raises, stop
  neither the notification of the others nor the held data.
* ``serve`` refreshes on its interval and ``stop`` ends it.
"""

import asyncio
import json
import os

import numpy as np
import pytest

from dragonfly2_tpu.common.dynconfig import Dynconfig as RefDynconfig
from dragonfly2_tpu_torch.common.dynconfig import Dynconfig

from conftest import run

CLASSES = {"ref": RefDynconfig, "port": Dynconfig}


def _script(seed: int) -> list[tuple]:
    """Steps: ("fetch", data or None for a failing fetch), ("register",),
    ("get",). Data comes from a small pool, so repeats (no change, no
    notification) happen."""
    rng = np.random.default_rng(seed)
    pool = [{"cluster_config": {"candidate_parent_limit": int(v)},
             "schedulers": [{"ip": "127.0.0.1", "port": 8000 + int(v)}]}
            for v in rng.integers(1, 9, 3)]
    steps = []
    for _ in range(int(rng.integers(12, 24))):
        r = rng.random()
        if r < 0.15:
            steps.append(("register",))
        elif r < 0.3:
            steps.append(("get",))
        elif r < 0.5:
            steps.append(("fetch", None))
        else:
            steps.append(("fetch", pool[int(rng.integers(len(pool)))]))
    return steps


def _drive(impl: str, steps: list[tuple], snapshot: str) -> list:
    async def main():
        plan = list(steps)
        current: dict = {}

        async def fetch():
            if current["data"] is None:
                raise ConnectionError("manager unreachable")
            return json.loads(json.dumps(current["data"]))

        dc = CLASSES[impl](fetch, refresh_interval=3600,
                           snapshot_path=snapshot)
        trace, seen = [], []
        for i, step in enumerate(plan):
            if step[0] == "register":
                n = len(seen)
                seen.append([])
                dc.register(lambda d, n=n: seen[n].append(
                    json.loads(json.dumps(d))))
            elif step[0] == "get":
                current["data"] = None      # get() never fetches when held
                try:
                    trace.append(("get", await dc.get()))
                except RuntimeError as exc:
                    trace.append(("get-error", str(exc)))
            else:
                current["data"] = step[1]
                await dc.refresh()
            raw = None
            if os.path.exists(snapshot):
                with open(snapshot, "rb") as f:
                    raw = f.read()
            trace.append((i, raw, [list(s) for s in seen]))
        return trace

    return run(asyncio.wait_for(main(), 10))


@pytest.mark.parametrize("seed", range(6))
def test_a_seeded_script_gives_the_references_calls_and_snapshot(tmp_path,
                                                                 seed):
    steps = [("fetch", None), ("get",), *_script(seed)]
    want = _drive("ref", steps, str(tmp_path / "ref.json"))
    got = _drive("port", steps, str(tmp_path / "port.json"))
    assert got == want
    # the first get, with nothing fetched and no snapshot, is an error
    assert got[1] == ("get-error", "dynconfig: no data and no snapshot")


@pytest.mark.parametrize("impl", ["ref", "port"])
def test_a_fresh_instance_answers_from_the_snapshot(tmp_path, impl):
    snap = str(tmp_path / "dc.json")
    data = {"cluster_config": {"candidate_parent_limit": 7}}

    async def main():
        async def ok():
            return data

        async def down():
            raise ConnectionError("manager stopped")

        first = CLASSES[impl](ok, snapshot_path=snap)
        assert await first.get() == data
        assert not os.path.exists(snap + ".tmp")
        fresh = CLASSES[impl](down, snapshot_path=snap)
        got = []
        fresh.register(got.append)
        assert got == []
        assert await fresh.get() == data
        assert got == [data]
        late = []
        fresh.register(late.append)        # data held: called at once
        assert late == [data]
        # a torn snapshot is no snapshot
        with open(snap, "w") as f:
            f.write('{"cluster_config": {')
        torn = CLASSES[impl](down, snapshot_path=snap)
        with pytest.raises(RuntimeError, match="no data and no snapshot"):
            await torn.get()
        none = CLASSES[impl](down)
        with pytest.raises(RuntimeError, match="no data and no snapshot"):
            await none.get()

    run(asyncio.wait_for(main(), 10))


@pytest.mark.parametrize("impl", ["ref", "port"])
def test_a_failed_snapshot_write_and_a_raising_observer_are_contained(
        tmp_path, impl):
    snap = str(tmp_path / "missing-dir" / "dc.json")
    values = iter([{"v": 1}, {"v": 2}])

    async def main():
        async def fetch():
            return next(values)

        dc = CLASSES[impl](fetch, snapshot_path=snap)
        got = []

        def bad(_d):
            raise ValueError("observer bug")

        dc.register(bad)
        dc.register(got.append)
        await dc.refresh()
        await dc.refresh()
        assert got == [{"v": 1}, {"v": 2}]
        assert await dc.get() == {"v": 2}
        assert not os.path.exists(snap)

    run(asyncio.wait_for(main(), 10))


@pytest.mark.parametrize("impl", ["ref", "port"])
def test_serve_refreshes_on_its_interval_until_stop(impl):
    async def main():
        calls = []

        async def fetch():
            calls.append(len(calls))
            return {"n": len(calls)}

        dc = CLASSES[impl](fetch, refresh_interval=0.02)
        seen = []
        dc.register(seen.append)
        await dc.serve()
        for _ in range(200):
            if len(calls) >= 3:
                break
            await asyncio.sleep(0.01)
        await dc.stop()
        n = len(calls)
        assert n >= 3 and seen == [{"n": i + 1} for i in range(len(seen))]
        await asyncio.sleep(0.1)
        assert len(calls) == n            # stopped: no more refreshes

    run(asyncio.wait_for(main(), 10))
