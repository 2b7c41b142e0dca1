"""The piece dispatcher counts the locality of every pick.

``df_dispatch_pick_total{outcome}`` (``seed``, ``local``,
``cross_local_known``, ``cross_no_local``) is the reference's decision
quality counter, read from a daemon's ``/metrics`` by the fake-pod e2e
(``tests/test_fakepod_ici.py``). The port lacked it (ROADMAP Queue 3
entry 80); the same script of parents and pieces now moves both packages'
counters alike.
"""

from __future__ import annotations

import asyncio
import random

import pytest

OUTCOMES = ("seed", "local", "cross_local_known", "cross_no_local")


def _script(impl: str) -> dict[str, float]:
    if impl == "reference":
        from dragonfly2_tpu.common.metrics import REGISTRY
        from dragonfly2_tpu.daemon.piece_dispatcher import PieceDispatcher
        from dragonfly2_tpu.idl.messages import LinkType, PieceInfo
    else:
        from dragonfly2_tpu_torch.common.metrics import REGISTRY
        from dragonfly2_tpu_torch.daemon.piece_dispatcher import \
            PieceDispatcher
        from dragonfly2_tpu_torch.idl.messages import LinkType, PieceInfo
    picks = REGISTRY.counter("df_dispatch_pick_total",
                             "parent pick outcomes", ("outcome",))
    before = {o: picks.value(o) for o in OUTCOMES}

    def info(n: int) -> PieceInfo:
        return PieceInfo(piece_num=n, range_start=n * 16, range_size=16)

    async def go():
        random.seed(0)
        d = PieceDispatcher(explore_ratio=0.0)
        await d.add_parent("seed", "127.0.0.1:1", is_seed=True)
        await d.add_parent("ici", "127.0.0.1:2", link=LinkType.ICI)
        await d.add_parent("dcn", "127.0.0.1:3", link=LinkType.DCN)
        await d.announce("seed", [info(0)])            # only the seed
        await d.announce("dcn", [info(1)])             # only a DCN holder
        await d.announce("ici", [info(2)])
        await d.announce("dcn", [info(2)])             # ICI beats DCN
        out = []
        for _ in range(3):
            got = await d.get(timeout=1.0)
            out.append((got.parent.peer_id,
                        [p.piece_num for p in got.pieces]))
        return out

    dispatched = asyncio.run(go())
    after = {o: picks.value(o) - before[o] for o in OUTCOMES}
    return {"dispatched": sorted(dispatched), "picks": after}


@pytest.mark.parametrize("impl", ["reference", "port"])
def test_every_pick_is_counted_by_its_locality(impl):
    got = _script(impl)
    assert got["picks"] == {"seed": 1, "local": 1, "cross_local_known": 0,
                            "cross_no_local": 1}, got


def test_the_counts_equal_the_references():
    assert _script("port") == _script("reference")
