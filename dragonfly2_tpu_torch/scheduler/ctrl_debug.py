"""Control-plane observatory surface: ``GET /debug/ctrl``.

Counterpart of ``dragonfly2_tpu/scheduler/ctrl_debug.py``: the ruling
profiler's aggregates (``common/phasetimer.py``: rulings/sec, per-phase
p50/p99, queue wait vs compute) joined with the bytes of state each
control-plane component holds (``state_bytes()`` of the resource, the
decision ledger, the federation, the quarantine registry and shard
affinity; disabled components are skipped, not zero) and the state
store's recovery provenance, served on the scheduler launcher's ``--debug-port`` next to
``/debug/cluster``.

The state walk is O(every object the scheduler holds), so it runs behind
a TTL cache and the payload reports its ``state_staleness_s``.
``?arm=1`` / ``?arm=0`` arms or disarms the profiler live.
"""

from __future__ import annotations

import time

from ..common import phasetimer
from ..common.metrics import REGISTRY

_state_bytes_gauge = REGISTRY.gauge(
    "df_ctrl_state_bytes",
    "bytes of control-plane state held per component (deep-sizeof walk, "
    "refreshed at the /debug/ctrl TTL cadence)", ("component",))

STATE_TTL_S = 5.0       # state-bytes walk cache; staleness is reported


class CtrlObservatory:
    """Holds the component refs and the TTL-cached state-bytes walk."""

    def __init__(self, *, resource=None, ledger=None, federation=None,
                 quarantine=None, sharded=None, statestore=None,
                 model_provenance=None, ttl_s: float = STATE_TTL_S,
                 clock=time.monotonic) -> None:
        self.components = {
            "resource": resource,
            "ledger": ledger,
            "federation": federation,
            "quarantine": quarantine,
            "shard_affinity": sharded,
        }
        self.statestore = statestore
        # zero-arg callable → rollout-provenance dict (the announcer's
        # model_provenance); None on schedulers without a learning loop
        self.model_provenance = model_provenance
        self.ttl_s = ttl_s
        self.clock = clock
        self._state_cache: dict | None = None
        self._state_at = 0.0

    def peer_count(self) -> int:
        res = self.components.get("resource")
        if res is None:
            return 0
        return sum(len(t.peers) for t in res.tasks.values())

    def state_bytes(self) -> dict:
        """Per-component bytes + per-peer quotient, behind the TTL."""
        now = self.clock()
        if (self._state_cache is not None
                and now - self._state_at <= self.ttl_s):
            return self._state_cache
        per = {name: comp.state_bytes()
               for name, comp in self.components.items()
               if comp is not None}
        for name, b in per.items():
            _state_bytes_gauge.labels(name).set(b)
        total = sum(per.values())
        peers = self.peer_count()
        self._state_cache = {
            "components": per,
            "total": total,
            "peers": peers,
            "per_peer": round(total / peers, 1) if peers else 0.0,
        }
        self._state_at = now
        return self._state_cache

    def snapshot(self) -> dict:
        snap = phasetimer.snapshot()
        snap["state_bytes"] = self.state_bytes()
        snap["state_staleness_s"] = round(
            max(self.clock() - self._state_at, 0.0), 3)
        snap["state_ttl_s"] = self.ttl_s
        # recovered-vs-rebuilt provenance: which slices of this brain's
        # view came back from the durable snapshot (statestore.restore)
        # vs were relearned live from announce/register traffic — an
        # operator reading /debug/ctrl after an incident can tell whether
        # the scheduler is ruling from memory or from hearsay
        if self.statestore is not None:
            snap["recovery"] = self.statestore.provenance
        # model-rollout provenance: which trained brain (if any) the ml
        # evaluator is serving, every blob refused at bind time, and the
        # serve-time fallback tally — dfdiag --ctrl names a degraded
        # evaluator from this block
        if self.model_provenance is not None:
            snap["model"] = self.model_provenance()
        return snap


def add_ctrl_routes(router, obs: CtrlObservatory) -> None:
    """``GET /debug/ctrl`` (``?arm=1`` / ``?arm=0`` switch the profiler
    first), on the scheduler launcher's ``--debug-port`` server."""

    async def ctrl(_params, query):
        arm = query.get("arm", "")
        if arm in ("1", "true"):
            phasetimer.arm()
        elif arm in ("0", "false"):
            phasetimer.disarm()
        return 200, obs.snapshot()

    router.add_get("/debug/ctrl", ctrl)
