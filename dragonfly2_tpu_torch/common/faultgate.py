"""Deterministic fault injection at named sites, cut to this slice.

Counterpart of ``dragonfly2_tpu/common/faultgate.py``. The slice fires one
site, ``hbm.ingest`` (``tpu/hbm_sink.py`` ``DeviceIngest.write``): a raising
script there drives the conductor's sink-failure path, where the sink is
disabled and the download finishes to disk. Call sites guard with
``if faultgate.ARMED:`` so a disarmed process pays one attribute load.
"""

from __future__ import annotations

import logging
import threading
import time

from .errors import Code, DFError
from .metrics import REGISTRY

log = logging.getLogger("df.faultgate")

SITES = frozenset({"hbm.ingest"})
KINDS = frozenset({"fail", "error", "delay", "hang"})

# fast-path flag: True iff at least one script is armed
ARMED = False

_injected = REGISTRY.counter("df_fault_injected_total",
                             "faults injected by the faultgate plane",
                             ("site", "kind"))


class FaultScript:
    """One armed fault at one site, optionally key-scoped."""

    __slots__ = ("site", "kind", "key", "n", "code", "delay_s", "fired")

    def __init__(self, site: str, kind: str, *, key: str = "", n: int = 1,
                 code: Code = Code.UNAVAILABLE, delay_s: float = 0.5):
        if site not in SITES:
            raise ValueError(f"unknown faultgate site {site!r} "
                             f"(known: {sorted(SITES)})")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(known: {sorted(KINDS)})")
        self.site = site
        self.kind = kind
        self.key = key
        self.n = n              # remaining fires; -1 = forever
        self.code = Code(code)
        self.delay_s = float(delay_s)
        self.fired = 0


_scripts: list[FaultScript] = []
_lock = threading.Lock()   # hbm.ingest fires from the sink's caller thread


def _recompute_armed() -> None:
    global ARMED
    ARMED = any(s.n != 0 for s in _scripts)


def arm(site: str, kind: str, **kwargs) -> FaultScript:
    """Arm one scripted fault; returns the script (live counters)."""
    script = FaultScript(site, kind, **kwargs)
    with _lock:
        _scripts.append(script)
        _recompute_armed()
    return script


def reset() -> None:
    """Disarm everything (tests call this in teardown)."""
    with _lock:
        _scripts.clear()
        _recompute_armed()


def _claim(site: str, key: str) -> FaultScript | None:
    with _lock:
        for s in _scripts:
            if s.site == site and s.n != 0 and (not s.key or s.key in key):
                s.fired += 1
                if s.n > 0:
                    s.n -= 1
                _recompute_armed()
                return s
    return None


def fire_sync(site: str, key: str = "") -> None:
    """Fire at a sync site: fail/error raise a DFError; delay blocks the
    calling thread; hang is treated as fail (a sync site cannot park
    cancellably)."""
    script = _claim(site, key)
    if script is None:
        return
    _injected.labels(site, script.kind).inc()
    log.info("faultgate fired (sync): %s/%s key=%r", site, script.kind, key)
    if script.kind == "delay":
        time.sleep(script.delay_s)
        return
    raise DFError(script.code,
                  f"faultgate[{script.site}]: injected {script.kind}")
