"""Deterministic fault injection at named sites.

Counterpart of ``dragonfly2_tpu/common/faultgate.py`` cut to the sites the
port fires:

* ``hbm.ingest`` (``tpu/hbm_sink.py`` ``DeviceIngest.write``): a raising
  script drives the conductor's sink-failure path, where the sink is
  disabled and the download finishes to disk;
* ``piece.wire`` (``daemon/piece_downloader.py``): ``hang`` parks a piece
  GET inside its deadline, ``corrupt`` flips the body's first byte before
  the landing check sees it;
* ``relay.stall`` (``daemon/upload_server.py`` streaming serve): ``hang``
  models an upstream whose landing watermark stopped advancing;
* ``upload.serve`` (``daemon/upload_server.py``): ``corrupt`` flips a byte
  of a served range (``peek`` routes the serve off ``sendfile`` while
  such a script is armed);
* ``sched.register`` (``daemon/scheduler_session.py``): fired before each
  ring member's register dial, bounded by the register timeout, so
  ``fail`` and ``hang`` walk the failover ladder a dead or wedged
  scheduler would;
* ``pex.gossip`` (``daemon/pex.py``): ``fail`` drops one edge's digest
  exchange, ``corrupt`` flips a byte of the outbound envelope so the
  receiver's checksum rejects it;
* ``sched.snapshot.io`` (``scheduler/statestore.py`` persist path, keyed
  by the snapshot reason): ``corrupt`` flips a byte of the serialized
  blob so load refuses it wholesale, ``error``/``fail`` raise
  mid-persist, ``delay`` models a slow disk;
* ``source.fetch`` (``source/client.py`` module-level ``download``, keyed
  by the URL): ``error``/``fail`` play an origin failure for that URL's
  back-source pull, ``delay`` a slow origin.

Call sites guard with ``if faultgate.ARMED:`` so a disarmed process pays
one attribute load. Scripts arm from code (``arm``), from the reference's
text syntax (``arm_script``: ``site[@key]=kind[:n][:delay_s][:code=NAME]``
clauses joined by ``;``) or over HTTP on a daemon started with
``upload.debug_endpoints`` (``add_fault_routes``: ``GET``/``POST``/
``DELETE /debug/faults``).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time

from .errors import Code, DFError
from .metrics import REGISTRY

log = logging.getLogger("df.faultgate")

SITES = frozenset({"hbm.ingest", "piece.wire", "relay.stall",
                   "upload.serve", "sched.register", "pex.gossip",
                   "sched.snapshot.io", "source.fetch"})
KINDS = frozenset({"fail", "error", "delay", "hang", "corrupt"})

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

    def describe(self) -> dict:
        """The reference's script row. This cut fires every matching
        attempt at once, so ``pct`` is 100, ``after_ms`` 0 and
        ``attempts`` the fire count."""
        return {"site": self.site, "kind": self.kind, "key": self.key,
                "remaining": self.n, "fired": self.fired,
                "attempts": self.fired, "pct": 100,
                "code": self.code.name, "after_ms": 0,
                "delay_s": self.delay_s}


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


def arm_script(text: str) -> list[FaultScript]:
    """Arm from the reference's text syntax: ``;``-joined clauses of
    ``site[@key]=kind[:arg]...``, an arg being ``n=``, ``code=`` (a
    ``Code`` name or number), ``delay_s=``, or positional (a float is
    ``delay_s``, an int ``n``). ``pct`` below 100 and ``after_ms`` above 0
    are refused: this cut fires every matching attempt at once."""
    parsed = []
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        head, _, spec = clause.partition("=")
        if not spec:
            raise ValueError(f"bad faultgate clause {clause!r} "
                             "(want site[@key]=kind[:arg]...)")
        site, _, key = head.partition("@")
        parts = spec.split(":")
        kwargs: dict = {"key": key.strip()}
        for arg in parts[1:]:
            arg = arg.strip()
            if not arg:
                continue
            name, eq, value = arg.partition("=")
            if not eq:
                if "." in name:
                    kwargs["delay_s"] = float(name)
                else:
                    kwargs["n"] = int(name)
            elif name == "n":
                kwargs["n"] = int(value)
            elif name == "code":
                kwargs["code"] = (Code(int(value))
                                  if value.lstrip("-").isdigit()
                                  else Code[value])
            elif name == "delay_s":
                kwargs["delay_s"] = float(value)
            elif (name, value) in (("pct", "100"), ("after_ms", "0")):
                continue
            else:
                raise ValueError(f"unsupported faultgate arg {name!r} in "
                                 f"{clause!r}")
        parsed.append(FaultScript(site.strip(), parts[0].strip(), **kwargs))
    with _lock:
        _scripts.extend(parsed)
        _recompute_armed()
    return parsed


def status() -> dict:
    with _lock:
        return {"armed": ARMED, "scripts": [s.describe() for s in _scripts]}


def reset() -> None:
    """Disarm everything (tests call this in teardown)."""
    with _lock:
        _scripts.clear()
        _recompute_armed()


def _matches(s: FaultScript, site: str, key: str,
             kinds: frozenset | None) -> bool:
    return (s.site == site and s.n != 0 and (not s.key or s.key in key)
            and (kinds is None or s.kind in kinds))


def _claim(site: str, key: str, *, kinds: frozenset | None = None
           ) -> FaultScript | None:
    with _lock:
        for s in _scripts:
            if _matches(s, site, key, kinds):
                s.fired += 1
                if s.n > 0:
                    s.n -= 1
                _recompute_armed()
                return s
    return None


def peek(site: str, key: str = "", *, kinds: frozenset | None = None) -> bool:
    """True when an armed script would match (site, key), without
    consuming a fire. The upload server's ``sendfile`` branch never sees
    the bytes, so it reads this to route a serve through the corruptible
    path while a script is armed."""
    with _lock:
        return any(_matches(s, site, key, kinds) for s in _scripts)


_ASYNC_KINDS = frozenset({"fail", "error", "delay", "hang"})


async def fire(site: str, key: str = "") -> None:
    """Fire at an async site: fail/error raise a DFError, delay sleeps,
    hang parks until the caller's own deadline cancels it. ``corrupt``
    scripts are left for ``corrupt()``."""
    script = _claim(site, key, kinds=_ASYNC_KINDS)
    if script is None:
        return
    _injected.labels(site, script.kind).inc()
    log.info("faultgate fired: %s/%s key=%r", site, script.kind, key)
    if script.kind == "delay":
        await asyncio.sleep(script.delay_s)
    elif script.kind == "hang":
        await asyncio.sleep(3600.0)   # the site's deadline cancels us
    else:
        raise DFError(script.code,
                      f"faultgate[{script.site}]: injected {script.kind}")


def corrupt(site: str, data, key: str = ""):
    """Consume one ``corrupt`` script armed for (site, key): the first
    byte of ``data`` is flipped, so the digest check downstream fails.
    Returns the bytes, corrupted or not; a bytearray is flipped in
    place."""
    script = _claim(site, key, kinds=frozenset({"corrupt"}))
    if script is None or not len(data):
        return data
    _injected.labels(site, script.kind).inc()
    log.info("faultgate corrupting %d bytes at %s key=%r", len(data), site,
             key)
    if isinstance(data, bytearray):
        data[0] ^= 0xFF
        return data
    buf = bytearray(data)
    buf[0] ^= 0xFF
    return bytes(buf)


def fire_sync(site: str, key: str = "") -> None:
    """Fire at a sync site: fail/error raise a DFError; delay blocks the
    calling thread; hang is treated as fail (a sync site cannot park
    cancellably)."""
    script = _claim(site, key, kinds=_ASYNC_KINDS)
    if script is None:
        return
    _injected.labels(site, script.kind).inc()
    log.info("faultgate fired (sync): %s/%s key=%r", site, script.kind, key)
    if script.kind == "delay":
        time.sleep(script.delay_s)
        return
    raise DFError(script.code,
                  f"faultgate[{script.site}]: injected {script.kind}")


def add_fault_routes(router) -> None:
    """The fault-injection control surface, mounted on the daemon's upload
    server under ``upload.debug_endpoints`` (arming mutates live
    behaviour): ``GET /debug/faults`` -> ``{"armed", "scripts"}``;
    ``POST`` arms the script text in its body; ``DELETE`` resets."""

    async def get_faults(_params, _query):
        return 200, status()

    async def post_faults(_params, _query, body: bytes):
        try:
            armed = arm_script(body.decode("utf-8", "replace").strip())
        except (ValueError, KeyError) as exc:
            return 400, {"error": str(exc)}
        return 200, {"armed": [s.describe() for s in armed]}

    async def delete_faults(_params, _query):
        reset()
        return 200, status()

    router.add_get("/debug/faults", get_faults)
    router.add_post("/debug/faults", post_faults)
    router.add_delete("/debug/faults", delete_faults)
