"""Deterministic fault injection at named sites.

Counterpart of ``dragonfly2_tpu/common/faultgate.py``, with its ten sites:

* ``rpc.unary`` (``rpc/client.py`` ``ServiceClient.unary``, inside the
  retried call, keyed by ``<address>/<service>/<method>``): bounded by
  the call's timeout, so ``fail:n=2`` walks the unary retry ladder and
  ``hang`` under a timeout is ``DEADLINE_EXCEEDED``;
* ``rpc.stream.read`` (``rpc/client.py``, the read halves of server and
  bidirectional streams; never a unary call's read);
* ``hbm.ingest`` (``tpu/hbm_sink.py`` ``DeviceIngest.write``): a raising
  script drives the conductor's sink-failure path, where the sink is
  disabled and the download finishes to disk;
* ``piece.wire`` (``daemon/piece_downloader.py``): ``hang`` parks a piece
  GET inside its deadline, ``corrupt`` flips the body's first byte before
  the landing check sees it;
* ``relay.stall`` (``daemon/upload_server.py`` streaming serve): ``hang``
  models an upstream whose landing watermark stopped advancing;
* ``upload.serve`` (``daemon/upload_server.py``, keyed by
  ``<host_id>|<task_id>``): ``corrupt`` flips a byte of a served range
  (``peek`` routes the serve off ``sendfile`` while such a script is
  armed); with ``pct`` a deterministic share of serves is poisoned
  (``tools/stress.py --byzantine``);
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
  back-source pull (``after_ms`` a ``Retry-After``), ``delay`` a slow
  origin.

Script syntax, clauses joined by ``;``: ``site[@keysub]=kind[:arg]...``
with kind ``fail``, ``error``, ``delay``, ``hang`` or ``corrupt`` and an
arg one of ``n=`` (fires, -1 forever; default 1), ``code=`` (a ``Code``
name or number; default UNAVAILABLE), ``after_ms=`` (the raised error's
``retry_after_ms``), ``delay_s=``, ``pct=`` (1-100: matching attempt k
fires iff ``k*pct//100 > (k-1)*pct//100``, a stride with no random
number, so chaos runs replay) or positional (a float is ``delay_s``, an
int ``n``). ``arm_script`` parses every clause before it arms any, where
the reference arms clause by clause and may leave the clauses before a
bad one armed.

Call sites guard with ``if faultgate.ARMED:`` so a disarmed process pays
one attribute load. Scripts arm from code (``arm``), from the text syntax
(``arm_script``) or over HTTP on a daemon started with
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

SITES = frozenset({"rpc.unary", "rpc.stream.read", "hbm.ingest",
                   "piece.wire", "relay.stall", "upload.serve",
                   "sched.register", "pex.gossip", "sched.snapshot.io",
                   "source.fetch"})
KINDS = frozenset({"fail", "error", "delay", "hang", "corrupt"})

# fast-path flag: True iff at least one script is armed
ARMED = False

_injected = REGISTRY.counter("df_fault_injected_total",
                             "faults injected by the faultgate plane",
                             ("site", "kind"))


class FaultScript:
    """One armed fault at one site, optionally key-scoped."""

    __slots__ = ("site", "kind", "key", "n", "code", "after_ms", "delay_s",
                 "pct", "attempts", "fired")

    def __init__(self, site: str, kind: str, *, key: str = "", n: int = 1,
                 code: Code = Code.UNAVAILABLE, after_ms: int = 0,
                 delay_s: float = 0.5, pct: int = 100):
        if site not in SITES:
            raise ValueError(f"unknown faultgate site {site!r} "
                             f"(known: {sorted(SITES)})")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(known: {sorted(KINDS)})")
        if not 1 <= int(pct) <= 100:
            raise ValueError(f"pct must be 1-100, got {pct!r}")
        self.site = site
        self.kind = kind
        self.key = key
        self.n = n              # remaining fires; -1 = forever
        self.code = Code(code)
        self.after_ms = int(after_ms)
        self.delay_s = float(delay_s)
        self.pct = int(pct)     # fire on this % of matching attempts
        self.attempts = 0       # matching attempts seen (the pct stride)
        self.fired = 0

    def matches(self, key: str) -> bool:
        return self.n != 0 and (not self.key or self.key in key)

    def due(self) -> bool:
        """Count one matching attempt: attempt k fires iff
        ``k*pct//100`` advanced past ``(k-1)*pct//100``; pct 100 fires
        every attempt."""
        self.attempts += 1
        if self.pct >= 100:
            return True
        return (self.attempts * self.pct) // 100 \
            > ((self.attempts - 1) * self.pct) // 100

    def consume(self) -> None:
        self.fired += 1
        if self.n > 0:
            self.n -= 1

    def describe(self) -> dict:
        return {"site": self.site, "kind": self.kind, "key": self.key,
                "remaining": self.n, "fired": self.fired,
                "attempts": self.attempts, "pct": self.pct,
                "code": self.code.name, "after_ms": self.after_ms,
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
    log.info("faultgate armed: %s", script.describe())
    return script


def arm_script(text: str) -> list[FaultScript]:
    """Arm from the text syntax (module docstring). Every clause is
    parsed before any is armed: a bad clause raises ``ValueError`` (or
    ``KeyError`` for an unknown code name) and arms nothing."""
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
            elif name == "after_ms":
                kwargs["after_ms"] = int(value)
            elif name == "delay_s":
                kwargs["delay_s"] = float(value)
            elif name == "pct":
                kwargs["pct"] = int(value)
            else:
                raise ValueError(f"unknown faultgate arg {name!r} in "
                                 f"{clause!r}")
        parsed.append(FaultScript(site.strip(), parts[0].strip(), **kwargs))
    with _lock:
        _scripts.extend(parsed)
        _recompute_armed()
    for script in parsed:
        log.info("faultgate armed: %s", script.describe())
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
    return (s.site == site and s.matches(key)
            and (kinds is None or s.kind in kinds))


def _claim(site: str, key: str, *, kinds: frozenset | None = None
           ) -> FaultScript | None:
    """Find and consume the first matching script that is due. A matching
    script whose stride says "not this attempt" counts the attempt and
    yields no fire; later scripts still get their chance."""
    with _lock:
        for s in _scripts:
            if _matches(s, site, key, kinds):
                if not s.due():
                    continue
                s.consume()
                _recompute_armed()
                return s
    return None


def peek(site: str, key: str = "", *, kinds: frozenset | None = None) -> bool:
    """True when an armed script would match (site, key), without
    consuming a fire or advancing the pct stride. The upload server's
    ``sendfile`` branch never sees the bytes, so it reads this to route a
    serve through the corruptible path while a script is armed."""
    with _lock:
        return any(_matches(s, site, key, kinds) for s in _scripts)


_RAISING = frozenset({"fail", "error"})
_ASYNC_KINDS = frozenset({"fail", "error", "delay", "hang"})


def _raise(script: FaultScript) -> None:
    err = DFError(script.code,
                  f"faultgate[{script.site}]: injected {script.kind}")
    if script.after_ms:
        err.retry_after_ms = script.after_ms
    raise err


async def fire(site: str, key: str = "") -> None:
    """Fire at an async site: fail/error raise a DFError (with
    ``retry_after_ms`` when the script has ``after_ms``), delay sleeps,
    hang parks until the caller's own deadline cancels it. ``corrupt``
    scripts are left for ``corrupt()``."""
    script = _claim(site, key, kinds=_ASYNC_KINDS)
    if script is None:
        return
    _injected.labels(site, script.kind).inc()
    log.info("faultgate fired: %s key=%r", script.describe(), key)
    if script.kind in _RAISING:
        _raise(script)
    elif script.kind == "delay":
        await asyncio.sleep(script.delay_s)
    elif script.kind == "hang":
        await asyncio.sleep(3600.0)   # the site's deadline cancels us


def corrupt(site: str, data, key: str = ""):
    """Consume one due ``corrupt`` script armed for (site, key), counted
    even when ``data`` is empty: the first byte of ``data`` is flipped,
    so the digest check downstream fails. Returns the bytes, corrupted
    or not; a bytearray is flipped in place."""
    script = _claim(site, key, kinds=frozenset({"corrupt"}))
    if script is None:
        return data
    _injected.labels(site, script.kind).inc()
    log.info("faultgate corrupting %d bytes at %s key=%r", len(data), site,
             key)
    if not len(data):
        return data
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
    log.info("faultgate fired (sync): %s key=%r", script.describe(), key)
    if script.kind == "delay":
        time.sleep(script.delay_s)
        return
    _raise(script)


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
