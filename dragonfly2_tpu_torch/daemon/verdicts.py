"""Per-parent verdict ledger: the daemon's local half of the swarm
immune system.

Counterpart of ``dragonfly2_tpu/daemon/verdicts.py``, with its names,
thresholds, decay and snapshot format. Dragonfly2 catches a corrupt piece
at the child's landing, requeues it, and may pull from the same poisoner
again; its only long-term ejector is the scheduler's statistical
slowness check, which a *lying* parent never trips. This module gives every daemon a decayed, typed
memory of how each parent has behaved, consulted locally by the piece
engine (parent admission), the PEX rung (holder filtering/ordering), and
relay parent choice — so a parent that served corruption is shunned even
when no scheduler is reachable.

Evidence rules (the anti-slander contract):

* **local verdicts quarantine** — only failures THIS daemon verified
  first-hand (``record``) can shun a parent. ``corrupt`` is hard
  evidence (the bytes landed and failed the digest check: not
  congestion, not load); ``SHUN_THRESHOLD`` decayed corrupt verdicts
  flip the parent to locally shunned.
* **gossip hints only deprioritize** — a PEX digest claiming some third
  party served corruption (``hint``) may move that party to the back of
  the parent ordering, never off it. Accepting remote accusations as
  shunning evidence would let one byzantine gossiper evict any honest
  host from the whole pod with a forged digest.
* **self-quarantine** — when the daemon's OWN storage fails
  re-verification (boot reload re-hash, content-store placement
  re-hash), it is the poisoner: it stops advertising tasks in PEX
  digests and flags its AnnounceHost/register ``Host.quarantined`` so
  the scheduler excludes it pod-wide. Sticky for the process lifetime —
  bit-rot does not heal without operator action, and a restart re-runs
  the boot re-verify that clears it.

Counters use half-life decay on an injectable clock so a genuinely
repaired parent works its way back (the scheduler's probation ladder is
the authoritative reprieve path; this ledger just stops re-shunning once
the evidence has decayed).
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from ..common.metrics import REGISTRY
from ..idl.messages import FAIL_CODES

log = logging.getLogger("df.flow.verdicts")

_verdicts = REGISTRY.counter(
    "df_verdict_total",
    "typed piece-failure verdicts recorded against parents, by the "
    "FAIL_CODES vocabulary", ("code",))
_hints = REGISTRY.counter(
    "df_verdict_hints_total",
    "third-party corruption accusations received over PEX gossip "
    "(anti-slander: these deprioritize, never shun)")
_shunned_gauge = REGISTRY.gauge(
    "df_verdict_shunned_parents",
    "parent addresses this daemon currently shuns on local corrupt "
    "verdicts")
_selfq_gauge = REGISTRY.gauge(
    "df_verdict_self_quarantined",
    "1 while this daemon has self-quarantined after detecting its own "
    "storage bit-rot")

# decayed local corrupt verdicts at which a parent flips to shunned —
# deliberately small: corruption is verified evidence, and every further
# transfer from the parent is wasted wire bytes plus a re-pull
SHUN_THRESHOLD = 2.0
# a single decayed local corrupt verdict (or any gossip hint) is enough
# to DEPRIORITIZE: order the parent behind clean holders without
# excluding it
SUSPECT_THRESHOLD = 0.75


class _Parent:
    """Decayed per-code failure counters + bookkeeping for one parent
    address."""

    __slots__ = ("codes", "relayed_corrupt", "at", "ok", "peer_ids",
                 "hinted_at")

    def __init__(self) -> None:
        self.codes: dict[str, float] = {}
        # corrupt verdicts on CUT-THROUGH transfers (X-DF-Relay), decayed
        # on the same clock: circumstantial — the bytes originated
        # upstream of the relay — so this mass deprioritizes, never shuns
        self.relayed_corrupt = 0.0
        self.at = 0.0
        self.ok = 0
        self.peer_ids: set[str] = set()      # recent peer ids at this addr
        self.hinted_at: float | None = None  # last gossip accusation

    def decay(self, now: float, halflife_s: float) -> None:
        if (not self.codes and not self.relayed_corrupt) \
                or halflife_s <= 0:
            self.at = now
            return
        factor = 0.5 ** (max(now - self.at, 0.0) / halflife_s)
        self.codes = {c: v * factor for c, v in self.codes.items()
                      if v * factor > 0.01}
        self.relayed_corrupt *= factor
        if self.relayed_corrupt < 0.01:
            self.relayed_corrupt = 0.0
        self.at = now


class VerdictLedger:
    """Daemon-wide typed failure memory, keyed by parent address
    (``ip:download_port`` — peer ids are per-task, addresses are the
    stable identity a byzantine host keeps across tasks)."""

    def __init__(self, *, halflife_s: float = 600.0,
                 shun_threshold: float = SHUN_THRESHOLD,
                 hint_ttl_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic):
        self.halflife_s = halflife_s
        self.shun_threshold = shun_threshold
        self.hint_ttl_s = hint_ttl_s
        self.clock = clock
        self._parents: dict[str, _Parent] = {}
        self.self_quarantined = False
        self.self_reason = ""

    # -- local verdicts (first-hand evidence) --------------------------

    def _get(self, addr: str) -> _Parent:
        p = self._parents.get(addr)
        if p is None:
            p = self._parents[addr] = _Parent()
            p.at = self.clock()
        return p

    def record(self, addr: str, code: str, *, peer_id: str = "",
               relayed: bool = False) -> bool:
        """One locally-verified failure verdict against ``addr``.
        Returns True when this verdict FLIPPED the parent to shunned —
        the caller journals the ``quarantine`` flight event exactly
        once per flip.

        ``relayed`` corruption (the transfer rode the parent's
        cut-through path, X-DF-Relay) is CIRCUMSTANTIAL evidence kept in
        its own decayed counter: the corrupt bytes originated upstream
        of the relay, whose own landing check is about to catch,
        requeue, and stop re-serving them — and however much of it
        accumulates it can only DEPRIORITIZE, never shun. Any lesser
        rule lets one poisoner get every honest relay below it evicted
        (found live by the chaos e2e: at 100% poisoning a busy relay
        racks up relayed verdicts faster than any discount absorbs).
        The true source still earns DIRECT verdicts — from each relay's
        own landing check and from every post-landing disk serve."""
        if not addr or code not in FAIL_CODES:
            return False
        _verdicts.labels(code).inc()
        p = self._get(addr)
        p.decay(self.clock(), self.halflife_s)
        if relayed and code == "corrupt":
            p.relayed_corrupt += 1.0
            if peer_id:
                p.peer_ids.add(peer_id)
            self._export()
            return False
        prev = p.codes.get(code, 0.0)
        p.codes[code] = prev + 1.0
        if peer_id:
            p.peer_ids.add(peer_id)
            if len(p.peer_ids) > 8:
                p.peer_ids.pop()
        # a FLIP is the threshold CROSSING, not a one-shot latch: evidence
        # that decayed below the threshold re-admits the parent, and a
        # re-offense must sever it (and journal) again — a sticky
        # first-flip-only flag would silently disable the response for
        # every relapse after the first decay cycle
        flipped = (code == "corrupt" and prev < self.shun_threshold
                   and p.codes[code] >= self.shun_threshold)
        if flipped:
            log.warning("parent %s shunned: %.1f decayed corrupt "
                        "verdict(s) — locally quarantined", addr,
                        p.codes["corrupt"])
        self._export()
        return flipped

    def record_ok(self, addr: str) -> None:
        if not addr:
            return
        p = self._parents.get(addr)
        if p is not None:
            p.ok += 1

    # -- gossip hints (hearsay: deprioritize ONLY) ---------------------

    # ledger size bound: parents this daemon actually TALKS to are
    # naturally bounded, but hint() ingests attacker-controlled address
    # strings from gossip — without a cap, forged digests with fresh fake
    # addresses every round would grow the ledger (and every snapshot /
    # shunned_addrs walk) without bound
    MAX_PARENTS = 512

    def hint(self, addr: str) -> None:
        """A PEX digest accused ``addr`` of serving corruption. Hearsay:
        refresh the deprioritization window, never the shun counters —
        one byzantine gossiper must not be able to evict an honest host
        (the anti-slander rule)."""
        if not addr:
            return
        _hints.inc()
        if addr not in self._parents \
                and len(self._parents) >= self.MAX_PARENTS:
            # evict the stalest hint-only entry to make room; with none
            # evictable (every entry carries first-hand history), drop
            # the hint — hearsay must never push out real evidence
            victim = min(
                (a for a, p in self._parents.items()
                 if not p.codes and not p.relayed_corrupt and not p.ok),
                key=lambda a: self._parents[a].hinted_at or 0.0,
                default=None)
            if victim is None:
                return
            del self._parents[victim]
        self._get(addr).hinted_at = self.clock()

    # -- queries -------------------------------------------------------

    def corrupt_score(self, addr: str) -> float:
        p = self._parents.get(addr)
        if p is None:
            return 0.0
        p.decay(self.clock(), self.halflife_s)
        return p.codes.get("corrupt", 0.0)

    def shunned(self, addr: str) -> bool:
        """Locally quarantined: enough first-hand corrupt evidence that
        this daemon will not pull from, or index swarm claims of, the
        address — scheduler reachable or not."""
        return self.corrupt_score(addr) >= self.shun_threshold

    def deprioritized(self, addr: str) -> bool:
        """Order behind clean holders (still usable): one local corrupt
        verdict, or a fresh gossip hint."""
        p = self._parents.get(addr)
        if p is None:
            return False
        if p.hinted_at is not None \
                and self.clock() - p.hinted_at <= self.hint_ttl_s:
            return True
        # decay FIRST: a healed relay must work its way back on the same
        # half-life as everything else, not stay deprioritized on a
        # stale counter forever
        p.decay(self.clock(), self.halflife_s)
        if p.relayed_corrupt >= SUSPECT_THRESHOLD:
            return True
        return p.codes.get("corrupt", 0.0) >= SUSPECT_THRESHOLD

    def shunned_addrs(self) -> list[str]:
        return sorted(a for a in self._parents if self.shunned(a))

    # -- self-quarantine -----------------------------------------------

    def self_quarantine(self, reason: str) -> None:
        """This daemon's own storage failed re-verification: it may BE
        the poisoner. Stop advertising (PEX) and flag AnnounceHost —
        the scheduler's registry does the pod-wide half."""
        if not self.self_quarantined:
            log.error("SELF-QUARANTINE: %s — this daemon stops "
                      "advertising and flags its announces", reason)
        self.self_quarantined = True
        self.self_reason = reason
        _selfq_gauge.set(1)

    def _export(self) -> None:
        _shunned_gauge.set(sum(1 for a in self._parents
                               if self.shunned(a)))

    # -- debug surface (GET /debug/verdicts) ---------------------------

    def snapshot(self) -> dict:
        now = self.clock()
        parents = {}
        for addr, p in self._parents.items():
            p.decay(now, self.halflife_s)
            parents[addr] = {
                "codes": {c: round(v, 3) for c, v in p.codes.items()},
                "relayed_corrupt": round(p.relayed_corrupt, 3),
                "ok": p.ok,
                "peer_ids": sorted(p.peer_ids),
                "shunned": self.shunned(addr),
                "deprioritized": self.deprioritized(addr),
                "hinted": bool(p.hinted_at is not None
                               and now - p.hinted_at <= self.hint_ttl_s),
            }
        return {
            "self_quarantined": self.self_quarantined,
            "self_reason": self.self_reason,
            "shun_threshold": self.shun_threshold,
            "halflife_s": self.halflife_s,
            "parents": parents,
        }


def add_verdict_routes(router, ledger: VerdictLedger) -> None:
    """``GET /debug/verdicts`` on a ``common.httpd.Router`` — mounted on
    the daemon upload server next to /debug/flight (read-only, bounded by
    the parent count a daemon actually talks to, so always on: a poisoned
    pod must be diagnosable — ``dfdiag --pod`` sweeps this surface)."""

    async def verdicts(_params: dict, _query: dict) -> tuple[int, dict]:
        return 200, ledger.snapshot()

    router.add_get("/debug/verdicts", verdicts)
