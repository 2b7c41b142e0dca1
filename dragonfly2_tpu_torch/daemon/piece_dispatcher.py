"""Piece dispatcher: picks the next (piece, parent) pair for a worker.

Counterpart of ``dragonfly2_tpu/daemon/piece_dispatcher.py``, with the
sharded-task piece classes (``set_shard_state``: pieces outside the
requested subset are never dispatched, and swap-class pieces wait out
``SWAP_HOLD_S`` before a seed may serve them). Unlike the reference, a
download in an affinity split takes equally rare pieces oldest first, and
a swap-class piece only seeds hold waits ``SUPERSEED_REVEAL_S`` longer:
the time a rationing seed may take to tell the owning replica of it. Reference
``client/daemon/peer/piece_dispatcher.go`` scores
parents by observed per-byte piece latency with epsilon-random exploration
(``DefaultPieceDispatcherRandomRatio``), so fast ICI-local parents win the
steady state while new parents still get probed.

The dispatcher owns:
  * the queue of pieces still to fetch, each with the set of parents known
    to hold it;
  * per-parent latency EWMAs and failure counts (a parent past the failure
    limit is ejected and its queued pieces re-homed).

Workers call ``get()`` (blocks until a piece is dispatchable or the task is
finished) and then ``report(...)`` with the outcome.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time

from ..idl.messages import LinkType, PieceInfo

log = logging.getLogger("df.flow.dispatch")

# Demand-side locality: the scheduler annotates each offered parent with
# the link class it computed from pod topology (PeerAddr.link). Link class
# is a strict TIER in parent choice — any usable ICI holder outranks any
# DCN holder for the same piece. The bandwidth gap between tiers (ICI
# ~TB/s vs 100-400Gbps DCN NICs vs WAN, tpu.topology.LINK_BANDWIDTH_SCORE)
# is larger than any within-tier latency spread, so a scalar cost
# multiplier would let measurement noise invert the ordering exactly when
# links are uncongested. Saturation still escapes the tier: busy (503) and
# cooldown-ejected parents drop out of the holder set, and in-flight load
# shifts choice within the tier.
TIER_SAME_POD = 0    # LOCAL + ICI: the bytes never leave the pod's
                     # wired fabric — ICI moves them at memory-ish rates
TIER_CROSS_POD = 1   # DCN: pod-crossing, the thin tier cross-pod
                     # federation rations through elected pod seeds
TIER_CROSS_ZONE = 2  # WAN: cross-zone / unknown — last resort
LINK_TIER = {
    LinkType.LOCAL: TIER_SAME_POD,
    LinkType.ICI: TIER_SAME_POD,
    LinkType.DCN: TIER_CROSS_POD,
    LinkType.WAN: TIER_CROSS_ZONE,
}

EXPLORE_RATIO = 0.1          # epsilon for random parent choice
PARENT_FAIL_LIMIT = 3        # consecutive failures before ejection
PARENT_FAIL_HARD_LIMIT = 12  # lifetime failures before permanent removal
EJECT_COOLDOWN_S = 4.0       # local ejection is a cooldown, not a divorce
_EWMA_ALPHA = 0.3
BUSY_BACKOFF_S = 0.04        # base 503 backoff (doubles per consecutive busy)
BUSY_BACKOFF_MAX_S = 1.5     # cap on the exponential busy backoff
ENDGAME_RACE_AGE_S = 0.5     # min in-flight age before racing a duplicate


class ParentState:
    """Ejection semantics: a LOCAL failure verdict is a cooldown
    (``EJECT_COOLDOWN_S``), not a divorce — under load spikes a child that
    permanently severs pairs diverges from the scheduler's (stable) view,
    gets no corrective packet, and degenerates to seed-only for the rest of
    the task. A scheduler prune (``removed``) and the
    lifetime ``PARENT_FAIL_HARD_LIMIT`` stay permanent; the scheduler's
    Z-score bad-node check is the authoritative long-term ejector."""

    def __init__(self, peer_id: str, addr: str, *, is_seed: bool = False,
                 link: LinkType = LinkType.DCN):
        self.peer_id = peer_id
        self.addr = addr                # "ip:download_port"
        self.is_seed = is_seed
        self.link = link
        self.ns_per_byte = 0.0          # latency EWMA, 0 = no data yet
        self.consecutive_fails = 0
        self.total_fails = 0
        self.inflight = 0
        self.removed = False            # permanent (scheduler prune / hard cap)
        self.eject_until = 0.0          # local failure cooldown window
        self.busy_until = 0.0           # 503 backpressure: skip until then
        self.consecutive_busy = 0       # 503s since the last success
        self.attempts = 0               # pieces ever dispatched here
        self.announced = 0              # piece announcements received

    @property
    def ejected(self) -> bool:
        """Not usable right now."""
        return self.removed or self.eject_until > time.monotonic()

    def is_busy(self) -> bool:
        return self.busy_until > time.monotonic()

    def observe(self, cost_ms: int, size: int, ok: bool) -> None:
        if ok:
            self.consecutive_fails = 0
            self.consecutive_busy = 0
            if size > 0:
                sample = cost_ms * 1e6 / size
                if self.ns_per_byte == 0.0:
                    self.ns_per_byte = sample
                else:
                    self.ns_per_byte += _EWMA_ALPHA * (sample - self.ns_per_byte)
        else:
            self.consecutive_fails += 1
            self.total_fails += 1
            if self.total_fails >= PARENT_FAIL_HARD_LIMIT:
                self.removed = True
            elif self.consecutive_fails >= PARENT_FAIL_LIMIT:
                self.eject_until = time.monotonic() + EJECT_COOLDOWN_S
                self.consecutive_fails = 0   # fresh chances after cooldown

    def score(self) -> float:
        """Within-class cost, lower is better. Unprobed parents score best
        so they get traffic; in-flight load scales the expected latency (a
        parent already serving k pieces will deliver the k+1st ~k times
        slower), which spreads a fan-out across parents instead of herding
        onto the single fastest."""
        if self.ns_per_byte <= 0:
            return -1.0 + self.inflight * 0.01
        return self.ns_per_byte * (1.0 + self.inflight)

    def rank(self) -> tuple:
        """Full ordering for parent choice: seeds STRICTLY last, then link
        tier, then observed cost (see LINK_TIER rationale). The seed-last
        partition is absolute by design — the seed is the lender of last
        resort (its egress is the scarce resource a fan-out exists to
        conserve), so even a slow mesh peer outranks it; peers that are
        BROKEN rather than slow leave via the failure/cooldown path, and a
        busy-or-dead mesh means the seed still serves immediately."""
        return (1 if self.is_seed else 0,
                LINK_TIER.get(self.link, 1), self.score())


class _PieceState:
    __slots__ = ("info", "holders", "fetching", "first_seen", "dispatched_at")

    def __init__(self, info: PieceInfo):
        self.info = info
        self.holders: set[str] = set()   # parent peer ids that announced it
        self.fetching: set[str] = set()  # parents currently transferring it
        self.first_seen = time.monotonic()
        self.dispatched_at = 0.0         # when the LATEST fetch started

    @property
    def inflight(self) -> bool:
        return bool(self.fetching)


GROUP_LIMIT = 2   # max contiguous pieces per dispatch (one ranged GET)
# Locality grace: a piece whose KNOWN holders are all worse-tier (DCN/WAN/
# seed) is deferred this long after first sight, giving the same-slice
# holder's announcement time to arrive — dispatch-on-first-announcement
# otherwise coin-flips locality (announcement order is a network race, and
# hungry workers grab pieces the moment the first holder appears). Never
# idles a worker: deferred pieces dispatch immediately when nothing
# better-tiered is available.
LOCALITY_GRACE_S = 0.15
# a BUSY same-slice holder is still worth a longer wait than a free DCN
# one (503 backoff is 40ms; DCN costs the whole transfer at ~1/10th the
# bandwidth) — bounded so a stuck local holder can't starve the piece
BUSY_LOCAL_WAIT_S = 1.0
# a BUSY peer holder is worth a short wait before spending SEED egress:
# seed/origin-side bandwidth is the scarce fleet resource (BASELINE
# "% egress saved"), and a freshly idle seed otherwise becomes a magnet
# the moment sibling upload slots saturate
BUSY_PEER_SEED_WAIT_S = 0.6
ENDGAME_PIECES = 2   # remaining-piece count at which duplicate racing is allowed
# (kept tiny: each duplicate is a full extra transfer — on CPU-bound hosts
# racing the whole tail measurably SLOWS the wave; this is stall insurance
# for the final pieces, not a parallelism strategy)
# Sharded-task swap hold: a swap-class piece (assigned to a co-located
# replica's tree fetch) whose only usable holders are SEEDS waits this
# long for the replica to land and announce it. Pulling it from the tree
# at once would re-fetch every byte affinity deduped. Bounded, so a dead
# partner costs one extra tree fetch (df_shard_fallback_total), never a
# wedge.
SWAP_HOLD_S = 1.5
# A seed rations its announcements (daemon/rpcserver.py ``_SuperSeed``):
# it tells a landed piece to two children at once and to one more at each
# 0.5 s rotation tick, so with up to four children the replica that owns
# a swap-class piece may learn of it two ticks after this child did. A
# swap piece only seeds hold is held that much longer than SWAP_HOLD_S,
# so the owner keeps the whole hold for its fetch.
SUPERSEED_REVEAL_S = 2 * 0.5


class Dispatch:
    """One unit of work handed to a worker: one or more CONTIGUOUS pieces
    from one parent, fetched in a single ranged GET. Grouping amortizes the
    per-request cost (HTTP framing, asyncio dispatch, report round-trips)
    that dominates piece transfer on fast links — the same reason the
    back-source path reads piece groups (reference
    ``piece_manager.go:815 concurrentDownloadSourceByPieceGroup``)."""

    __slots__ = ("pieces", "parent")

    def __init__(self, pieces: list[PieceInfo], parent: ParentState):
        self.pieces = pieces
        self.parent = parent

    @property
    def piece(self) -> PieceInfo:   # single-piece convenience (tests, logs)
        return self.pieces[0]

    def size(self) -> int:
        return sum(p.range_size for p in self.pieces)


class PieceDispatcher:
    def __init__(self, *, explore_ratio: float = EXPLORE_RATIO,
                 ordered: bool = False):
        # ordered: fetch lowest-numbered first (stream consumers need early
        # bytes). File tasks use rarest-first instead: a fan-out where every
        # child grabs piece 0,1,2... holds identical sets and has nothing to
        # trade — rarest-first makes siblings complementary sources.
        self.ordered = ordered
        self.explore_ratio = explore_ratio
        self.parents: dict[str, ParentState] = {}
        self._pieces: dict[int, _PieceState] = {}
        self._done: set[int] = set()
        self._closed = False
        self._cond = asyncio.Condition()
        # endgame only when the TASK is nearly done (engine sets this from
        # total_pieces - ready); the local _pieces count is useless as a
        # gate because announcements are drip-fed — a child mid-swarm often
        # knows few undone pieces while hundreds remain
        self.endgame = False
        self._seed_hold_expiry: float | None = None   # see _pick seed grace
        # sharded tasks (set_shard_state): pieces this download needs at
        # all (None = every piece) and the swap-class subset held off
        # seed parents for SWAP_HOLD_S
        self.needed: set[int] | None = None
        self.swap_nums: set[int] = set()
        self.swap_hold_s = SWAP_HOLD_S

    # ------------------------------------------------------------------
    # feeding: parents + announced pieces
    # ------------------------------------------------------------------

    async def add_parent(self, peer_id: str, addr: str, *,
                         resurrect: bool = False,
                         is_seed: bool = False,
                         link: LinkType = LinkType.DCN) -> ParentState:
        """Known parents keep their state. An ejected parent stays ejected
        unless ``resurrect`` (an explicit scheduler re-assignment) — piece
        announcements must NOT revive a parent the failure limit removed."""
        if self._closed:     # teardown in progress: don't queue on a lock
            return ParentState(peer_id, addr, is_seed=is_seed, link=link)
        async with self._cond:
            st = self.parents.get(peer_id)
            if st is None or (st.ejected and resurrect):
                fresh = ParentState(peer_id, addr, is_seed=is_seed,
                                    link=link)
                if st is not None:
                    # carry HALVED lifetime failures across resurrection: a
                    # genuinely recovered parent works it off, a persistently
                    # bad one re-trips the hard cap quickly instead of
                    # getting a clean slate each scheduler re-offer
                    fresh.total_fails = st.total_fails // 2
                st = fresh
                self.parents[peer_id] = st
            else:
                st.addr = addr
                st.is_seed = st.is_seed or is_seed
                st.link = link
            self._cond.notify_all()
            return st

    def hard_removed(self, peer_id: str) -> bool:
        """Parent tripped the lifetime failure cap — only an explicit
        scheduler re-assignment may revive it, never the engine's automatic
        sync-stream resurrection."""
        st = self.parents.get(peer_id)
        return (st is not None and st.removed
                and st.total_fails >= PARENT_FAIL_HARD_LIMIT)

    async def remove_parent(self, peer_id: str) -> None:
        if self._closed:
            return
        async with self._cond:
            st = self.parents.get(peer_id)
            if st is not None:
                st.removed = True
            # drop it from holder sets too: rarest-first rarity counts must
            # reflect live sources or removed parents skew piece choice
            for ps in self._pieces.values():
                ps.holders.discard(peer_id)
            self._cond.notify_all()

    async def announce(self, parent_id: str, infos: list[PieceInfo]) -> None:
        """Parent reports it holds these pieces."""
        if self._closed:
            return
        async with self._cond:
            notify = False
            for info in infos:
                if info.piece_num in self._done:
                    continue
                ps = self._pieces.get(info.piece_num)
                if ps is None:
                    ps = _PieceState(info)
                    self._pieces[info.piece_num] = ps
                elif not ps.info.digest and info.digest:
                    ps.info = info
                ps.holders.add(parent_id)
                st = self.parents.get(parent_id)
                if st is not None:
                    st.announced += 1
                notify = True
            if notify:
                self._cond.notify_all()

    def set_shard_state(self, needed: set[int] | None,
                        swap_nums: set[int]) -> None:
        """Sharded-task piece classes (engine.apply_shard_state): pieces
        outside ``needed`` are never dispatched (their announcements are
        kept: a widen may need them later), ``swap_nums`` wait out the
        swap hold before a seed may serve them. Plain assignment (no
        condition round): workers re-pick within their bounded 0.5 s
        wake, and a mid-flight widen only ADDS dispatchable pieces."""
        self.needed = set(needed) if needed is not None else None
        self.swap_nums = set(swap_nums)

    def _dispatchable(self, num: int) -> bool:
        return self.needed is None or num in self.needed

    async def close(self) -> None:
        # already-closed short-circuit BEFORE touching the lock: teardown
        # calls close() more than once (engine finally + _teardown), and a
        # worker cancelled inside cond.wait can leave the condition lock
        # held by its orphaned waiter (3.10 wait_for+Condition hazard) —
        # the second close must never queue on that lock
        if self._closed:
            return
        self._closed = True       # visible immediately, even if the
        # notify below has to wait for the lock
        async with self._cond:
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def _live_parents(self) -> list[ParentState]:
        return [p for p in self.parents.values() if not p.ejected]

    def _pick(self) -> Dispatch | None:
        now = time.monotonic()
        candidates = []
        deferred = []
        self._seed_hold_expiry = None   # earliest held-piece re-admission
        # locality deferral only exists where locality does: a swarm with
        # no same-slice parents at all (no topology, e.g. plain clusters)
        # must not tax every fresh piece with the grace wait
        any_local = any(not p.is_seed and not p.removed
                        and LINK_TIER.get(p.link, 1) == 0
                        for p in self.parents.values())
        for ps in self._pieces.values():
            if ps.inflight:
                continue
            if not self._dispatchable(ps.info.piece_num):
                continue
            all_states = [self.parents[h] for h in ps.holders
                          if h in self.parents
                          and not self.parents[h].ejected]
            holders = [h for h in all_states if not h.is_busy()]
            if not holders:
                continue
            if (ps.info.piece_num in self.swap_nums
                    and all(h.is_seed for h in holders)):
                # swap-class piece with only the tree to serve it: wait out
                # the swap hold for the owning replica's copy, after the
                # seed's reveal to it; the expiry rides the worker wake
                # scan like the seed grace
                hold = self.swap_hold_s + SUPERSEED_REVEAL_S
                if now - ps.first_seen < hold:
                    expiry = ps.first_seen + hold
                    if (self._seed_hold_expiry is None
                            or expiry < self._seed_hold_expiry):
                        self._seed_hold_expiry = expiry
                    continue

            def _is_local(h) -> bool:
                return not h.is_seed and LINK_TIER.get(h.link, 1) == 0

            local_free = any(_is_local(h) for h in holders)
            local_busy = any(_is_local(h) for h in all_states)
            age = now - ps.first_seen
            wait = (LOCALITY_GRACE_S if not local_busy
                    else BUSY_LOCAL_WAIT_S)
            if (any_local and not local_free and not self.ordered
                    and age < wait):
                deferred.append((ps, holders))   # see LOCALITY_GRACE_S
            elif (not self.ordered
                  and all(h.is_seed for h in holders)
                  and any(not h.is_seed for h in all_states)
                  and age < BUSY_PEER_SEED_WAIT_S):
                # only FREE holder is a seed but a busy peer holds it: hold
                # the piece back (a REAL wait, not a fallback bias — see
                # BUSY_PEER_SEED_WAIT_S). The worker's wake scan covers
                # both the peer's busy expiry and this piece's age-bound
                # re-admission (_seed_hold_expiry), so nothing can stall.
                expiry = ps.first_seen + BUSY_PEER_SEED_WAIT_S
                if (self._seed_hold_expiry is None
                        or expiry < self._seed_hold_expiry):
                    self._seed_hold_expiry = expiry
                continue
            else:
                candidates.append((ps, holders))
        if not candidates:
            candidates = deferred
        if not candidates:
            return self._pick_endgame()
        if self.ordered:
            ps, holders = min(candidates, key=lambda c: c[0].info.piece_num)
        else:
            # rarest-first; rarity ties (common early in a fan-out) break
            # toward pieces a BEST-LINK-TIER holder can serve, then random —
            # otherwise a child repeatedly picks rare pieces whose only
            # holders sit across the DCN while same-slice supply idles
            def best_tier(c) -> int:
                return min(LINK_TIER.get(h.link, 1) + (3 if h.is_seed else 0)
                           for h in c[1])
            rarity = min(len(c[1]) for c in candidates)
            tied = [c for c in candidates if len(c[1]) == rarity]
            top_tier = min(best_tier(c) for c in tied)
            tied = [c for c in tied if best_tier(c) == top_tier]
            if self.swap_nums:
                # an affinity split: partners hold this download's tree
                # pieces off the seed, each from when they first saw it,
                # so the oldest goes first (replicas' tree sets are
                # disjoint already; a random pick let one piece wait past
                # the partner's swap hold)
                ps, holders = min(tied, key=lambda c: c[0].first_seen)
            else:
                ps, holders = random.choice(tied)
        if len(holders) > 1 and random.random() < self.explore_ratio:
            # exploration probes MESH capacity; the seed's latency is already
            # known territory (and every random pick of it costs scarce
            # origin-side egress)
            peers_only = [h for h in holders if not h.is_seed]
            parent = random.choice(peers_only or holders)
        else:
            parent = min(holders, key=ParentState.rank)
        group = [ps]
        # extend with contiguous pieces the same parent holds, both
        # directions (rarest-first may land mid-run or at a run's end)
        by_start = {p.info.range_start: p for p in self._pieces.values()
                    if not p.inflight}
        by_end = {p.info.range_start + p.info.range_size: p
                  for p in self._pieces.values() if not p.inflight}

        parent_class = (3 if parent.is_seed
                        else LINK_TIER.get(parent.link, 1))

        def usable(cand) -> bool:
            if (cand is None or cand is ps or cand.inflight
                    or parent.peer_id not in cand.holders):
                return False
            if not self._dispatchable(cand.info.piece_num):
                return False
            if parent.is_seed and cand.info.piece_num in self.swap_nums:
                # grouping must not drag a swap-class piece onto the seed
                # past its hold: it dispatches alone once the hold runs out
                return False
            # don't drag a piece onto a WORSE link than its own best free
            # holder offers — grouping must not bypass the tier preference
            # (and the pick metric) for its groupmates
            best = min((3 if h.is_seed else LINK_TIER.get(h.link, 1))
                       for h in (self.parents[hid] for hid in cand.holders
                                 if hid in self.parents)
                       if not h.ejected and not h.is_busy())
            return parent_class <= best

        while len(group) < GROUP_LIMIT:
            last = group[-1].info
            nxt = by_start.get(last.range_start + last.range_size)
            if not usable(nxt):
                break
            group.append(nxt)
        while len(group) < GROUP_LIMIT:
            head = group[0].info
            prev = by_end.get(head.range_start)
            if not usable(prev):
                break
            group.insert(0, prev)
        now = time.monotonic()
        for g in group:
            g.fetching.add(parent.peer_id)
            g.dispatched_at = now
        parent.inflight += 1
        parent.attempts += len(group)
        return Dispatch([g.info for g in group], parent)

    def _pick_endgame(self) -> Dispatch | None:
        """Tail latency killer: when only a handful of pieces remain and all
        are already in flight, race a DUPLICATE request from another usable
        holder — the first landing wins, the loser's bytes are discarded
        (landing is idempotent). A slow or stalled parent on the last piece
        otherwise sets the whole wave's wall-clock (BitTorrent's classic
        endgame mode; the reference instead re-requests failed pieces only,
        peertask_conductor.go:1089)."""
        if not self.endgame or not self._pieces:
            return None
        now = time.monotonic()
        for ps in self._pieces.values():
            if not ps.fetching:
                continue   # normal path will take it
            if not self._dispatchable(ps.info.piece_num):
                continue
            # ONE racer per piece, and only against a fetch that has been
            # in flight a while: uncapped immediate racing turns every slow
            # tail piece into a duplicate from every idle worker — bounded
            # waste per piece is one aged duplicate
            if (len(ps.fetching) >= 2
                    or now - ps.dispatched_at < ENDGAME_RACE_AGE_S):
                continue
            alts = [self.parents[h] for h in ps.holders - ps.fetching
                    if h in self.parents and not self.parents[h].ejected
                    and not self.parents[h].is_busy()]
            if ps.info.piece_num in self.swap_nums:
                # racers for a swap-class piece come only from mates: the
                # in-flight fetch IS a live partner serving it, and a
                # duplicate on the SEED would re-fetch over the tree the
                # bytes affinity deduped. A wedged mate still exits via
                # the failure path, after which the normal pick
                # seed-serves past the hold.
                alts = [h for h in alts if not h.is_seed]
            if not alts:
                continue
            parent = min(alts, key=ParentState.rank)
            ps.fetching.add(parent.peer_id)
            ps.dispatched_at = now
            parent.inflight += 1
            parent.attempts += 1
            return Dispatch([ps.info], parent)
        return None

    async def _notified(self) -> None:
        """One atomic acquire+wait: the lock scope and the cond.wait live
        in a SINGLE coroutine, so when wait_for cancels it the unwind
        releases the lock it re-acquired. The previous shape —
        ``wait_for(self._cond.wait(), t)`` under the caller's ``async
        with`` — split them across two tasks; a worker cancelled while
        parked there orphaned the inner Condition.wait, which re-acquired
        the condition lock in its finally and died HOLDING it. Every later
        acquirer (close(), add_parent, the teardown gather) then queued on
        the poisoned lock forever."""
        async with self._cond:
            await self._cond.wait()

    async def get(self, timeout: float | None = None) -> Dispatch | None:
        """Next (piece, parent) to fetch; None when closed or timed out."""
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            async with self._cond:
                if self._closed:
                    return None
                d = self._pick()
                if d is not None:
                    return d
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                # busy/cooldown/race-age windows expire on a clock, not on
                # a notify: wake at the nearest expiry so a piece whose
                # only holders hit 503 (or an eject cooldown, or an endgame
                # race becoming age-eligible) is retried promptly
                now = time.monotonic()
                wake = None
                for p in self.parents.values():
                    if p.removed:
                        continue
                    for until in (p.busy_until, p.eject_until):
                        if until > now:
                            dt = max(until - now, 0.02)
                            wake = dt if wake is None else min(wake, dt)
                if self.endgame:
                    for ps in self._pieces.values():
                        if len(ps.fetching) == 1:
                            until = ps.dispatched_at + ENDGAME_RACE_AGE_S
                            if until > now:
                                dt = max(until - now, 0.02)
                                wake = dt if wake is None else min(wake, dt)
                held = self._seed_hold_expiry
                if held is not None and held > now:
                    dt = max(held - now, 0.02)
                    wake = dt if wake is None else min(wake, dt)
                if wake is not None:
                    remaining = min(remaining or wake, wake)
            # the wait runs OUTSIDE the pick's lock scope (see _notified):
            # a notify landing in the released gap is missed, which costs
            # at most one `remaining` pause — the loop re-picks after every
            # wake, so correctness only needs the timeout
            try:
                # 0.5s cap even for untimed callers: a notify landing in
                # the released gap must cost a bounded re-pick, not a hang
                await asyncio.wait_for(self._notified(),
                                       0.5 if remaining is None else remaining)
            except asyncio.TimeoutError:
                if deadline is not None and time.monotonic() >= deadline:
                    return None

    async def report_busy(self, d: Dispatch,
                          retry_after_ms: int = 0) -> None:
        """Parent answered 503 (upload slots full): not a failure — back off
        that parent and requeue the pieces so another holder (or the same
        one, later) serves them.

        Backoff sizing is the storm control: with a fixed 40 ms window a
        fan-out whose only early holder is the seed retried it at ~25 Hz per
        child and the 503 round-trips outnumbered real piece downloads. The
        server's
        measured-transfer-time hint is used when present; otherwise the
        backoff doubles per consecutive busy. Jitter de-synchronizes the
        children so the slot race doesn't re-storm on expiry."""
        if self._closed:
            return
        async with self._cond:
            d.parent.inflight = max(0, d.parent.inflight - 1)
            d.parent.consecutive_busy += 1
            if retry_after_ms > 0:
                backoff = retry_after_ms / 1000.0
            else:
                backoff = min(
                    BUSY_BACKOFF_S * (2 ** (d.parent.consecutive_busy - 1)),
                    BUSY_BACKOFF_MAX_S)
            backoff = min(backoff * random.uniform(0.8, 1.5),
                          BUSY_BACKOFF_MAX_S)
            d.parent.busy_until = time.monotonic() + backoff
            for info in d.pieces:
                ps = self._pieces.get(info.piece_num)
                if ps is not None:
                    ps.fetching.discard(d.parent.peer_id)
            self._cond.notify_all()

    async def report(self, d: Dispatch, *, ok: bool, cost_ms: int = 0,
                     completed: list[int] | None = None) -> None:
        """Outcome of one dispatch. ``completed`` narrows success to a
        subset of the group's piece nums (mid-group digest mismatch);
        ``cost_ms`` covers the whole transfer."""
        if self._closed:
            return
        async with self._cond:
            d.parent.inflight = max(0, d.parent.inflight - 1)
            done_nums = set(completed) if completed is not None else (
                {p.piece_num for p in d.pieces} if ok else set())
            landed = sum(p.range_size for p in d.pieces
                         if p.piece_num in done_nums)
            if done_nums:
                d.parent.observe(cost_ms, landed, True)
            if completed is not None:
                # per-piece verdicts (digest checks): each corrupted piece is
                # a strike — a parent corrupting half its pieces must not
                # launder failures behind its groupmates' successes
                for _ in range(len(d.pieces) - len(done_nums)):
                    d.parent.observe(0, 0, False)
            elif not ok:
                # one failed TRANSFER is one strike, however many pieces
                # happened to ride it
                d.parent.observe(0, 0, False)
            for info in d.pieces:
                num = info.piece_num
                if num in done_nums:
                    self._done.add(num)
                    self._pieces.pop(num, None)
                else:
                    ps = self._pieces.get(num)
                    if ps is not None:
                        ps.fetching.discard(d.parent.peer_id)
                        # drop the holder only on PERMANENT removal: a
                        # cooldown-ejected parent comes back in seconds, and
                        # the per-stream announcement dedup (rpcserver sent
                        # set) means it will never re-announce this piece —
                        # discarding here would orphan the piece meshside
                        if d.parent.removed:
                            ps.holders.discard(d.parent.peer_id)
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def starving(self) -> bool:
        """True when no pending piece has ANY live holder — i.e. more
        announcements are needed. Busy holders don't count as starvation:
        that's backpressure working, and pinging through it would turn
        every 503 into an announcement flood."""
        for ps in self._pieces.values():
            if not self._dispatchable(ps.info.piece_num):
                continue    # unneeded pieces must not mask starvation
            if ps.inflight:
                return False
            for h in ps.holders:
                p = self.parents.get(h)
                if p is not None and not p.ejected:
                    return False
        return True

    def pending_count(self) -> int:
        if self.needed is None:
            return len(self._pieces)
        return sum(1 for n in self._pieces if n in self.needed)

    def has_live_parent(self) -> bool:
        return any(not p.ejected for p in self.parents.values())
