"""Token-bucket rate limiting (async) and the QoS class split.

Counterpart of ``dragonfly2_tpu/common/rate.py``: the upload server's
per-daemon serve rate limit (adjustable live, ``set_rate``), the traffic
shaper's per-task buckets (``daemon/traffic_shaper.py``), the daemon-wide
back-source limit when no shaper is attached
(``PieceManager.total_limiter``) and a super-seed's per-child reveal
budget (``try_acquire``). ``class_shares`` is the one split of a total
rate across the QoS classes: the shaper's retune and dfbench's ``--pr11``
model both call it.
"""

from __future__ import annotations

import asyncio
import time


class TokenBucket:
    """Classic token bucket. ``rate`` tokens/second, ``burst`` capacity.
    ``rate <= 0`` means unlimited. Writers are on one event loop."""

    def __init__(self, rate: float, burst: float | None = None):
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(self.rate, 1.0)
        self._tokens = self.burst
        self._last = time.monotonic()

    def set_rate(self, rate: float, burst: float | None = None) -> None:
        self._refill()
        self.rate = float(rate)
        if burst is not None:
            self.burst = float(burst)
        elif self.rate > 0:
            self.burst = max(self.rate, 1.0)
        self._tokens = min(self._tokens, self.burst)

    def _refill(self) -> None:
        now = time.monotonic()
        if self.rate > 0:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_acquire(self, n: float) -> bool:
        """Take ``n`` tokens if they are there now; never waits."""
        if self.rate <= 0:
            return True
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def reserve(self, n: float) -> float:
        """Take ``n`` tokens (going negative if needed); return seconds to
        wait."""
        if self.rate <= 0:
            return 0.0
        self._refill()
        self._tokens -= n
        if self._tokens >= 0:
            return 0.0
        return -self._tokens / self.rate

    def _unreserve(self, n: float) -> None:
        self._refill()
        self._tokens = min(self.burst, self._tokens + n)

    def refund(self, n: float) -> None:
        """Hand back ``n`` reserved tokens whose bytes were never moved
        (a cancelled transfer, a 404 after an optimistic acquire); clamped
        at ``burst``, so a double refund mints nothing."""
        self._unreserve(n)

    async def acquire(self, n: float) -> None:
        # an oversized request (a 16 MiB piece against a small burst) pays
        # the full wait instead of deadlocking
        delay = self.reserve(n)
        if delay > 0:
            try:
                await asyncio.sleep(delay)
            except asyncio.CancelledError:
                # the bytes were never moved: hand the tokens back
                self._unreserve(n)
                raise


def class_shares(total: float, weights: dict[str, float],
                 demand: dict[str, float]) -> dict[str, float]:
    """Split ``total`` across service classes by weight, counting only
    classes with live demand: an idle class's capacity is borrowed by the
    active ones, so a lone ``bulk`` task gets the whole pipe and loses
    most of it the moment ``critical`` traffic appears. Returns bytes/s
    per class; every class of ``weights`` gets a row, idle ones 0.0."""
    active = {c: w for c, w in weights.items() if demand.get(c, 0.0) > 0}
    out = {c: 0.0 for c in weights}
    if total <= 0 or not active:
        return out
    wsum = sum(active.values())
    for c, w in active.items():
        out[c] = total * w / wsum
    return out
