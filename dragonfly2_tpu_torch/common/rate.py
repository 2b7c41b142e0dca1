"""Token-bucket rate limiting (async).

Counterpart of ``TokenBucket`` in ``dragonfly2_tpu/common/rate.py``: the
upload server's per-daemon serve rate limit (adjustable live,
``set_rate``), the daemon-wide back-source limit
(``PieceManager.total_limiter``) and a super-seed's per-child reveal
budget (``try_acquire``).
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

    def refund(self, n: float) -> None:
        """Hand back ``n`` reserved tokens whose bytes were never moved."""
        if self.rate <= 0:
            return
        self._refill()
        self._tokens = min(self.burst, self._tokens + n)

    async def acquire(self, n: float) -> None:
        # an oversized request (a 16 MiB piece against a small burst) pays
        # the full wait instead of deadlocking
        delay = self.reserve(n)
        if delay > 0:
            try:
                await asyncio.sleep(delay)
            except asyncio.CancelledError:
                self.refund(n)
                raise
