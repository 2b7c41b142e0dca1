"""One retry/backoff policy for the control-plane ladders.

Counterpart of ``dragonfly2_tpu/common/retry.py``: jittered exponential
backoff, capped by attempts, by a wall-clock budget and by a per-run
deadline, honouring a ``retry_after_ms`` hint on the raised error or an
HTTP ``Retry-After`` header. The clock, sleep and rng are injectable so a
test drives the whole ladder with a fake clock.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

from .errors import Code

log = logging.getLogger("df.retry")


def retry_after_s(exc: BaseException) -> float:
    """The error's own backoff hint in seconds: ``retry_after_ms`` (the
    upload slot's 503 and faultgate errors) or an HTTP ``Retry-After``
    header (seconds form) on a ``headers`` mapping."""
    ms = getattr(exc, "retry_after_ms", 0)
    if ms:
        return float(ms) / 1000.0
    headers = getattr(exc, "headers", None)
    if headers:
        try:
            value = headers.get("Retry-After", "")
        except AttributeError:
            return 0.0
        if isinstance(value, str) and value.strip().isdigit():
            return float(value.strip())
    return 0.0


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with an attempt cap and a time budget."""

    max_attempts: int = 3        # total tries, including the first
    base_s: float = 0.1          # first backoff
    max_s: float = 2.0           # per-sleep cap
    multiplier: float = 2.0
    jitter: float = 0.5          # sleep *= uniform(1-jitter, 1+jitter)
    budget_s: float = 0.0        # total wall budget across attempts; 0 = none

    def backoff_s(self, failures: int,
                  rng: Callable[[], float] = random.random) -> float:
        """Sleep before attempt ``failures + 1`` (failures >= 1)."""
        raw = min(self.max_s,
                  self.base_s * self.multiplier ** max(failures - 1, 0))
        if self.jitter <= 0:
            return raw
        return raw * (1.0 - self.jitter + 2.0 * self.jitter * rng())


_TRANSIENT_CODES = frozenset({int(Code.UNAVAILABLE),
                              int(Code.DEADLINE_EXCEEDED)})


def transient(exc: BaseException) -> bool:
    """Default retryable test: DFError UNAVAILABLE/DEADLINE_EXCEEDED, plain
    transport failures (OSError/TimeoutError), or a retry-after hint."""
    code = getattr(exc, "code", None)
    try:
        if code is not None and int(code) in _TRANSIENT_CODES:
            return True
    except (TypeError, ValueError):
        pass
    if isinstance(exc, (OSError, asyncio.TimeoutError)):
        return True
    return retry_after_s(exc) > 0


class Retrier:
    """Runs an async callable under a RetryPolicy. ``clock``, ``sleep``
    and ``rng`` default to the monotonic clock, ``asyncio.sleep`` and
    ``random.random``."""

    def __init__(self, policy: RetryPolicy, *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], Awaitable] = asyncio.sleep,
                 rng: Callable[[], float] = random.random):
        self.policy = policy
        self.clock = clock
        self.sleep = sleep
        self.rng = rng

    async def run(self, fn: Callable[[], Awaitable[Any]], *,
                  retryable: Callable[[BaseException], bool] = transient,
                  deadline_s: float | None = None,
                  on_retry: Callable[[int, BaseException, float], None]
                  | None = None) -> Any:
        """Call ``fn`` until it succeeds, attempts run out, or the next
        sleep would overshoot the budget or ``deadline_s``. Raises the
        last exception. ``on_retry(failures, exc, sleep_s)`` fires before
        each sleep."""
        p = self.policy
        start = self.clock()
        budget = p.budget_s or 0.0
        if deadline_s is not None:
            budget = min(budget, deadline_s) if budget else deadline_s
        failures = 0
        while True:
            try:
                return await fn()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - classified below
                failures += 1
                if failures >= p.max_attempts or not retryable(exc):
                    raise
                pause = max(p.backoff_s(failures, self.rng),
                            retry_after_s(exc))
                if budget and (self.clock() - start) + pause > budget:
                    # sleeping would eat the deadline: fail now, so the
                    # next rung of the ladder gets the time
                    raise
                if on_retry is not None:
                    on_retry(failures, exc, pause)
                log.debug("retry %d/%d in %.3fs after %s", failures,
                          p.max_attempts, pause, exc)
                await self.sleep(pause)
