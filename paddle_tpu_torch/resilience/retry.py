"""Bounded retry with exponential backoff, jitter and a hard deadline.

The port's copy of ``paddle_tpu/resilience/retry.py``: one policy
object and one driver, used by the fleet's network client
(``NetReplica``'s dial and RPCs) and anything else that talks to a flaky
medium.

Design points:
- backoff = ``base * multiplier**(attempt-1)`` clamped to ``max_delay_s``,
  multiplied by a ±``jitter`` fraction so a fleet of hosts retrying the
  same dead NFS server doesn't thundering-herd it on a synchronized clock.
- the ``deadline_s`` budget is wall-clock from the FIRST attempt; when the
  next sleep would land past it, the ORIGINAL exception is re-raised —
  callers see the real failure, not a retry-framework wrapper.
- every retry bumps the ``resilience_retries_total`` counter (labelled by
  ``op``) so a run that is quietly limping on a sick filesystem is visible
  in the observability exposition long before it dies; every GIVE-UP —
  attempt budget spent or deadline crossed — bumps
  ``resilience_retry_exhausted_total{op}``, so a limping-then-dead
  dependency is distinguishable from a merely limping one.
- fully injectable (``sleep``, ``clock``, ``rng``) — the fault-injection
  suite drives it deterministically with zero real sleeping.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type

from paddle_tpu_torch import observability

RETRYABLE_DEFAULT: Tuple[Type[BaseException], ...] = (
    IOError, OSError, TimeoutError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard to try: attempts, backoff shape, deadline, what to catch."""

    max_attempts: int = 5
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25           # ± fraction of the computed delay
    deadline_s: float = 60.0       # wall-clock budget across ALL attempts
    retry_on: Tuple[Type[BaseException], ...] = RETRYABLE_DEFAULT

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.max_delay_s,
                self.base_delay_s * (self.multiplier ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


def retry_call(fn: Callable, *args,
               policy: Optional[RetryPolicy] = None,
               op: str = "call",
               rng: Optional[random.Random] = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               **kwargs):
    """Run ``fn(*args, **kwargs)``, retrying ``policy.retry_on`` failures.

    Gives up — re-raising the ORIGINAL exception — when either
    ``max_attempts`` is spent or the next backoff would cross
    ``deadline_s``. Non-retryable exceptions propagate immediately.
    """
    policy = policy or RetryPolicy()
    rng = rng or random.Random()
    start = clock()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            # exhaustion is its own signal: retries_total alone cannot
            # distinguish a limping dependency from a limping-then-DEAD
            # one — the give-up counter is what alerts page on
            if attempt >= policy.max_attempts:
                observability.default().counter(
                    "resilience_retry_exhausted_total",
                    "retry give-ups (attempt budget or deadline spent)"
                ).inc(op=op)
                raise
            delay = policy.delay(attempt, rng)
            if clock() + delay - start > policy.deadline_s:
                observability.default().counter(
                    "resilience_retry_exhausted_total",
                    "retry give-ups (attempt budget or deadline spent)"
                ).inc(op=op)
                raise  # the original error, not a deadline wrapper
            observability.default().counter(
                "resilience_retries_total",
                "transient failures absorbed by resilience.retry").inc(op=op)
            sleep(delay)


def retrying(policy: Optional[RetryPolicy] = None, op: str = "call",
             **driver_kwargs):
    """Decorator form of :func:`retry_call`."""
    def wrap(fn):
        def inner(*args, **kwargs):
            return retry_call(fn, *args, policy=policy, op=op,
                              **driver_kwargs, **kwargs)
        inner.__name__ = getattr(fn, "__name__", "retrying")
        inner.__doc__ = fn.__doc__
        return inner
    return wrap
