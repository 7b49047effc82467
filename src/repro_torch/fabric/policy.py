"""Retry / deadline / hedging policy — the pure half of the service
fabric's call path.

The budget machinery is deliberately separated from transports and
threads: :func:`call_with_budget` drives attempts against an injected
``attempt_fn`` using injected ``clock``/``sleep``/``rand``, so the pool
uses it with the real clock while the property tests replay random
latency schedules on a simulated one (tests/test_fabric_policy.py).

Invariants the driver guarantees (and the property test checks):

  * at most ``policy.attempts`` attempts are ever issued;
  * every attempt's transport timeout is clamped to the time remaining
    until the caller's deadline, so the call returns (success or
    :class:`DeadlineExceeded`) no later than ``deadline`` — strictly
    tighter than the "deadline + one RPC timeout" bound a non-clamping
    design would give;
  * backoff sleeps never extend past the deadline.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

from ..core.types import MercuryError, Ret
from ..telemetry import metrics as _metrics

# unified metrics: budget-loop outcomes across every pool/caller (the
# loop itself stays pure — counters are clock-free)
_M_RETRIES = _metrics.counter("fabric.retry.retries")
_M_FAST_FAILOVERS = _metrics.counter("fabric.retry.fast_failovers")
_M_DEADLINE_EXCEEDED = _metrics.counter("fabric.retry.deadline_exceeded")
_M_BUDGET_EXHAUSTED = _metrics.counter("fabric.retry.budget_exhausted")


class FabricError(MercuryError):
    """Base for fabric call-path failures; carries the last per-attempt
    error (if any) as ``cause``."""

    def __init__(self, ret: Ret, detail: str = "",
                 cause: Optional[BaseException] = None):
        super().__init__(ret, detail)
        self.cause = cause


class DeadlineExceeded(FabricError):
    def __init__(self, detail: str = "", cause=None):
        super().__init__(Ret.TIMEOUT, detail, cause)


class BudgetExhausted(FabricError):
    """All budgeted attempts failed (each with a retryable error)."""

    def __init__(self, detail: str = "", cause=None):
        super().__init__(Ret.AGAIN, detail, cause)


class NonRetryable(Exception):
    """Wrap an attempt error to stop the retry loop immediately (the
    application handler faulted / rejected the call: retrying would
    re-execute non-idempotent work for the same result)."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


@dataclass(frozen=True)
class RetryPolicy:
    """Per-call budget: attempts, per-attempt transport timeout, jittered
    exponential backoff, and optional request hedging."""

    attempts: int = 3            # total tries, including the first
    rpc_timeout: float = 5.0     # per-attempt transport timeout cap (s)
    backoff_base: float = 0.05   # first backoff (s)
    backoff_factor: float = 2.0
    backoff_max: float = 1.0
    jitter: float = 0.5          # fraction of the backoff randomized away
    hedge_after: Optional[float] = None   # issue a 2nd replica's attempt
                                          # if no reply within this (s)
    # errors that skip the backoff sleep entirely: an admission-control
    # shed (OVERLOAD) is a sub-millisecond fast-fail whose remedy is a
    # *different replica*, not a later retry against the same one —
    # backing off would burn exactly the deadline budget the shed was
    # protecting.  (The attempt budget still applies.)
    fast_rets: frozenset = frozenset({Ret.OVERLOAD})

    def with_(self, **kw) -> "RetryPolicy":
        return replace(self, **kw)

    def attempt_timeout(self, now: float, deadline: float) -> float:
        """Transport timeout for an attempt starting at ``now``: the cap,
        clamped to the time remaining before the caller's deadline."""
        return max(min(self.rpc_timeout, deadline - now), 0.0)

    def backoff(self, attempt: int, rand: float) -> float:
        """Backoff before attempt ``attempt`` (1-based retry index), with
        ``rand`` in [0, 1) supplying the jitter."""
        raw = min(self.backoff_base * (self.backoff_factor ** (attempt - 1)),
                  self.backoff_max)
        return raw * (1.0 - self.jitter * rand)


def call_with_budget(policy: RetryPolicy, deadline: float,
                     attempt_fn: Callable[[int, float], Any],
                     clock: Callable[[], float] = time.monotonic,
                     sleep: Callable[[float], None] = time.sleep,
                     rand: Callable[[], float] = random.random) -> Any:
    """Run ``attempt_fn(attempt_index, timeout)`` under the policy's
    budget.  ``attempt_fn`` returns the call's value or raises; a raised
    :class:`NonRetryable` aborts immediately with its cause, anything
    else consumes one attempt from the budget.
    """
    last: Optional[BaseException] = None
    for attempt in range(policy.attempts):
        now = clock()
        timeout = policy.attempt_timeout(now, deadline)
        if timeout <= 0:
            _M_DEADLINE_EXCEEDED.inc()
            raise DeadlineExceeded(
                f"deadline expired before attempt {attempt + 1}", last)
        try:
            return attempt_fn(attempt, timeout)
        except NonRetryable as e:
            raise e.cause
        except Exception as e:        # KeyboardInterrupt etc. propagate
            last = e
        if attempt + 1 >= policy.attempts:
            break
        _M_RETRIES.inc()
        if getattr(last, "ret", None) in policy.fast_rets:
            _M_FAST_FAILOVERS.inc()
            continue                  # fast failover: re-rank immediately
        pause = min(policy.backoff(attempt + 1, rand()),
                    max(deadline - clock(), 0.0))
        if pause > 0:
            sleep(pause)
    _M_BUDGET_EXHAUSTED.inc()
    raise BudgetExhausted(
        f"all {policy.attempts} attempts failed: {last}", last)
