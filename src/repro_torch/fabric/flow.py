"""Credit-based per-target flow control.

Each replica a :class:`~repro_torch.fabric.pool.ServicePool` talks to gets a
credit gate: a bounded number of credits, one consumed per in-flight RPC
and returned on completion (success, failure, or cancel).  A slow
replica therefore saturates its credits and *sheds load into
backpressure* — callers either wait (bounded by their deadline), route to
another replica, or fail with a backpressure error — instead of queueing
unboundedly inside the transport.  The gate's occupancy doubles as a
live load signal for the balancers.

Two gates:

  * :class:`CreditGate` — fixed limit (the PR-2 design).
  * :class:`AdaptiveCreditGate` — the limit itself is a control loop
    (Swift/BBR-style AIMD on EWMA latency): completions faster than the
    latency target grow the limit additively (~ +gain per limit's worth
    of completions, i.e. one credit per "RTT"), completions slower than
    the target shrink it multiplicatively (rate-limited to once per
    EWMA-latency window, so a single burst cannot collapse the window),
    and hard failures shrink it the same way.  The target defaults to
    ``headroom ×`` a decaying-minimum base latency, so each replica
    learns its own uncongested floor: fast replicas absorb more
    in-flight work, slow ones backpressure sooner, and a replica whose
    latency degrades mid-run gives credits back.

Invariants (pinned by tests/test_fabric_flow.py):

  * the limit never leaves ``[min_credits, max_credits]``;
  * acquires and releases balance: ``inflight == acquired - released``
    and every release had a matching acquire, whatever interleaving of
    completions, cancels and limit changes happens;
  * shrinking the limit below the current in-flight count never strands
    a credit — in-flight calls complete and release normally, new
    acquires just wait until occupancy drops below the limit again.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..telemetry import metrics as _metrics

# unified metrics: process-wide totals across every gate instance (the
# per-gate view stays in stats(); fab.metrics exports these).  Gates are
# per-replica and ephemeral, so per-instance label cardinality would be
# unbounded — totals are the stable export.
_M_ACQUIRED = _metrics.counter("fabric.gate.acquired")
_M_BACKPRESSURED = _metrics.counter("fabric.gate.backpressured")
_M_REJECTED = _metrics.counter("fabric.gate.rejected")
_M_GROWN = _metrics.counter("fabric.gate.grown")
_M_SHRUNK = _metrics.counter("fabric.gate.shrunk")


class CreditGate:
    """A counting gate with wait-with-timeout and observable occupancy
    (``threading.Semaphore`` hides its count, which the balancer needs).

    Tracks *occupancy* (in-flight count) against a limit rather than a
    free-credit count, so subclasses may move the limit while calls are
    in flight without any bookkeeping debt."""

    def __init__(self, credits: int):
        if credits < 1:
            raise ValueError(f"credits must be >= 1, got {credits}")
        self._limit = float(credits)  #: guarded-by _cv
        self._inflight = 0  #: guarded-by _cv
        self._waiting = 0  #: guarded-by _cv
        self._cv = threading.Condition()
        # cumulative counters for pool stats
        self.acquired_total = 0  #: guarded-by _cv
        self.released_total = 0  #: guarded-by _cv
        self.backpressured_total = 0  #: guarded-by _cv
        self.rejected_total = 0  #: guarded-by _cv

    @property
    def credits(self) -> int:
        """The current integer credit limit."""
        with self._cv:
            return int(self._limit)

    # -- acquire / release ---------------------------------------------------
    def try_acquire(self) -> bool:
        with self._cv:
            if self._inflight >= int(self._limit):
                return False
            self._inflight += 1
            self.acquired_total += 1
            _M_ACQUIRED.inc()
            return True

    def acquire(self, timeout: float) -> bool:
        """Take a credit, waiting up to ``timeout`` seconds.  Returns False
        on timeout (the caller should reroute or surface backpressure)."""
        with self._cv:
            if self._inflight >= int(self._limit):
                self.backpressured_total += 1
                _M_BACKPRESSURED.inc()
                deadline = time.monotonic() + timeout
                self._waiting += 1
                try:
                    while self._inflight >= int(self._limit):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or not self._cv.wait(remaining):
                            if self._inflight < int(self._limit):
                                break
                            self.rejected_total += 1
                            _M_REJECTED.inc()
                            return False
                finally:
                    self._waiting -= 1
            self._inflight += 1
            self.acquired_total += 1
            _M_ACQUIRED.inc()
            return True

    def release(self) -> None:
        with self._cv:
            if self._inflight <= 0:
                raise RuntimeError("credit released more times than acquired")
            self._inflight -= 1
            self.released_total += 1
            self._cv.notify()

    # -- observability -------------------------------------------------------
    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    @property
    def available(self) -> int:
        with self._cv:
            return max(int(self._limit) - self._inflight, 0)

    @property
    def waiting(self) -> int:
        with self._cv:
            return self._waiting

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"credits": int(self._limit),
                    "inflight": self._inflight,
                    "waiting": self._waiting,
                    "acquired": self.acquired_total,
                    "released": self.released_total,
                    "backpressured": self.backpressured_total,
                    "rejected": self.rejected_total}

    def __repr__(self):
        with self._cv:
            return (f"<{type(self).__name__} {self._inflight}"
                    f"/{int(self._limit)} in flight>")


class AdaptiveCreditGate(CreditGate):
    """A :class:`CreditGate` whose limit is driven by observed latency.

    AIMD on EWMA latency vs. a target (see the module docstring for the
    control law).  ``target_latency=None`` derives the target from a
    decaying minimum of observed latency (``headroom ×`` the learned
    uncongested floor); pass an explicit target to pin it (e.g. an SLO).
    """

    def __init__(self, credits: int, min_credits: int = 1,
                 max_credits: int = 64,
                 target_latency: Optional[float] = None,
                 headroom: float = 2.0, gain: float = 1.0,
                 decrease: float = 0.7, ewma_alpha: float = 0.3):
        if not 1 <= min_credits <= max_credits:
            raise ValueError(f"need 1 <= min_credits <= max_credits, got "
                             f"[{min_credits}, {max_credits}]")
        if not 0.0 < decrease < 1.0:
            raise ValueError(f"decrease must be in (0, 1), got {decrease}")
        super().__init__(min(max(credits, min_credits), max_credits))
        self.min_credits = min_credits
        self.max_credits = max_credits
        self.target_latency = target_latency
        self.headroom = headroom
        self.gain = gain
        self.decrease = decrease
        self.ewma_alpha = ewma_alpha
        self.ema = 0.0  #: guarded-by _cv       (EWMA completion latency, s)
        self.base: Optional[float] = None  #: guarded-by _cv (decaying-min floor)
        self.grown_total = 0  #: guarded-by _cv
        self.shrunk_total = 0  #: guarded-by _cv
        self._last_shrink = 0.0  #: guarded-by _cv

    # -- control law ---------------------------------------------------------
    def _target_locked(self) -> Optional[float]:
        if self.target_latency is not None:
            return self.target_latency
        return None if self.base is None else self.base * self.headroom

    def record_latency(self, dt: float,
                       now: Optional[float] = None) -> None:
        """Feed one successful-completion latency into the control loop."""
        if dt < 0:
            return
        now = time.monotonic() if now is None else now
        with self._cv:
            a = self.ewma_alpha
            self.ema = dt if not self.ema else a * dt + (1 - a) * self.ema
            # decaying min: snaps down on a new floor, drifts up slowly so
            # a permanently-degraded replica re-learns its baseline
            self.base = dt if self.base is None else \
                min(dt, self.base + 0.02 * max(dt - self.base, 0.0))
            target = self._target_locked()
            if target is None:
                return
            if self.ema <= target:
                before = int(self._limit)
                self._limit = min(self._limit + self.gain /
                                  max(self._limit, 1.0),
                                  float(self.max_credits))
                if int(self._limit) > before:
                    self.grown_total += 1
                    _M_GROWN.inc()
                    self._cv.notify_all()    # waiters may fit now
            else:
                self._shrink_locked(now)

    def record_failure(self, now: Optional[float] = None) -> None:
        """A hard failure (timeout, disconnect, overload shed) is the
        strongest congestion signal there is: multiplicative decrease."""
        now = time.monotonic() if now is None else now
        with self._cv:
            self._shrink_locked(now)

    def _shrink_locked(self, now: float) -> None:
        # at most one multiplicative decrease per EWMA-latency window —
        # a burst of late completions is ONE congestion event, not many
        if now - self._last_shrink < max(self.ema, 1e-3):
            return
        before = int(self._limit)
        self._limit = max(self._limit * self.decrease,
                          float(self.min_credits))
        self._last_shrink = now
        if int(self._limit) < before:
            self.shrunk_total += 1
            _M_SHRUNK.inc()

    def stats(self) -> Dict[str, int]:
        out = super().stats()
        with self._cv:
            target = self._target_locked()
            out.update(limit=round(self._limit, 2),
                       min_credits=self.min_credits,
                       max_credits=self.max_credits,
                       ema_ms=round(self.ema * 1e3, 3),
                       target_ms=(None if target is None
                                  else round(target * 1e3, 3)),
                       grown=self.grown_total, shrunk=self.shrunk_total)
        return out
