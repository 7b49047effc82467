"""Deadline-aware admission control shared by every submit path of the
serving gateway: a copy of ``AdmissionController`` from
``src/repro/services/base.py`` (that module imports jax)."""
from __future__ import annotations

import threading
from typing import Optional

from ..core.types import MercuryError, Ret
from ..telemetry import metrics as _metrics

# unified metrics: process-wide admission totals + service-time shape
# (per-controller detail stays in stats(); fab.metrics exports these)
_M_ADMITTED = _metrics.counter("service.admission.admitted")
_M_SHED = _metrics.counter("service.admission.shed")
_M_SERVICE_MS = _metrics.histogram("service.admission.service_ms")
_M_TURNAROUND_MS = _metrics.histogram("service.admission.turnaround_ms")


class AdmissionController:
    """Shed work a server cannot finish within the caller's deadline.

    The caller's remaining deadline budget rides the request header
    (``RequestHeader.budget_ms`` — see ``Handle.remaining_budget``).  The
    server keeps an EWMA of observed per-request service time and
    estimates the wait a newly admitted request would see from the
    current backlog::

        est = ema_service × (backlog ÷ parallelism) + ema_service

    (queue-wait plus the request's own service time).  If ``est``
    exceeds the caller's remaining budget the request is **shed** with
    ``Ret.OVERLOAD`` before any work happens — a sub-millisecond
    fast-fail the client pool retries on another replica immediately —
    instead of burning queue capacity on a request whose answer nobody
    will be waiting for.  Mercury's facility argument, mRPC's placement
    argument: this policy lives in the RPC service layer, not in each
    application.

    Callers with no deadline (``budget is None``) are always admitted;
    so is everything until ``min_samples`` completions have been
    observed (no estimate yet — shedding on a guess is worse than
    queueing).

    The EWMA that feeds the estimate is **pure service time** — the span
    a request actually occupied an execution slot (admit→done), not
    submit→done.  The distinction matters right after a burst: queue
    wait is already priced in via the ``backlog`` term, so folding it
    into the EWMA as well double-counts queueing and over-sheds until
    the EWMA re-converges.  ``turnaround_s`` (submit→done, queue wait
    included) is tracked separately for observability
    (``ema_turnaround_ms`` in :meth:`stats`).
    """

    def __init__(self, ewma_alpha: float = 0.2, min_samples: int = 3,
                 safety: float = 1.0):
        self.ewma_alpha = ewma_alpha
        self.min_samples = min_samples
        self.safety = safety      # >1.0 sheds earlier, <1.0 later
        self.ema_service = 0.0  #: guarded-by _lock (s/request, occupancy)
        self.ema_turnaround = 0.0  #: guarded-by _lock (submit→done)
        self.samples = 0  #: guarded-by _lock
        self.admitted = 0  #: guarded-by _lock
        self.shed = 0  #: guarded-by _lock
        self._lock = threading.Lock()

    def observe(self, service_s: float,
                turnaround_s: Optional[float] = None) -> None:
        """Record one completed request: ``service_s`` is the pure
        service time (slot occupancy, admit→done); ``turnaround_s``
        optionally records submit→done for observability.  Only
        ``service_s`` feeds the shedding estimate."""
        if service_s < 0:
            return
        _M_SERVICE_MS.observe(service_s * 1e3)
        if turnaround_s is not None and turnaround_s >= 0:
            _M_TURNAROUND_MS.observe(turnaround_s * 1e3)
        with self._lock:
            a = self.ewma_alpha
            self.ema_service = (service_s if not self.samples
                                else a * service_s
                                + (1 - a) * self.ema_service)
            if turnaround_s is not None and turnaround_s >= 0:
                self.ema_turnaround = (
                    turnaround_s if not self.samples
                    else a * turnaround_s + (1 - a) * self.ema_turnaround)
            self.samples += 1

    def estimate_wait(self, backlog: int, parallelism: int) -> float:
        """Estimated completion time (queue-wait + service) for a new
        request given ``backlog`` outstanding work items and
        ``parallelism`` concurrent executors; 0.0 until enough samples."""
        with self._lock:
            if self.samples < self.min_samples:
                return 0.0
            waves = backlog / max(parallelism, 1)
            return self.ema_service * (waves + 1.0)

    def admit(self, budget: Optional[float], backlog: int,
              parallelism: int) -> None:
        """Raise ``MercuryError(Ret.OVERLOAD)`` if the request cannot be
        finished within ``budget`` seconds; otherwise count it admitted.
        ``budget=None`` (caller set no deadline) always admits."""
        est = self.estimate_wait(backlog, parallelism)
        with self._lock:
            if (budget is not None and est * self.safety > budget):
                self.shed += 1
                _M_SHED.inc()
                raise MercuryError(
                    Ret.OVERLOAD,
                    f"estimated completion {est * 1e3:.0f}ms exceeds the "
                    f"caller's remaining budget {budget * 1e3:.0f}ms "
                    f"(backlog {backlog}, ema {self.ema_service * 1e3:.0f}"
                    f"ms)")
            self.admitted += 1
            _M_ADMITTED.inc()

    def stats(self) -> dict:
        with self._lock:
            return {"ema_service_ms": self.ema_service * 1e3,
                    "ema_turnaround_ms": self.ema_turnaround * 1e3,
                    "admission_samples": self.samples,
                    "admitted": self.admitted, "shed": self.shed}
