"""Small helpers the per-layer metrics' readers share.  A reader returns
None where its run holds nothing to read; it never returns 0 for a share
of a peak or a roofline it could not measure."""
from __future__ import annotations

import statistics
from typing import Optional

from counts.peaks import PEAK_BF16_FLOPS


def span_mean(run, name) -> Optional[float]:
    xs = run.spans.get(name)
    return statistics.fmean(xs) if xs else None


def traced(run) -> bool:
    """Whether the run's trace holds every kernel the host launched."""
    return run.counters.get("trace.complete") == 1.0


def share(run, part, whole) -> Optional[float]:
    """``part`` over ``whole``, counters, in percent."""
    a, b = run.counters.get(part), run.counters.get(whole)
    if a is None or not b:
        return None
    return 100.0 * a / b


def idle(run, busy, whole) -> Optional[float]:
    """The share of ``whole`` in which the device ran nothing, percent."""
    if not traced(run):
        return None
    s = share(run, busy, whole)
    return None if s is None else 100.0 - s


def roofline(run, kernel) -> Optional[float]:
    """The frozen count's least time of the traced calls over the
    kernels' device time, percent."""
    if not traced(run) or not run.counters.get(f"kernel.{kernel}_least_s"):
        return None
    return share(run, f"kernel.{kernel}_least_s", f"kernel.{kernel}_s")


def mfu(run) -> Optional[float]:
    """Useful operations over the steps' wall time at the bf16 peak."""
    f, s = run.counters.get("model.flops"), run.counters.get("model.step_s")
    if not f or not s:
        return None
    return 100.0 * f / (s * PEAK_BF16_FLOPS)
