"""What the benchmark attaches to the program in a traced run, from its
own files: shims around the port's entry points and the kernels its
layers call, and the reader of ``torch.profiler``'s trace.

``Probes`` wraps, while installed:

* the attention calls of the layers
  (``repro_torch.models.attention.attention``): each call's shapes,
  while ``recording`` is on, so that their frozen counts
  (``counts.kernels``) give the least time of the calls the trace
  covers;
* ``repro_torch.train.optim.adamw_update`` in a ``bench.optimizer``
  ``record_function`` range.

``read_trace`` reduces a profile to the device's busy intervals, each
kernel's time by class, the benchmark's ranges and the host's activity
in the device's idle gaps.
"""
from __future__ import annotations

import bisect
import gc
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

# the host's kernel launches (runtime and driver API) in a trace
LAUNCHES = ("cudaLaunch", "cuLaunch")

KERNEL_CLASSES = {
    "attention": re.compile(r"\battn_"),
}


class Probes:
    def __init__(self):
        self.recording = False
        self.calls: Dict[str, list] = defaultdict(list)
        self._undo = []

    def _patch(self, owner, name, new):
        old = getattr(owner, name)
        setattr(owner, name, new)
        self._undo.append((owner, name, old))
        return old

    def install(self):
        from repro_torch.models import attention as attn_mod
        from repro_torch.train import optim
        probes = self

        attention = attn_mod.attention

        def attention_probe(q, k, v, **kw):
            if probes.recording:
                grad = torch.is_grad_enabled() and q.requires_grad
                probes.calls["attention"].append(
                    (tuple(q.shape), tuple(k.shape), q.element_size(),
                     kw.get("q_offset", 0), grad))
            return attention(q, k, v, **kw)
        self._patch(attn_mod, "attention", attention_probe)

        update = optim.adamw_update

        def update_probe(*a, **kw):
            with torch.profiler.record_function("bench.optimizer"):
                return update(*a, **kw)
        self._patch(optim, "adamw_update", update_probe)
        return self

    def uninstall(self):
        while self._undo:
            owner, name, old = self._undo.pop()
            setattr(owner, name, old)


class GCWatch:
    """The interpreter's garbage-collection pauses while installed (they
    land in the window's tails and rates)."""

    def __init__(self):
        self.pauses: List[Tuple[int, float]] = []
        self._t0 = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                (time.perf_counter() - self._t0) * 1e3))

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        full = [ms for g, ms in self.pauses if g == 2]
        return {"gc_pauses": len(self.pauses),
                "gc_ms": sum(ms for _, ms in self.pauses),
                "gc_full": len(full), "gc_full_max_ms": max(full, default=0)}


# ---------------------------------------------------------------------------
# the least time of the recorded calls (frozen counts)
# ---------------------------------------------------------------------------
def least_times(calls: Dict[str, list]) -> Dict[str, float]:
    """Seconds at the card's peaks of the recorded calls, by kernel class
    (``KERNEL_CLASSES``): attention forward, and backward where the call
    took a gradient."""
    from counts import kernels as kc
    out = {"attention": 0.0}
    for qs, ks, elt, off, grad in calls.get("attention", []):
        B, S, Hq, D = qs
        T, Hkv = ks[1], ks[2]
        offs = [int(off)] * B
        dt = "bfloat16" if elt == 2 else "float32"
        out["attention"] += kc.least(
            kc.attention_fwd(S, T, Hq, Hkv, D, elt, offs), dt)
        if grad:
            out["attention"] += kc.least(
                kc.attention_bwd(B, S, Hq, Hkv, D, elt), dt)
    return out


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------
@dataclass
class Trace:
    """A profile reduced: device intervals (ns), kernel seconds by class
    and by name, the ``bench.*`` ranges, and the host's events."""
    device: List[Tuple[int, int, str, Optional[int]]] = field(
        default_factory=list)          # (start, end, name, launch time)
    ranges: Dict[str, List[Tuple[int, int]]] = field(
        default_factory=lambda: defaultdict(list))
    host: List[Tuple[int, int, str]] = field(default_factory=list)
    stats: Dict[str, int] = field(default_factory=dict)

    @property
    def complete(self) -> bool:
        """Whether the device's record holds the kernels the host launched
        (the tracer drops records when its buffers fill)."""
        n = self.stats.get("launches", 0)
        return n > 0 and self.stats.get("kernels", 0) >= 0.95 * n

    def merged(self, lo=None, hi=None) -> List[Tuple[int, int]]:
        """The union of the device intervals, clipped to [lo, hi)."""
        out = []
        for s, e, _, _ in sorted(self.device):
            if lo is not None:
                s, e = max(s, lo), min(e, hi)
                if e <= s:
                    continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_ns(self, lo=None, hi=None) -> int:
        return sum(e - s for s, e in self.merged(lo, hi))

    def class_seconds(self, cls: str) -> float:
        pat = KERNEL_CLASSES[cls]
        return sum(e - s for s, e, n, _ in self.device
                   if pat.search(n)) / 1e9

    def launched_in(self, name: str) -> float:
        """Device seconds of the operations launched inside the ranges
        ``name`` (by their launch's host time)."""
        spans = sorted(self.ranges.get(name, []))
        starts = [s for s, _ in spans]
        total = 0
        for s, e, _, t in self.device:
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                total += e - s
        return total / 1e9

    def top_ops(self, n=10) -> list:
        by = defaultdict(int)
        for s, e, name, _ in self.device:
            by[short(name)] += e - s
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, lo, hi, n=10) -> list:
        """The device's idle time inside [lo, hi), summed by what the host
        was doing at each gap's middle (the innermost host event
        covering it), the largest first."""
        busy = self.merged(lo, hi)
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by = defaultdict(int)
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid)
            best, best_len = "host: no event", None
            for h in host[max(0, i - 400):i]:
                if h[0] <= mid <= h[1]:
                    length = h[1] - h[0]
                    if best_len is None or length < best_len:
                        best, best_len = h[2], length
            by[best] += e - s
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def window_counters(tr: "Trace", calls) -> Optional[tuple]:
    """(lo, hi) of a trace's ``bench.window`` range, and the counters and
    breakdown every traced cell reads from it: the device's busy time,
    the kernels' device time and least time by class (``KERNEL_CLASSES``,
    ``least_times`` of the recorded ``calls``), the top device operations
    and idle gaps.  None where the trace holds no window."""
    win = tr.ranges.get("bench.window")
    if not win:
        return None
    lo, hi = win[0]
    least = least_times(calls)
    counters = {"trace.complete": float(tr.complete),
                "device.busy_s": tr.busy_ns(lo, hi) / 1e9,
                "device.window_s": (hi - lo) / 1e9}
    for cls in KERNEL_CLASSES:
        counters[f"kernel.{cls}_s"] = tr.class_seconds(cls)
        counters[f"kernel.{cls}_least_s"] = least[cls]
    breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps(lo, hi)}
    return (lo, hi), counters, breakdown


def profile():
    """The profiler of a traced run's window: host activity on every
    thread (the data feed's RPC threads too) and the device's."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=acts, experimental_config=cfg)


def warm_profiler(device) -> None:
    """A short profile in set-up, so that the window's profiler starts
    without the tracer's first start-up."""
    with profile():
        x = torch.ones(16, device=device)
        (x * 2).sum().item()


def short(name: str, limit: int = 160) -> str:
    """A kernel's name without its ``void`` and cut to ``limit`` letters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _ev(e, attr, default=None):
    f = getattr(e, attr, None)
    if f is None:
        return default
    try:
        return f()
    except Exception:
        return default


def read_trace(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    tr = Trace()
    events = prof.profiler.kineto_results.events()
    launches = {}
    device_rows = []
    for e in events:
        name = _ev(e, "name", "")
        start = _ev(e, "start_ns")
        if start is None:
            start = int(_ev(e, "start_us", 0) * 1000)
        dur = _ev(e, "duration_ns")
        if dur is None:
            dur = int(_ev(e, "duration_us", 0) * 1000)
        if _ev(e, "device_type") == DeviceType.CUDA:
            if name.startswith("bench."):
                continue            # a host range's mirror on the device
            device_rows.append((start, start + dur, name,
                                _ev(e, "correlation_id"),
                                _ev(e, "linked_correlation_id")))
            continue
        if name.startswith("bench."):
            tr.ranges[name].append((start, start + dur))
        if name.startswith(LAUNCHES):
            cid = _ev(e, "correlation_id")
            if cid:
                launches[cid] = start
        tr.host.append((start, start + dur, name))
    for s, e, name, cid, linked in device_rows:
        t = launches.get(linked) or launches.get(cid)
        tr.device.append((s, e, name, t))
    kernels = sum(1 for d in tr.device if not d[2].startswith(("Memcpy",
                                                              "Memset")))
    tr.stats = {"device_events": len(tr.device), "kernels": kernels,
                "launches": len(launches),
                "launch_matched": sum(1 for d in tr.device if d[3]),
                "host_events": len(tr.host)}
    return tr
