"""The program's own regions in a traced run, for the per-layer readers.

The port marks its training step and its data feed with named host
regions (``repro_torch.telemetry.trace.region``): ``train.step`` holds a
``train.forward`` and a ``train.backward`` a microbatch and one
``train.optimizer``; ``datafeed.get`` holds ``datafeed.wait``.  They are
host events of ``probes.Trace.host`` on the device's clock, with no
mirror among the device's events.  A name's regions count as the union
of their intervals, so a nested or repeated region counts once.

"Idle" is the ``bench.window`` range less the union of the device's
intervals: the busy set ``device.idle_share.train`` reads.  Each reader
gets None where the trace is not complete or holds no ``train.step``
region (a program without regions).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from . import probes
from .readers import traced

Intervals = List[Tuple[int, int]]


def union(ivs: Iterable[Tuple[int, int]]) -> Intervals:
    out: list = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """The intersection of two unions (each sorted and disjoint)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(a: Intervals, b: Intervals) -> Intervals:
    """``a`` less ``b`` (each a union)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def length(ivs: Intervals) -> int:
    return sum(e - s for s, e in ivs)


def spans(tr, *names: str) -> Intervals:
    """The union of the host regions named ``names``."""
    return union((s, e) for s, e, n in tr.host if n in names)


def regions_of(run) -> Optional[tuple]:
    """(trace, window) of a complete trace that holds the program's
    ``train.step`` regions and a ``bench.window``, else None."""
    tr = getattr(run, "trace", None)
    if not traced(run) or tr is None:
        return None
    win = tr.ranges.get("bench.window")
    if not win or not spans(tr, "train.step"):
        return None
    return tr, [win[0]]


def idle_parts(run) -> Optional[Dict[str, float]]:
    """The window's idle time split by the regions, percent of the
    window: ``model`` (inside a forward or backward), ``optimizer``,
    ``in_step`` (inside a step but none of those) and ``between_steps``
    (outside every step).  They sum to the idle share where the regions
    nest as the program opens them."""
    got = regions_of(run)
    if got is None:
        return None
    tr, win = got
    idle = minus(win, tr.merged(*win[0]))
    step = spans(tr, "train.step")
    model = intersect(idle, spans(tr, "train.forward", "train.backward"))
    opt = intersect(idle, spans(tr, "train.optimizer"))
    parts = {
        "model": model,
        "optimizer": opt,
        "in_step": minus(intersect(idle, step), union(model + opt)),
        "between_steps": minus(idle, step),
    }
    w = win[0][1] - win[0][0]
    return {k: 100.0 * length(v) / w for k, v in parts.items()}


def launched(tr, name: str) -> float:
    """Device seconds of the operations launched inside the regions
    ``name``, as ``Trace.launched_in`` reckons a range's."""
    return probes.Trace(device=tr.device,
                        ranges={name: spans(tr, name)}).launched_in(name)


def launched_share(run, part: str, whole: str) -> Optional[float]:
    """Device time launched inside ``part`` over that inside ``whole``,
    percent."""
    got = regions_of(run)
    if got is None:
        return None
    tr, _ = got
    w = launched(tr, whole)
    return 100.0 * launched(tr, part) / w if w else None


def mean_ms(run, name: str) -> Optional[float]:
    """Mean milliseconds of the window's regions ``name``."""
    got = regions_of(run)
    if got is None:
        return None
    tr, win = got
    ivs = intersect(spans(tr, name), win)
    return length(ivs) / len(ivs) / 1e6 if ivs else None
