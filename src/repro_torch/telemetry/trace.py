"""Wire-propagated distributed tracing (DESIGN.md §10).

A *trace* follows one logical operation across every hop of the fabric:
client attempts (retries, hedges), registry write-proxy hops, gateway
queue/decode, nested service calls.  The context that rides the wire is
deliberately tiny — 16-byte trace id, 8-byte span id, 1 flag byte — and
is carried in the v5 :class:`~repro.core.types.RequestHeader`; the
self-tier local-dispatch fast path hands the context object across
directly (no serialization, matching the data path it instruments).

Head sampling: the root decides once (``configure(sample=...)``) and the
decision propagates via the SAMPLED flag.  Unsampled traces still carry
their ids downstream (so a future tail-sampler could act on them) but
record *nothing* — span objects on that path are no-ops, which is what
keeps the unsampled overhead near zero (asserted ≤5% of routed-pool RTT
by the ``trace_overhead`` benchmark).

Finished spans land in a bounded per-process ring buffer served by the
``dbg.trace`` RPC that every :class:`~repro.core.executor.Engine`
exposes; a client reassembles the cross-process span tree by unioning
``dbg.trace`` responses and joining on parent span ids (clocks are never
compared across processes).

Inside one process, :func:`region` names a stretch of the host's work
(a training step, its forward, a data-feed wait) for ``torch.profiler``:
a host-only event on the profiler's clock, beside the device's events.
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

FLAG_SAMPLED = 0x01
ZERO_TRACE_ID = b"\x00" * 16


class TraceContext:
    """The immutable triplet that rides the wire."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: bytes, span_id: int, flags: int = 0):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    @property
    def trace_hex(self) -> str:
        return self.trace_id.hex()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceContext({self.trace_id.hex()}, "
                f"{self.span_id:016x}, flags={self.flags})")


# -- ambient (thread-local) context -----------------------------------------
_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The context active on this thread (None when untraced)."""
    return getattr(_tls, "ctx", None)


def activate(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as the ambient context; returns the previous one
    (pass it back to :func:`restore`).  Installing ``None`` explicitly
    clears stale context — handler pools rely on this."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def restore(prev: Optional[TraceContext]) -> None:
    _tls.ctx = prev


class use:
    """``with trace.use(ctx): ...`` — scoped ambient context."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = activate(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        restore(self._prev)


# -- tracer state ------------------------------------------------------------
class _Tracer:
    def __init__(self) -> None:
        self.enabled = True
        self.sample = float(os.environ.get("REPRO_TRACE_SAMPLE", "0.01"))
        self.ring: deque = deque(
            maxlen=int(os.environ.get("REPRO_TRACE_RING", "4096")))
        # module-owned RNG: cheap (no urandom syscall per id) and isolated
        # from user seeding of the global random module
        self.rng = random.Random(os.urandom(16))


_T = _Tracer()


def configure(sample: Optional[float] = None, ring: Optional[int] = None,
              enabled: Optional[bool] = None) -> None:
    """Adjust the process-global tracer.

    ``sample`` — head-sampling probability in [0, 1] applied where a
    trace is *rooted* (downstream hops obey the propagated flag).
    ``ring`` — span ring-buffer capacity.  ``enabled=False`` turns the
    machinery off entirely (no context is even created)."""
    if sample is not None:
        _T.sample = max(0.0, min(1.0, float(sample)))
    if ring is not None:
        _T.ring = deque(_T.ring, maxlen=max(1, int(ring)))
    if enabled is not None:
        _T.enabled = bool(enabled)


def sample_rate() -> float:
    return _T.sample


def is_enabled() -> bool:
    return _T.enabled


def clear() -> None:
    """Drop all buffered spans (tests / benchmarks)."""
    _T.ring.clear()


def _new_span_id() -> int:
    return _T.rng.getrandbits(64) or 1


# -- spans -------------------------------------------------------------------
class Span:
    """A timed unit of work.  ``recorded=False`` spans are pass-through:
    they carry a context for propagation but never touch the clock or the
    ring (the near-zero unsampled path)."""

    __slots__ = ("ctx", "name", "parent_id", "recorded", "tags",
                 "_t0", "_wall", "_done")

    def __init__(self, ctx: TraceContext, name: str, parent_id: int,
                 recorded: bool, tags: Optional[Dict[str, Any]] = None):
        self.ctx = ctx
        self.name = name
        self.parent_id = parent_id
        self.recorded = recorded
        self.tags = tags if tags is not None else ({} if recorded else None)
        self._done = False
        if recorded:
            self._t0 = time.monotonic()
            self._wall = time.time()  # fablint: ok[wallclock] human-facing span start stamp for trace export, never used in arithmetic
        else:
            self._t0 = 0.0
            self._wall = 0.0

    def annotate(self, **tags: Any) -> None:
        if self.recorded:
            self.tags.update(tags)

    def finish(self, status: str = "OK", **tags: Any) -> None:
        if not self.recorded or self._done:
            return
        self._done = True
        if tags:
            self.tags.update(tags)
        _T.ring.append({
            "trace": self.ctx.trace_id.hex(),
            "span": f"{self.ctx.span_id:016x}",
            "parent": f"{self.parent_id:016x}" if self.parent_id else None,
            "name": self.name,
            "pid": os.getpid(),
            "wall": self._wall,
            "dur_ms": round((time.monotonic() - self._t0) * 1e3, 3),
            "status": status,
            "tags": self.tags,
        })


class _NullSpan:
    """Singleton no-op span: no context, records nothing."""

    __slots__ = ()
    ctx: Optional[TraceContext] = None
    recorded = False

    def annotate(self, **tags: Any) -> None:
        pass

    def finish(self, status: str = "OK", **tags: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


def start_trace(name: str, **tags: Any):
    """Root a new trace (head-sampling decision happens here).  Returns a
    recorded :class:`Span` when sampled, an unrecorded pass-through span
    (context still propagates) when not, and :data:`NULL_SPAN` when
    tracing is disabled."""
    t = _T
    if not t.enabled:
        return NULL_SPAN
    s = t.sample
    sampled = s >= 1.0 or (s > 0.0 and t.rng.random() < s)
    ctx = TraceContext(t.rng.getrandbits(128).to_bytes(16, "little"),
                       _new_span_id(), FLAG_SAMPLED if sampled else 0)
    return Span(ctx, name, 0, sampled, dict(tags) if (tags and sampled) else None)


def start_span(name: str, parent: Optional[TraceContext], **tags: Any):
    """Open a child span under ``parent``.  ``parent=None`` (or tracing
    disabled) → :data:`NULL_SPAN`; unsampled parent → pass-through span
    reusing the parent context (ids keep propagating, nothing recorded)."""
    if parent is None or not _T.enabled:
        return NULL_SPAN
    if not (parent.flags & FLAG_SAMPLED):
        return Span(parent, name, parent.span_id, False)
    ctx = TraceContext(parent.trace_id, _new_span_id(), parent.flags)
    return Span(ctx, name, parent.span_id, True,
                dict(tags) if tags else None)


# -- profiler regions ---------------------------------------------------------
_Region = None


def region(name: str, **args: Any):
    """``with trace.region("train.forward"): ...`` — a named host region
    for ``torch.profiler``.

    While a profiler session collects, the block is one op-scope event
    ``name`` on the calling thread and the profiler's clock, nested in
    whatever region or op encloses it; ``args`` (host values such as a
    step index) ride on it where the session records inputs
    (``record_shapes``).  Op scope, unlike ``record_function``'s user
    scope, leaves no mirror among the device's events, so a region never
    counts as device time.  Without a profiler it reads no clock, records
    nothing and never synchronises the card: it costs one object.  torch
    is imported at the first call, not with this module."""
    global _Region
    if _Region is None:
        from torch._C._profiler import _RecordFunctionFast
        _Region = _RecordFunctionFast
    if args:
        return _Region(name, keyword_values=args)
    return _Region(name)


# -- ring export / reassembly ------------------------------------------------
def export(trace_id: Optional[str] = None,
           limit: Optional[int] = None) -> Dict[str, Any]:
    """Snapshot of the span ring — the ``dbg.trace`` response body.
    ``trace_id`` (hex) filters to one trace; ``limit`` keeps the newest N."""
    spans = list(_T.ring)
    if trace_id:
        spans = [s for s in spans if s["trace"] == trace_id]
    if limit:
        spans = spans[-int(limit):]
    return {"pid": os.getpid(), "spans": spans}


def spans_for(trace_id: str) -> List[Dict[str, Any]]:
    return [s for s in _T.ring if s["trace"] == trace_id]


def build_tree(spans: List[Dict[str, Any]]
               ) -> Tuple[List[Dict[str, Any]], Dict[str, List[Dict[str, Any]]]]:
    """Join spans on parent ids: returns ``(roots, children_by_span_id)``.
    A span whose parent is absent from the set counts as a root — one
    *connected* tree therefore means exactly one root."""
    seen = {}
    for s in spans:
        seen.setdefault(s["span"], s)          # union of rings may duplicate
    uniq = list(seen.values())
    children: Dict[str, List[Dict[str, Any]]] = {}
    roots = []
    for s in sorted(uniq, key=lambda s: s.get("wall", 0.0)):
        p = s.get("parent")
        if p and p in seen:
            children.setdefault(p, []).append(s)
        else:
            roots.append(s)
    return roots, children


def format_tree(spans: List[Dict[str, Any]]) -> str:
    """Pretty-print a span tree (one trace) for consoles and examples."""
    roots, children = build_tree(spans)
    lines: List[str] = []

    def walk(s: Dict[str, Any], depth: int) -> None:
        tags = s.get("tags") or {}
        tag_str = " ".join(f"{k}={v}" for k, v in sorted(tags.items()))
        lines.append(f"{'  ' * depth}{s['name']}  "
                     f"[{s['status']} {s['dur_ms']:.2f}ms pid={s['pid']}]"
                     + (f"  {tag_str}" if tag_str else ""))
        for c in children.get(s["span"], []):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return "\n".join(lines)
