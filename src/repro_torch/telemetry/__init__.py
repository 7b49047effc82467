"""Fabric telemetry plane (DESIGN.md §10, docs/OPERATIONS.md §7).

Two halves, both process-global and dependency-free:

* :mod:`repro.telemetry.trace` — wire-propagated distributed tracing:
  a 16-byte trace id + span id + flags carried in the v5 request
  header, head-sampled at the root, recorded into a bounded ring
  buffer served by the ``dbg.trace`` RPC.
* :mod:`repro.telemetry.metrics` — the unified metrics registry
  (counters / gauges / log-bucket histograms) that the fabric's
  components report through, exported by the ``fab.metrics`` RPC and
  rendered live by ``tools/fabtop.py``.
"""
from . import metrics, trace
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      counter, gauge, histogram, snapshot)
from .trace import (FLAG_SAMPLED, NULL_SPAN, Span, TraceContext,
                    ZERO_TRACE_ID, build_tree, configure, current,
                    format_tree, start_span, start_trace, use)

__all__ = [
    "metrics", "trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot",
    "FLAG_SAMPLED", "NULL_SPAN", "Span", "TraceContext", "ZERO_TRACE_ID",
    "build_tree", "configure", "current", "format_tree", "start_span",
    "start_trace", "use",
]
