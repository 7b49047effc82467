"""Concurrency analysis for the port's RPC fabric.

  * :mod:`repro_torch.analysis.lockdep` — the opt-in runtime sanitizer
    that wraps the port's locks, records the cross-thread
    acquisition-order graph, flags order cycles (potential deadlocks)
    and locks held across an RPC boundary, and exports per-lock
    hold-time histograms through the metrics registry.

The static pass (fablint, ``python -m repro.analysis.lint src/``) needs
no copy: it scans the whole source tree, the port included.
"""
# Submodules are imported lazily (``from repro_torch.analysis import
# lockdep``), as in the reference package.
__all__ = ["lockdep"]
