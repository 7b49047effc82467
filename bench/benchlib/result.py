"""A run's record, and its result line.

A run fills ``e2e`` (the end-to-end candidates the harness takes), and
for the per-layer readers ``spans`` (lists of ms from the benchmark's
own spans), ``counters`` (sums) and ``trace`` (``probes.Trace``);
``notes`` go to standard error as they are.
``checks`` holds each number compared with its limit.
"""
from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Run:
    cell: str
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    e2e: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)
    trace: Optional[object] = None
    breakdown: Optional[dict] = None
    checks: List[tuple] = field(default_factory=list)   # (name, value, limit)
    readings: Dict[str, dict] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v is not None and math.isfinite(v) and v <= lim
            for _, v, lim in self.checks)


def checks_text(run: Run) -> List[str]:
    return [f"check {name} {value!r} limit {limit!r} "
            f"{'ok' if value is not None and value <= limit else 'FAILED'}"
            for name, value, limit in run.checks]


def line(run: Run, metrics: dict, device: dict, trace: bool) -> str:
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.breakdown is not None:
        out["breakdown"] = run.breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in run.checks}
    return json.dumps(out)


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
