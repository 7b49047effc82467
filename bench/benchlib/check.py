"""What decides ``correct``: the timed path's outputs against the plain
reference (``bench/reference``), each number held to its limit in
``bench/limits/<cell>.json``.

A training cell: the first three steps, taken in set-up through the window's
own step and feed (``train.py``), against the reference's three steps
from the same weights and rows: ``loss_gap``, the largest relative gap of
a step's loss; ``grad_gap``, the first gradient's norm as the optimizer
got it, by the worst leaf; ``change_gap``, the norm of each leaf's change
over the three steps, by the worst leaf.  A cell holds the numbers its
limits file names (a number that no control or fault separates from
sound runs is not compared, and goes to the notes).  A leaf's gap is
|program's norm - reference's norm| over the larger of the reference's
norm of that leaf and of the median leaf.  Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of the
change (they move by rounding alone).
"""
from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Dict

from .result import Run

LIMITS_DIR = Path(__file__).resolve().parents[1] / "limits"


def limits(cell) -> Dict[str, float]:
    """The cell's limits: ``bench/limits/<cell>.json`` (a test's cell may
    carry its own under ``limits``)."""
    if "limits" in cell.entry:
        return dict(cell.entry["limits"])
    with open(LIMITS_DIR / f"{cell.name}.json") as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def reference_module(cfg: dict):
    """The plain reference of the file's family,
    ``bench/reference/<family>.py``."""
    import importlib
    return importlib.import_module(f"reference.{cfg['reference']}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys=None) -> float:
    keys = list(keys if keys is not None else ref)
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers compared, from each side's readings: ``losses``
    (3 floats), ``grad`` and ``change`` (a norm a leaf)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad"]
    med = statistics.median(g.values())
    moved = [k for k in g if g[k] >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grad"], g),
            "change_gap": leaf_gap(prog["change"], ref["change"], moved)}


def trained(out: Run, cell, prog: dict, ref: dict) -> None:
    """The numbers the cell's limits file holds, each against its limit;
    the others go to the notes."""
    lim = limits(cell)
    out.readings = {"program": prog, "reference": ref}
    nums = training_numbers(prog, ref)
    g = ref["grad"]
    med = statistics.median(g.values())
    out.notes.update(
        {f"{k} (not compared)": v for k, v in nums.items() if k not in lim},
        change_left_out=sorted(k for k in g if g[k] < 1e-3 * med))
    for name in ("loss_gap", "grad_gap", "change_gap"):
        if name in lim:
            out.checks.append((name, nums[name], lim[name]))
