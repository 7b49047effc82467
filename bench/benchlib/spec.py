"""The benchmark's description: ``BENCHMARK.json`` at the root of the
checkout, and the data files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each is found by its name: the configuration's file is the one its
entry in ``configs`` gives, the mix is ``bench/traffic/<traffic>.json``,
and each per-layer metric is ``bench/metrics/<name>.py``.  Nothing here
knows a cell, a configuration or a metric by name.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC_FILE = ROOT / "BENCHMARK.json"
METRICS_DIR = BENCH / "metrics"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass(frozen=True)
class Cell:
    """One workload: its entry, its configuration's entry and file, its
    traffic mix, the end-to-end metrics it reports and the per-layer
    metrics whose readers find something in it."""
    name: str
    entry: dict
    config: dict            # the configuration's file, as JSON
    config_entry: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(path: Path = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell: str, spec: dict = None, root: Path = ROOT) -> Cell:
    """The cell ``cell`` of ``spec`` (default ``BENCHMARK.json``) with
    every file it names read."""
    spec = spec if spec is not None else load_spec(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if cell not in entries:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[cell]
    configs = {c["name"]: c for c in spec["configs"]}
    centry = configs[entry["config"]]
    with open(root / centry["file"]) as f:
        config = json.load(f)
    with open(root / "bench" / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _reports(m, cell)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, cell) and m["moves"] in moved]
    return Cell(cell, entry, config, centry, traffic, e2e, per_layer)


def check_names(spec: dict) -> List[str]:
    """What in ``spec`` breaks the naming rules (empty when nothing)."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in spec[group]]
        if len(set(names)) != len(names):
            bad.append(f"{group}: a name twice")
        for x in spec[group]:
            if not NAME.match(x["name"]):
                bad.append(f"{group}: name {x['name']!r}")
            if "unit" in x and not UNIT.match(x["unit"]):
                bad.append(f"{group}: unit {x['unit']!r}")
    for w in spec["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                bad.append(f"workload {w['name']}: {key} {w[key]!r}")
    for c in spec["configs"]:
        for key in c["reduced"]:
            if not NAME.match(key):
                bad.append(f"config {c['name']}: reduced key {key!r}")
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    if len(set(metric_names)) != len(metric_names):
        bad.append("a metric name twice")
    return bad


def metric_file(name: str) -> Path:
    return METRICS_DIR / f"{name}.py"
