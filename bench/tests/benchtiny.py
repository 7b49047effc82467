"""Tiny cells for the benchmark's CPU tests: configuration files cut to
the port's small CPU variants of their architectures (``preset:
reduced``) by their family's cut (``families.<family>.tiny``) and held
to their family's limits at that size, and mixes small enough to run in
a few seconds."""
from __future__ import annotations

import itertools
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FIXTURES = os.path.join(BENCH, "tests", "fixtures")
TINY_LIMITS_DIR = os.path.join(BENCH, "tests", "tiny_limits")
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import families  # noqa: E402
from benchlib import spec  # noqa: E402


def config_file(name: str) -> dict:
    """The configuration file ``name``: ``bench/configs/<name>.json``, or
    the tests' own ``bench/tests/fixtures/<name>.json``, its
    ``rules_tried`` set to the rules the port runs (``port_rules``)."""
    for d in (os.path.join(BENCH, "configs"), FIXTURES):
        path = os.path.join(d, f"{name}.json")
        if os.path.exists(path):
            with open(path) as f:
                c = json.load(f)
            if "rules_tried" in c:
                taken = port_rules(c)
                assert len(taken) == 1, (name, taken)
                c = dict(c, **taken[0])
            return c
    raise FileNotFoundError(name)


_PORT_RULES = {}


def port_rules(cfg: dict) -> list:
    """Each combination of the values under ``rules_tried`` that the
    port's check takes for the file: one where the file tries the rules
    the port runs, before and after a change to them."""
    from benchlib import portcfg
    key = json.dumps(cfg, sort_keys=True)
    if key not in _PORT_RULES:
        tried = cfg["rules_tried"]
        taken = []
        for values in itertools.product(*tried.values()):
            rules = dict(zip(tried, values))
            try:
                portcfg.port_config(dict(cfg, **rules))
            except ValueError:
                continue
            taken.append(rules)
        _PORT_RULES[key] = taken
    return [dict(r) for r in _PORT_RULES[key]]


def tiny_config(name: str) -> dict:
    """A configuration file cut to the port's reduced variant of its
    architecture."""
    c = config_file(name)
    return families.of(c).tiny(c)


def tiny_mix(traffic: str) -> dict:
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        mix = json.load(f)
    return dict(mix, batch=2, seq_len=48)


def tiny_limits(workload: str, cfg: dict) -> dict:
    """The limits of the cell ``workload`` cut to CPU size: its own
    ``bench/tests/tiny_limits/<workload>.json``, or its family's
    ``TINY_LIMITS``."""
    path = os.path.join(TINY_LIMITS_DIR, f"{workload}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {k: float(v) for k, v in json.load(f).items()}
    return dict(families.of(cfg).TINY_LIMITS)


# the tests' own cell of the fixture ``moe-port-rules``, which
# ``with_fixture_cells`` adds to a copy of ``BENCHMARK.json``
FIXTURE_CELLS = [{"name": "moe-port-rules.pretrain_4k",
                  "config": "moe-port-rules", "traffic": "pretrain_4k",
                  "chips": 1, "why": "the tests' DeepSeekMoE file"}]


def with_fixture_cells() -> dict:
    """``BENCHMARK.json`` with ``FIXTURE_CELLS`` added, as a later change
    adds a cell."""
    s = spec.load_spec()
    return dict(s, workloads=s["workloads"] + FIXTURE_CELLS)


def tiny_cell(workload: str, bench: dict = None) -> spec.Cell:
    """The cell ``workload`` of ``bench`` (default ``BENCHMARK.json``)
    cut to CPU size, held to ``tiny_limits``."""
    bench = bench if bench is not None else spec.load_spec()
    entries = {w["name"]: w for w in bench["workloads"]}
    cfg = tiny_config(entries[workload]["config"])
    e = dict(entries[workload], limits=tiny_limits(workload, cfg))
    return spec.Cell(workload, e, cfg, {}, tiny_mix(e["traffic"]), [], [])


def run_tiny(cell, seconds=1.5, trace=False, plant=None, seed=3141592653):
    from benchlib import harness
    torch_threads()
    return harness.runner(cell.traffic["kind"])(
        cell, seed, seconds, trace, time.monotonic(), device="cpu",
        plant=plant)


def torch_threads():
    import torch
    torch.set_num_threads(2)
