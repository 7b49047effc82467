"""Tiny cells for the benchmark's CPU tests: the real configurations'
files cut to the port's small CPU variants of their architectures
(``preset: reduced``), and mixes small enough to run in a few seconds."""
from __future__ import annotations

import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import spec  # noqa: E402

def tiny_config(name: str) -> dict:
    """A configuration file cut to the port's reduced variant of its
    architecture."""
    from repro_torch import configs
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        c = json.load(f)
    r = configs.reduced(c["port"]["arch"])
    c["port"] = dict(c["port"], preset="reduced")
    c.update(hidden_size=r.d_model, num_attention_heads=r.n_heads,
             num_key_value_heads=r.n_kv_heads, vocab_size=r.vocab,
             num_hidden_layers=r.n_layers, intermediate_size=r.d_ff)
    return c


def tiny_mix(traffic: str) -> dict:
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        mix = json.load(f)
    return dict(mix, batch=2, seq_len=48)


# the reduced model's limits, between its sound runs' readings (grad
# 4.2e-3, change 2.8e-3) and the float8 control's (2.5e-2, 7.1e-3) on
# the tests' seed; the loss gap is not compared, as in the cell's file
LIMITS = {"grad_gap": 1.2e-2, "change_gap": 5e-3}


def tiny_cell(workload: str, limits=None) -> spec.Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` cut to CPU size."""
    entries = {w["name"]: w for w in spec.load_spec()["workloads"]}
    e = dict(entries[workload], limits=dict(limits or LIMITS))
    return spec.Cell(workload, e, tiny_config(e["config"]), {},
                     tiny_mix(e["traffic"]), [], [])


def run_tiny(cell, seconds=1.5, trace=False, plant=None, seed=3141592653):
    from benchlib import harness
    torch_threads()
    return harness.runner(cell.traffic["kind"])(
        cell, seed, seconds, trace, time.monotonic(), device="cpu",
        plant=plant)


def torch_threads():
    import torch
    torch.set_num_threads(2)
