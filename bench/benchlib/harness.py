"""One run of one cell: ``python3 bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

The cell's traffic mix names its kind and so the runner that drives it
(``train``: ``train.run``).  With ``--trace 0`` the result
line's metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``bench/metrics/<name>.py``.  The numbers
compared for ``correct`` are printed with their limits as the last lines
on standard error and under ``checks``, the result line's last key.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import platform
import subprocess
import sys

from . import result, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metric(name: str, run, metrics_dir=None):
    """The per-layer metric ``name`` of ``run``, by its reader
    ``bench/metrics/<name>.py`` (None: nothing to read)."""
    path = (spec.metric_file(name) if metrics_dir is None
            else os.path.join(metrics_dir, f"{name}.py"))
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(run)


def runner(kind: str):
    if kind == "train":
        from . import train
        return train.run
    raise ValueError(f"traffic kind {kind!r}")


def card_facts() -> dict:
    import torch
    facts = {"kind": torch.cuda.get_device_name(0)}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        facts["power_limit_w"] = float(limit.splitlines()[0])
    except Exception:
        facts["power_limit_w"] = None
    return facts


def host_cpu() -> str:
    """The host's processor, as ``/proc/cpuinfo`` names it."""
    facts = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                facts.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = facts.get("model name") or " ".join(
        f"{k} {facts[k]}" for k in ("vendor_id", "cpu family", "model",
                                    "CPU implementer", "CPU part")
        if k in facts)
    return f"{name or 'unknown'} ({platform.machine()})"


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)

    import torch
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        result.note(f"bench: the cell needs {need} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    facts = card_facts()
    result.note(f"bench: {cell.name} seed {args.seed} seconds "
                f"{args.seconds} trace {args.trace}; card {facts['kind']} "
                f"power limit {facts['power_limit_w']} W; host CPU "
                f"{host_cpu()} ({os.cpu_count()} cores)")
    run = runner(cell.traffic["kind"])(cell, args.seed, args.seconds,
                                       bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        result.note(f"bench: the process loaded {bad}: refused")
        return 3
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": run.setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                continue
            metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": facts["kind"], "count": need,
              "memory_peak_bytes": run.peak_bytes,
              "power_limit_w": facts["power_limit_w"]}
    if args.trace:
        device["busy_s"] = run.counters.get("device.busy_s")
        device["window_s"] = run.counters.get("device.window_s")
    result.note("bench: notes " + json.dumps(run.notes, default=str))
    if args.trace:
        result.note("bench: counters " + json.dumps(run.counters))
        if run.trace is not None:
            result.note("bench: trace " + json.dumps(run.trace.stats))
    for text in result.checks_text(run):
        result.note(text)
    print(result.line(run, metrics, device, bool(args.trace)), flush=True)
    return 0
