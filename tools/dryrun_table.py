#!/usr/bin/env python3
"""The dry run's train cells beside their hillclimb variants, from the
records ``python -m repro_torch.launch.dryrun`` wrote.

    python3 tools/dryrun_table.py [--dir experiments/dryrun_torch]
                                  [--shape train_4k] [--mesh single]
                                  [--variants param_gather-bfloat16,...]

For each arch, one row a variant (the base cell first): ``t_collective``,
``t_memory`` and ``t_compute`` in seconds (reckoned for an H100 SXM5
from ``launch/mesh.py``'s data-sheet ``HW``, not measured) and the
rank's traced peak in GB; a record missing or not ``ok`` shows as such.
Prints a markdown table.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

DEFAULT_VARIANTS = ("param_gather-bfloat16", "flat_dp", "gather_once",
                    "microbatches-4", "moe_dispatch-cumsum")


def row(path: Path) -> str:
    if not path.exists():
        return "no record"
    rec = json.loads(path.read_text())
    if not rec.get("ok"):
        return f"not ok: {rec.get('error', '')[:60]}"
    times = " / ".join(f"{rec[k]:.4g}" if k in rec else "-" for k in
                       ("t_collective", "t_memory", "t_compute"))
    return f"{times} | {rec['memory']['peak_bytes'] / 1e9:.2f}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variants", default=",".join(DEFAULT_VARIANTS))
    args = ap.parse_args(argv)
    folder = Path(args.dir)
    suffix = f"_{args.shape}_{args.mesh}"
    archs = sorted(p.name[:-len(suffix) - 5] for p in
                   folder.glob(f"*{suffix}.json"))
    print("| arch | variant | t_collective / t_memory / t_compute s | "
          "peak GB |")
    print("| --- | --- | --- | --- |")
    for arch in archs:
        for variant in [""] + args.variants.split(","):
            name = f"{arch}{suffix}" + (f"__{variant}" if variant else "")
            path = folder / f"{name}.json"
            if variant and not path.exists():
                continue
            print(f"| {arch} | {variant or 'base'} | {row(path)} |")


if __name__ == "__main__":
    main()
