"""The readings a cell's limits are set from, on the card.

    python3 bench/limits.py --workload <cell> --seeds <n,n,...> [--seconds S]

For each seed it makes one run of the training cell (its window
``--seconds`` long, at the cell's own sizes) and prints the numbers
compared, which are the program's readings, then, with ``--control 1``,
the control's on the same seed: the reference computed in float8 (e4m3,
each linear layer's input rows and weight columns scaled on their own)
in the program's place over the same three steps; and the fault "half of
the batch left out, the mean taken over the rest": the reference on half
of each step's rows.  One ``LIMITS {json}`` line a seed.  The
benchmark's own runs never run this.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def main(argv=None) -> int:
    import torch
    from benchlib import check, harness, spec, train
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("limits: no CUDA card", file=sys.stderr)
        return 2
    run = harness.runner(cell.traffic["kind"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = run(cell, seed, args.seconds, False, time.monotonic())
        row = {"cell": cell.name, "seed": seed,
               "program": {n: v for n, v, _ in out.checks},
               "e2e": out.e2e, "notes": out.notes}
        gc.collect()
        torch.cuda.empty_cache()
        if args.control:
            ref = out.readings["reference"]
            for name, kw in (("control", {"quant": "fp8"}),
                             ("half_batch", {"half_batch": True})):
                got = train.reference_steps(cell.config, cell.traffic, seed,
                                            "cuda", **kw)
                row[name] = check.training_numbers(got, ref)
                gc.collect()
                torch.cuda.empty_cache()
        print("LIMITS " + json.dumps(row, default=str), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
