"""Run a scenario of the port's distribution layer as gloo ranks on the
CPU, each rank a process of its own.

``run_ranks(module, scenario, world, args)`` starts ``world`` processes of
``python tests/torch_ranks.py``, which join one gloo world through a
``FileStore`` in a fresh temporary directory (no port is bound, so any
number of runs can go at once), import ``module`` (a scenario file
beside this one, which imports no JAX), call its ``scenario(rank,
world, args)`` and save what it returns.  The parent returns the ranks'
results in rank order.  The whole run has a time limit: past it every
rank is killed and the run fails, with each failed rank's traceback.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
LIMIT_S = 120.0


def run_ranks(module: str, scenario: str, world: int, args=None,
              limit_s: float = LIMIT_S) -> list:
    import torch
    with tempfile.TemporaryDirectory(prefix="torch-ranks-") as tmp:
        torch.save(args, os.path.join(tmp, "args.pt"))
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(HERE)]),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, str(HERE / "torch_ranks.py"), module, scenario,
             str(rank), str(world), tmp],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
        deadline = time.monotonic() + limit_s
        # a rank that fails leaves the others waiting in a collective:
        # stop them all at once
        while (any(p.poll() is None for p in procs)
               and time.monotonic() < deadline
               and not any(p.poll() for p in procs)):
            time.sleep(0.05)
        timed_out = [r for r, p in enumerate(procs) if p.poll() is None
                     and time.monotonic() >= deadline]
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
        errors = []
        for rank, p in enumerate(procs):
            err = os.path.join(tmp, f"error{rank}.txt")
            if os.path.exists(err):
                errors.append(f"rank {rank}:\n{open(err).read()}")
            elif p.returncode not in (0, -9) and rank not in timed_out:
                errors.append(f"rank {rank} rc {p.returncode}:\n"
                              f"{outs[rank][-4000:]}")
        if timed_out or errors:
            raise AssertionError(
                f"{module}.{scenario}: "
                + (f"ranks {timed_out} still running after {limit_s}s, "
                   f"killed; " if timed_out else "")
                + "\n".join(errors or [o[-2000:] for o in outs]))
        return [torch.load(os.path.join(tmp, f"out{rank}.pt"),
                           weights_only=False) for rank in range(world)]


def _rank_main(module: str, scenario: str, rank: int, world: int,
               tmp: str) -> int:
    import importlib

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=rank, world_size=world, timeout=timedelta(seconds=60))
        out = getattr(importlib.import_module(module), scenario)(
            rank, world, args)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
        dist.destroy_process_group()
        return 0
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        return 1


if __name__ == "__main__":
    m, s, r, w, t = sys.argv[1:6]
    sys.exit(_rank_main(m, s, int(r), int(w), t))
