"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA cards the cell
asks for (``BENCHMARK.json``).  The last line of standard output is the
run's result (JSON); the numbers compared for ``correct`` and their
limits are the last lines of standard error.
"""
import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from benchlib import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
