"""The benchmark of the PyTorch port: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` lists the cells and
metrics; ``port_bench/README.md`` says how a cell, a configuration or a
metric is added as files. The last line of standard output is the result;
the last lines of standard error are the compared numbers beside their
limits. Exits 3 without a result where the cell's CUDA devices are not
there, and 4 where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(ROOT, sys.argv[1:], T_START))
