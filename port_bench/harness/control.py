"""Readings that set a cell's limits: the program's compared numbers and
its control's, seed after seed in one process (the kernel built once).

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 3]

Each seed prints one JSON line: ``{"seed", "readings": {"program": {...},
"control_...": {...}, "fault_...": {...}}}``. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import json
import sys
import time

from harness.manifest import Bench
from harness.runner import Run, pin_caches


def readings(root, name: str, seed: int, seconds: float, device="cuda",
             sizes=None) -> dict:
    import torch

    bench = Bench(root)
    cell = bench.cell(name)
    run = Run(bench=bench, cell=cell, seed=seed, seconds=seconds,
              trace=False, device=device, t_start=time.perf_counter(),
              sizes=sizes or {})
    driver = bench.driver(cell["driver"]).make(run)
    driver.setup()
    if driver.CONTROL_WINDOW:
        driver.window(seconds)
    driver.release()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return driver.controls()


def main(root, argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    pin_caches(root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        out = readings(root, args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": out}), flush=True)
    return 0
