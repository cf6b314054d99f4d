"""One run of one cell: set-up, the measured window, the traced window,
the check, and the result line.

The cell's driver (``drivers/<driver>.py``, named by its traffic file)
builds the system under test from the seed, warms every shape the window
uses, and drives the window; its ``check()`` hands the reference what the
timed path produced and returns each compared number with its limit. The
metrics' readers (``metrics/<name>.py``) take their numbers from the run:
the window's counts and clocks, the spans and the trace.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from harness import guard
from harness.manifest import Bench

EXIT_NO_CHIP = 3
EXIT_FORBIDDEN = 4
CACHE = ".port_bench_cache"


def pin_caches(root: Path) -> None:
    """Keep every build and kernel cache a run may fill inside the
    checkout, at fixed paths (the program's own kernel library is built
    under ``minigrid_tpu_torch/_build/``, inside the checkout too), and
    keep libraries that could load JAX from doing so."""
    cache = root / CACHE
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclasses.dataclass
class Run:
    """What a run knows: its cell, its arguments, and what the driver and
    the trace recorded for the metrics' readers."""

    bench: Bench
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    sizes: dict = dataclasses.field(default_factory=dict)
    setup_s: float | None = None
    window: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    spans: object = None
    trace_summary: object = None
    card: str | None = None

    def sync(self):
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    def param(self, group: str, key: str):
        """A number of the cell: the traffic's or the configuration's
        ``group``, with a test's smaller size where it gave one."""
        over = self.sizes.get(group, {})
        if key in over:
            return over[key]
        if group == "traffic":
            return self.cell["traffic"][key]
        return self.cell["config"][group][key]


def card_line() -> str | None:
    """The card's name, power limit, SM clock (now and its maximum) and
    temperature, as ``nvidia-smi`` reads them: written beside every result,
    since a card below 700 W or at a lower clock runs slower."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                              "clocks.sm,clocks.max.sm,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", sizes=None, t_start=None) -> dict:
    """Run cell ``name`` once and return its result (the object the CLI
    prints). ``device="cpu"`` and ``sizes`` serve the benchmark's own tests:
    they skip the look for a chip and shrink the cell."""
    import torch

    bench = Bench(root)
    cell = bench.cell(name)
    run = Run(bench=bench, cell=cell, seed=seed, seconds=seconds,
              trace=trace, device=device,
              t_start=time.perf_counter() if t_start is None else t_start,
              sizes=sizes or {})
    driver = bench.driver(cell["driver"]).make(run)
    driver.setup()
    run.sync()
    run.setup_s = time.perf_counter() - run.t_start
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    if trace:
        from harness.trace import Spans

        run.spans = Spans(run.sync)
    t_window = time.perf_counter()
    driver.window(seconds)
    if device.startswith("cuda"):
        run.card = card_line()
    if trace:
        run.trace_summary = driver.profile()
    t_after = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else None)
    found = guard.forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    e2e, layer = bench.metrics(name)
    metrics = {}
    for m in (layer if trace else e2e):
        value = bench.reader(m["name"]).read(run)
        if value is None:
            # a metric listed for this cell that reads nothing: the program
            # moved what the harness reads (README.md lists its names)
            raise MissingMetric(m["name"], name)
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check()
    print(f"seconds: set-up {run.setup_s:.3f}, window and trace "
          f"{t_after - t_window:.3f}, check "
          f"{time.perf_counter() - t_check:.3f}", file=sys.stderr)
    failed = int(run.window.get("failed", 0))
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if device.startswith("cuda") else "cpu"),
           "count": int(cell["entry"]["chips"]),
           "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": int(run.window["attempted"]),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace_summary is not None:
        dev["busy_s"] = run.trace_summary.busy_s
        dev["window_s"] = run.trace_summary.window_s
        out["breakdown"] = run.trace_summary.breakdown()
    if run.card:
        out["card"] = run.card
    out["checks"] = checks
    return out


class MissingMetric(RuntimeError):
    def __init__(self, metric, cell):
        super().__init__(f"metric {metric} has no value in cell {cell}, "
                         "which BENCHMARK.json lists it for")


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__("modules of JAX or the JAX package are loaded: "
                         + ", ".join(found))


def parse(argv):
    import argparse

    ap = argparse.ArgumentParser(description="One run of one benchmark "
                                 "cell of the PyTorch port.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(root, argv, t_start) -> int:
    args = parse(argv)
    pin_caches(Path(root))
    import torch

    bench = Bench(root)
    chips = bench.cell(args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {chips} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return EXIT_NO_CHIP
    try:
        out = run_cell(root, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t_start=t_start)
    except ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return EXIT_FORBIDDEN
    found = guard.forbidden_modules()
    if found:
        print(str(ForbiddenImport(found)), file=sys.stderr)
        return EXIT_FORBIDDEN
    print(json.dumps(_clean(out)), flush=True)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


def _clean(x):
    """``x`` with every non-finite float written as a string: a compared
    number that could not be computed reads "inf", never a number."""
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x
