"""The readers of the program's spans (``harness/program_spans.py`` and the
``metrics/`` files that use it): only the last ``profiled_steps`` trees of a
run count, and each reader finds a positive number in a tiny CPU traced run
of each cell it is meant for and nothing in the others."""

import time
import types

import pytest

from bench_test_util import ROOT, TINY

from harness.manifest import Bench
from harness.program_spans import per_call_us, per_root_ms
from harness.runner import Run
from harness.trace import Spans

# metric -> the cells in which it reads something
CELLS = {
    "policy_ms.train": {"doorkey8x8.train_pooled", "putnextlocal.train_fresh"},
    "env_step_ms.train": {"doorkey8x8.train_pooled",
                          "putnextlocal.train_fresh"},
    "rollout_self_ms.train": {"doorkey8x8.train_pooled",
                              "putnextlocal.train_fresh"},
    "hooks_ms.train": {"putnextlocal.train_fresh"},
    "select_ms.train": {"doorkey8x8.train_pooled", "putnextlocal.train_fresh"},
    "gen_ms.train": {"putnextlocal.train_fresh"},
    "env_kernel_host_us.train": {"doorkey8x8.train_pooled",
                                 "putnextlocal.train_fresh"},
    "select_ms.env": {"doorkey8x8.vector_regen"},
    "gen_ms.env": {"doorkey8x8.vector_regen"},
    "env_kernel_host_us.env": {"doorkey8x8.vector_regen"},
}


def test_only_the_last_profiled_trees_of_the_run_count():
    from minigrid_tpu_torch.utils import trace

    trace.clear()
    trace.enable()
    try:
        with trace.span("train_step"):  # an earlier run's, left behind
            with trace.span("policy"):
                time.sleep(0.02)
        t_start = time.perf_counter()
        for _ in range(2):
            with trace.span("train_step"):
                with trace.span("policy"):
                    time.sleep(0.001)
                with trace.span("env.kernel"):
                    pass
    finally:
        trace.disable()
    recs = trace.records()
    policy = [r.end_ns - r.start_ns for r in recs if r.name == "policy"]
    kernel = [r.end_ns - r.start_ns for r in recs if r.name == "env.kernel"]

    def run(k, since):
        return types.SimpleNamespace(
            t_start=since, cell={"driver": "train",
                                 "traffic": {"profiled_steps": k}})

    try:
        # the last 2 trees, not the stale one
        assert per_root_ms(run(2, 0.0), "train_step", "policy") == \
            pytest.approx(sum(policy[1:]) / 2e6, rel=1e-12)
        assert per_call_us(run(2, 0.0), "train_step", "env.kernel") == \
            pytest.approx(sum(kernel) / 2e3, rel=1e-12)
        assert per_root_ms(run(3, 0.0), "train_step", "policy") == \
            pytest.approx(sum(policy) / 3e6, rel=1e-12)
        # the run made 2 trees: 3 are not there; no tree of another root
        assert per_root_ms(run(3, t_start), "train_step", "policy") is None
        assert per_root_ms(run(2, t_start), "env.step", "policy") is None
    finally:
        trace.clear()


def traced_readings(cell):
    """Every reader's number in a tiny CPU run of ``cell``, set up,
    windowed and traced as ``harness/runner.py::run_cell`` does, read
    before the next run."""
    import torch

    torch.set_num_threads(2)
    bench = Bench(ROOT)
    run = Run(bench=bench, cell=bench.cell(cell), seed=2**31 + 11,
              seconds=0.2, trace=True, device="cpu",
              t_start=time.perf_counter(), sizes=TINY[cell])
    driver = bench.driver(run.cell["driver"]).make(run)
    driver.setup()
    run.spans = Spans(run.sync)
    driver.window(run.seconds)
    run.trace_summary = driver.profile()
    return {m: bench.reader(m).read(run) for m in CELLS}


@pytest.fixture(scope="module")
def readings():
    return {cell: traced_readings(cell) for cell in TINY}


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_each_reader_reads_its_cells_and_nothing_elsewhere(readings,
                                                           metric):
    for cell, values in readings.items():
        value = values[metric]
        if cell in CELLS[metric]:
            assert value is not None and value > 0, (metric, cell)
        else:
            assert value is None, (metric, cell, value)
