"""The BossLevel configuration and its cell, found by name as any other:
the configuration, the traffic and its driver, the reference family and
the two new metrics; their readers read nothing without the program's
spans and counters and a number with them; a tiny traced CPU run of the
cell reads them and is followed by the reference; a program without the
counters is refused at set-up, before any work."""

import time
import types

import pytest

from bench_test_util import ROOT, run_tiny

from harness.manifest import Bench
from reference import follow as FL

CELL = "bosslevel.train_fresh_own"
NEW = ("gen_attempts_per_level.train", "gen_instr_ms.train")
TINY = {"ppo": {"num_envs": 32, "rollout_len": 8}}


def test_the_cell_and_its_files_are_found():
    bench = Bench(ROOT)
    cell = bench.cell(CELL)
    assert cell["driver"] == "train_own"
    assert cell["config"]["env"]["id"] == "BabyAI-BossLevel-v0"
    assert cell["config_entry"]["reduced"] == []
    assert type(FL.family(cell["config"]["env"])).__module__ == (
        "reference.families.bosslevel")
    assert FL.family(cell["config"]["env"]).max_steps == 4608
    assert hasattr(bench.driver("train_own").make, "__call__")
    _, layer = bench.metrics(CELL)
    names = [m["name"] for m in layer]
    assert set(NEW) <= set(names)
    assert "gen_host_syncs.train" in names
    for m in NEW:
        assert hasattr(bench.reader(m), "read")
        assert all(m not in [x["name"] for x in bench.metrics(c)[1]]
                   for c in ("doorkey8x8.train_fresh",
                             "putnextlocal.train_fresh"))


def _run(counters=None):
    cell = Bench(ROOT).cell(CELL)
    return types.SimpleNamespace(cell=cell, counters=counters or {},
                                 window={"steps": 2},
                                 t_start=time.perf_counter())


def test_the_readers_read_nothing_without_the_programs_names():
    from minigrid_tpu_torch.utils import trace

    bench = Bench(ROOT)
    trace.clear()
    run = _run()
    for m in NEW:
        assert bench.reader(m).read(run) is None


def test_the_readers_read_the_programs_spans_and_counters():
    from minigrid_tpu_torch.utils import trace

    bench = Bench(ROOT)
    run = _run({"gen_levels": 40, "gen_attempts": 50})
    trace.clear()
    trace.enable()
    try:
        for _ in range(2):
            with trace.span("train_step"), trace.span("rollout"), \
                    trace.span("gen"), trace.span("gen.instr"):
                time.sleep(0.002)
    finally:
        trace.disable()
    assert bench.reader(NEW[0]).read(run) == pytest.approx(1.25)
    assert bench.reader(NEW[1]).read(run) >= 2.0
    trace.clear()


def test_a_tiny_traced_run_reads_the_new_metrics_and_is_followed():
    """Set up, windowed and traced as ``harness/runner.py::run_cell`` does
    (the device's metrics read nothing on the CPU), then checked."""
    import torch

    from harness.runner import Run
    from harness.trace import Spans

    torch.set_num_threads(2)
    bench = Bench(ROOT)
    run = Run(bench=bench, cell=bench.cell(CELL), seed=2**31 + 5,
              seconds=0.2, trace=True, device="cpu",
              t_start=time.perf_counter(), sizes=TINY)
    driver = bench.driver(run.cell["driver"]).make(run)
    driver.setup()
    run.spans = Spans(run.sync)
    driver.window(run.seconds)
    run.trace_summary = driver.profile()
    read = {m: bench.reader(m).read(run)
            for m in NEW + ("gen_host_syncs.train",)}
    assert read[NEW[0]] >= 1.0
    assert read[NEW[1]] > 0
    assert read["gen_host_syncs.train"] > 0
    driver.release()
    checks = driver.check()
    assert checks["env_mismatches"]["value"] == 0
    assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]


def test_a_program_without_the_counters_is_refused(monkeypatch):
    from minigrid_tpu_torch.core import roomgrid

    monkeypatch.setattr(roomgrid, "COUNTERS",
                        types.SimpleNamespace(host_syncs=0))
    with pytest.raises(RuntimeError, match="levels"):
        run_tiny(CELL, sizes=TINY)
