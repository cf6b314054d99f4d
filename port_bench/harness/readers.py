"""Reductions the metrics' readers share. Each returns None where the run
has nothing to read (a cell without the work, or a run without a trace),
never a 0 that stands for nothing."""

from __future__ import annotations

import math

from harness import peaks


def span_ms(run, name: str):
    return None if run.spans is None else run.spans.mean_ms(name)


def idle_share(run):
    """Per cent of the traced window in which the device ran nothing."""
    t = run.trace_summary
    if t is None or t.window_s <= 0 or t.device_events == 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0


def roofline(run, kernels_file: str):
    """The least time the env step's contract bytes take at the HBM rate,
    over the device time of the kernels that ``kernels/<file>`` names, in
    per cent."""
    t = run.trace_summary
    moved = run.counters.get("env_contract_bytes")
    if t is None or not moved:
        return None
    names = run.bench.data_file("kernels", kernels_file)["kernels"]
    secs = t.kernel_seconds(names)
    if secs <= 0:
        return None
    return moved / peaks.HBM_BYTES_PER_S / secs * 100.0


def device_ops_per_step(run, span: str | None, steps_key: str):
    """Device kernels, copies and sets per step: inside the benchmark's
    span ``span`` (all of the traced window where None), over the steps
    ``counters[steps_key]`` counts."""
    t = run.trace_summary
    steps = run.counters.get(steps_key)
    if t is None or not steps or not t.device_events:
        return None
    count = t.device_events if span is None else t.span_device_events.get(
        span)
    return None if count is None else count / steps


def mfu(run):
    """The train step's model FLOPs at the traced window's step rate, over
    the bf16 dense peak, in per cent."""
    w = run.window
    flops = run.counters.get("train_step_flops")
    if not flops or not w.get("steps") or not w.get("seconds"):
        return None
    rate = w["steps"] * flops / w["seconds"]
    return rate / peaks.BF16_FLOPS_PER_S * 100.0


def percentile(values, q: float):
    """The nearest-rank ``q``-th percentile of ``values``."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
