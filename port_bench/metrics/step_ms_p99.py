"""step_ms_p99: the 99th percentile (nearest rank) of the latency of every
step of the window, from the call to the host's read of that step's
results, host clock (ms)."""

from harness.readers import percentile


def read(run):
    p = percentile(run.window.get("latencies"), 99)
    return None if p is None else p * 1e3
