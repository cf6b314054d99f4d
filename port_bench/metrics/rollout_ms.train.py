"""rollout_ms.train: mean host milliseconds of one call of the rollout in the
traced window, a synchronisation at both edges (the benchmark's span)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "rollout")
