"""select_ms.env: host milliseconds a vector step in the reset select in
PyTorch (the program's `env.select` spans: `select_reset_states`)."""

from harness.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "env.step", "env.select")
