"""env_step_ms.train: host milliseconds a train step in the env's
auto-resetting steps (the program's `env.step` spans, inclusive: hooks,
kernel launches, select, generation inside), over the traced window's train
steps."""

from harness.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_step", "env.step")
