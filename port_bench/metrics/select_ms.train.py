"""select_ms.train: host milliseconds a train step in the reset select in
PyTorch (the program's `env.select` spans: the broadcast row's episode
fields, the fresh routing, `select_reset_states`)."""

from harness.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_step", "env.select")
