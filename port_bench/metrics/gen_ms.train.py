"""gen_ms.train: host milliseconds a train step in layout generation inside
the rollout (the program's `gen` spans under `rollout`: the fresh buffer)."""

from harness.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_step", "gen", inside="rollout")
