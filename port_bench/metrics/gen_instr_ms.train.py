"""gen_instr_ms.train: host milliseconds a train step in the instruction
stage of generation inside the rollout (the program's `gen.instr` spans
under `rollout`: the leaves' descriptor draws, the tree, the surface
tokens and the budgets)."""

from harness.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_step", "gen.instr", inside="rollout")
