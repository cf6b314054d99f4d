"""gen_ms.env: host milliseconds a vector step in the regen draw of fresh
layouts (the program's `gen` spans)."""

from harness.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "env.step", "gen")
