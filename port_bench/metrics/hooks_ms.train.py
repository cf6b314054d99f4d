"""hooks_ms.train: host milliseconds a train step in the env's step hooks
around the kernel (the program's `env.hooks` spans: action transforms,
`_pre_step`, `_post_step` with BabyAI's verifier)."""

from harness.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_step", "env.hooks")
