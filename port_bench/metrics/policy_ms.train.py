"""policy_ms.train: host milliseconds a train step in the rollout's policy
steps (the program's `policy` spans: observation encoding, forward, Gumbel
argmax, log-probability), over the traced window's train steps."""

from harness.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_step", "policy")
