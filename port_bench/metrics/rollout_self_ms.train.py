"""rollout_self_ms.train: host milliseconds a train step in the rollout's
own code, outside its policy, env-step and generation spans (the program's
`rollout` span, self time): the loop's glue and the trajectory's stacking."""

from harness.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_step", "rollout", self_time=True)
