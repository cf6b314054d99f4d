"""launches_per_step.train: device kernels, copies and sets a rollout step
inside the benchmark's rollout span (torch.profiler trace)."""

from harness.readers import device_ops_per_step


def read(run):
    return device_ops_per_step(run, "rollout", "profiled_rollout_steps")
