"""launches_per_step.env: device kernels, copies and sets a vector step
(torch.profiler trace over the profiled steps)."""

from harness.readers import device_ops_per_step


def read(run):
    return device_ops_per_step(run, None, "profiled_env_steps")
