"""env_kernel_roofline: the env step contract's bytes over the HBM rate,
over the device time of the kernels named in kernels/env_step.json
(torch.profiler trace), in per cent of the roofline."""

from harness.readers import roofline


def read(run):
    return roofline(run, "env_step.json")
