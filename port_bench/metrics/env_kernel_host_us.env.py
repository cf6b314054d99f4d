"""env_kernel_host_us.env: host microseconds of one call of the fused
kernel's launch wrappers in a vector step (the program's `env.kernel` spans:
argument marshalling and the ctypes call of the step or observe entry)."""

from harness.program_spans import per_call_us


def read(run):
    return per_call_us(run, "env.step", "env.kernel")
