"""device_idle_share: per cent of the profiled window in which the device
ran no kernel, copy or set (torch.profiler trace)."""

from harness.readers import idle_share


def read(run):
    return idle_share(run)
