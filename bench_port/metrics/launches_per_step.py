"""Kernel launches on the device per env step in the profiled stretch."""


def read(trace):
    if not trace.kernels:
        return None
    return len(trace.kernels) / trace.steps
