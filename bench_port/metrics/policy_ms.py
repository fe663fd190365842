"""Device ms per step of the kernels the policy's forward launches (the
benchmark's ``policy.forward`` span), from the profiled stretch."""


def read(trace):
    return trace.span_device_ms("policy.forward")
