"""Device ms of one launch of kernel K1 (``k1_kernel``, the fused env
step), mean over the profiled stretch."""

K1 = r"\bk1_kernel\b"


def read(trace):
    return trace.kernel_ms(K1)
