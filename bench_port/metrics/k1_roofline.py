"""K1's share of its roofline (%): the least time the H100 could take for
the work of one fused env step over the batch (the larger of the frozen
count's operations over the float32 peak and its bytes over the HBM
bandwidth, ``bench_port/counts.py``) over K1's measured device time."""
from bench_port import counts

K1 = r"\bk1_kernel\b"


def read(trace):
    ms = trace.kernel_ms(K1)
    if ms is None or trace.k1_ops is None:
        return None
    bound, _ = counts.bound_ms(trace.k1_bytes * trace.num_envs,
                               trace.k1_ops * trace.num_envs)
    return 100.0 * bound / ms
