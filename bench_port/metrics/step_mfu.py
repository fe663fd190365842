"""The whole env step's share of the H100's float32 peak (%): the frozen
count of operations per env step (K1's, ``counts.k1_ops``, plus the
policy's action in a policy cell, ``counts.policy_ops``) times the env
steps of the profiled stretch, over the device's busy time in the
stretch (the union of its operations on the trace's clock), over 67
TFLOP/s.  Busy time and not the stretch's length: the profiler's own host
cost stretches the traced steps by a share that differs from host to
host, and the untraced window's idle is what ``env_steps_per_s`` shows.
The glue's elementwise work (the merge, the geodesic lookups, the
compass: tens of operations an env against K1's tens of thousands) is not
counted."""
from bench_port import counts


def read(trace):
    if trace.k1_ops is None or not trace.kernels:
        return None
    busy_us = trace.busy_us()
    if busy_us <= 0:
        return None
    flops = ((trace.k1_ops + trace.policy_ops) * trace.num_envs
             * trace.steps)
    return 100.0 * flops / (busy_us / 1e6) / counts.PEAK_F32
