"""Share of the profiled stretch (%) in which no operation ran on the
device."""


def read(trace):
    if not trace.device or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
