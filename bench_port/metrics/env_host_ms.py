"""Host ms of the ``step_autoreset_batch`` call, the enqueue of one env
step (the ``env.step_autoreset_batch`` span), median over the drained
stretch's steps: each call begins on a synchronised device, so it reads
the glue's own host cost and never a wait on a full launch queue."""
import statistics


def read(trace):
    d = trace.host_spans.get("env.step_autoreset_batch")
    return statistics.median(d) * 1e3 if d else None
