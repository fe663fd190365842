"""Profiling hooks: spans and counters inside the port, and a
``torch.profiler`` trace of a block.

**Spans.**  ``span(name)`` marks a stretch of the port's host code: the env
step's stages (``envs.*``), K1's launch path (``ops.k1``) and the policy's
forward (``rl.*``).  The tracer is in one of three modes:

* off (the default, and every timed run): ``span`` reads one module
  global and returns a shared null context; it allocates nothing and
  calls into torch for nothing;
* memory (``tracing(Recorder(capacity))``): each span becomes one record
  (name id, parent record, step id, start ns, end ns) on
  ``time.perf_counter_ns`` in the recorder's buffer, allocated once by the
  caller, so recording makes no Python object per span and gives the
  collector nothing to scan.  The step id counts exits of
  ``envs.step_autoreset_batch`` (``STEP_SPAN``): the spans of one lockstep
  step share it;
* profiler (``tracing(PROFILER)``): each span is a
  ``torch.profiler.record_function`` range, on the device trace's clock,
  so a trace can credit every kernel and idle gap to the port's host code.
  ``trace_context`` turns it on for its block.

**Counters.**  The kernel wrappers count their launches on function
attributes (``ops/step.py::step_fused``, ``ops/lidar.py::lidar``,
``ops/newton.py::newton_solve``), and ``ops/build.py`` its loads, nvcc runs
and constant uploads; ``counters()`` reads them all into one flat dict.
"""
from __future__ import annotations

import array
import contextlib
import os
import time

import torch

RECORD = 5      # fields of a memory record: name id, parent, step, start, end
STEP_SPAN = "envs.step_autoreset_batch"

_NULL = contextlib.nullcontext()
_tracer = None          # None (off), a Recorder (memory) or PROFILER


def span(name: str):
    """A context manager that marks ``name`` in the current mode."""
    t = _tracer
    if t is None:
        return _NULL
    return t.span(name)


@contextlib.contextmanager
def tracing(tracer):
    """Turn the spans on for a block: into ``tracer``, a ``Recorder``
    (memory mode) or ``PROFILER``; None turns them off.  The mode before
    the block comes back after it."""
    global _tracer
    before, _tracer = _tracer, tracer
    try:
        yield tracer
    finally:
        _tracer = before


class _Profiler:
    """Profiler mode: each span a ``record_function`` range."""

    @staticmethod
    def span(name):
        return torch.profiler.record_function(name)


PROFILER = _Profiler()


class _MemorySpan:
    """One span name's context manager in a ``Recorder``, shared by all of
    its calls: the record in flight lives in the recorder's buffer."""

    __slots__ = ("rec", "nid", "ends_step")

    def __init__(self, rec, nid, ends_step):
        self.rec, self.nid, self.ends_step = rec, nid, ends_step

    def __enter__(self):
        r = self.rec
        i = r.n
        if i == r.capacity or r.lost_depth:
            r.lost_depth += 1
            r.dropped += 1
            return None
        b, o = r.buf, RECORD * i
        b[o] = self.nid
        b[o + 1] = r.open
        b[o + 2] = r.step
        r.n = i + 1
        r.open = i
        b[o + 3] = time.perf_counter_ns()
        return None

    def __exit__(self, exc_type, exc, tb):
        t = time.perf_counter_ns()
        r = self.rec
        if self.ends_step:
            r.step += 1
        if r.lost_depth:
            r.lost_depth -= 1
            return False
        o = RECORD * r.open
        r.buf[o + 4] = t
        r.open = r.buf[o + 1]
        return False


class Recorder:
    """Memory mode's store: ``capacity`` span records in one ``array``
    allocated here.  Spans that find it full are counted in ``dropped``
    and not recorded."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.buf = array.array("q", bytes(8 * RECORD * self.capacity))
        self.n = self.dropped = self.step = self.lost_depth = 0
        self.open = -1          # the innermost open record, -1 at the top
        self.names: list = []   # name id -> name
        self._spans: dict = {}

    def span(self, name):
        s = self._spans.get(name)
        if s is None:
            s = self._spans[name] = _MemorySpan(self, len(self.names),
                                                name == STEP_SPAN)
            self.names.append(name)
        return s

    def records(self) -> list:
        """[(name, parent record or -1, step id, start ns, end ns)] of the
        spans recorded, in the order they began (a span still open ends
        at 0)."""
        b = self.buf
        return [(self.names[b[o]], b[o + 1], b[o + 2], b[o + 3], b[o + 4])
                for o in range(0, RECORD * self.n, RECORD)]


def counters() -> dict:
    """A snapshot of every counter of the port, one flat dict: K1 and K1e
    launches, both by flag set (``k1.by_variant.<env,fresh,ws_compare,dr>``,
    ``ops/step.py`` ``K1_VARIANTS``), K2 with the model's floor and with a
    per-env floor, K3 on the row-major and the kernel layout, libraries
    loaded, nvcc runs started and constant blocks uploaded."""
    from mujoco_playground_tpu_torch.ops import build
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.ops import step as k1
    out = {"k1.launches": k1.step_fused.launches,
           "k1e.launches": k1.step_fused.launches_dr}
    for key in k1.K1_VARIANTS:
        name = ",".join(str(int(f)) for f in key)
        out[f"k1.by_variant.<{name}>"] = k1.step_fused.by_variant[key]
    out.update({
        "k2.launches": k2.lidar.launches,
        "k2.launches_floor": k2.lidar.launches_floor,
        "k3.launches": k3.newton_solve.launches,
        "k3.launches_kernel_layout": k3.newton_solve.launches_kernel_layout,
        "build.loads": build.load.loads,
        "build.compiles": build.build.compiles,
        "build.uploads": build.upload_constants.uploads})
    return out


@contextlib.contextmanager
def trace_context(log_dir: str):
    """Profile a block with ``torch.profiler`` (the host, and the CUDA
    device where one exists), with the port's spans in profiler mode, and
    write a Chrome trace, ``trace.json``, into ``log_dir`` (open it in
    Perfetto or chrome://tracing).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with tracing(PROFILER):
            yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
