"""The traced run's readings.  Two stretches follow the timed window: a
drained stretch of ``DRAINED_STEPS`` steps, in which the device is
synchronised before each host span and the span then timed on the host
clock (the profiler off), so a span reads its own host cost and never the
wait on a full launch queue; then a steady stretch of ``PROFILED_STEPS``
steps under ``torch.profiler`` with the spans as ``record_function``
ranges.  The profiler's Chrome trace gives every kernel, copy and set with
its time on the device, the host's launch call that made each kernel (by
correlation id) and the span the launch fell in.  ``Trace`` holds what the
per-layer readers (``metrics/<name>.py``) read; a reader that finds
nothing returns None."""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

import torch

PROFILED_STEPS = 30
DRAINED_STEPS = 40
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"LaunchKernel|cuLaunch")
STRETCH = "bench.stretch"
IDLE_HOST = "bench.loop"      # the host between the benchmark's spans


class Trace:
    """What one traced run measured.

    * ``num_envs``;
    * ``host_spans``: span name -> host seconds of each call in the
      drained stretch (profiler off);
    * ``steps``: the profiled stretch's steps; ``window_us``: its length;
      ``kernels``: (name, start us, duration us, span of its launch);
      ``device``: (start us, end us) of every device operation; ``spans``:
      (name, start us, end us) of the host spans in the stretch;
    * ``k1_ops``: the frozen count of K1's float32 operations per env step
      (``counts.k1_ops``) at the window's states, ``k1_bytes`` per env;
      ``policy_ops``: the policy's per env step (``counts.policy_ops``; 0
      where the cell has no policy).
    """

    def __init__(self, num_envs):
        self.num_envs = num_envs
        self.host_spans = {}
        self.steps, self.t0, self.window_us = 0, 0.0, 0.0
        self.kernels, self.device, self.spans, self._starts = [], [], [], []
        self.k1_ops = self.k1_bytes = None
        self.policy_ops = 0

    # ------------------------------------------------------------ readers
    def busy_us(self) -> float:
        """Length of the union of the device's operations."""
        total, end = 0.0, None
        for a, b in sorted(self.device):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def idle_gaps(self):
        """[(host span at the gap's middle, us)] of every stretch of the
        window with no device operation, longest first."""
        end = self.t0
        out = []
        for a, b in sorted(self.device):
            if a > end:
                out.append((self.host_at((end + a) / 2), a - end))
            end = max(end, b)
        if self.t0 + self.window_us > end:
            out.append((self.host_at((end + self.t0 + self.window_us) / 2),
                        self.t0 + self.window_us - end))
        return sorted(out, key=lambda g: -g[1])

    def host_at(self, t) -> str:
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.spans[i][2] >= t:
            return self.spans[i][0]
        return IDLE_HOST

    def kernel_ms(self, pattern: str):
        """Mean device ms of the kernels whose name matches ``pattern``
        (None where none ran)."""
        rx = re.compile(pattern)
        ds = [d for n, _, d, _ in self.kernels if rx.search(n)]
        return sum(ds) / len(ds) / 1e3 if ds else None

    def span_device_ms(self, span: str):
        """Device ms per step of the kernels launched inside ``span``
        (None where the span launched none)."""
        ds = [d for _, _, d, s in self.kernels if s == span]
        return sum(ds) / self.steps / 1e3 if ds else None

    def breakdown(self) -> dict:
        ops = {}
        for n, _, d, _ in self.kernels:
            ops[n] = ops.get(n, 0.0) + d
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ops=[[n[:160], d / 1e6] for n, d in top],
                    idle_gaps=[[n, d / 1e6] for n, d in self.idle_gaps()[:10]])

    # ------------------------------------------------------------ parsing
    def load(self, path, steps):
        """Read the profiled stretch from a Chrome trace file."""
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.steps = steps
        stretch = [e for e in events if e.get("name") == STRETCH
                   and e.get("cat") == "user_annotation"]
        if not stretch:
            raise RuntimeError("the profiled stretch is not in the trace")
        self.t0 = float(stretch[0]["ts"])
        self.window_us = float(stretch[0]["dur"])
        t1 = self.t0 + self.window_us
        self.spans = sorted(
            (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name") != STRETCH and "dur" in e)
        self.spans.sort(key=lambda s: s[1])
        self._starts = [s[1] for s in self.spans]
        launch_ts = {}
        for e in events:
            if e.get("cat") == "cuda_runtime" and LAUNCH.search(
                    e.get("name", "")):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    launch_ts[c] = float(e["ts"])
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b < self.t0 or a > t1:
                continue
            self.device.append((max(a, self.t0), min(b, t1)))
            if e["cat"] == "kernel":
                c = e.get("args", {}).get("correlation")
                lt = launch_ts.get(c)
                span = self.host_at(lt) if lt is not None else IDLE_HOST
                self.kernels.append((e["name"], a, float(e["dur"]), span))


def profile_stretch(run_steps, steps: int):
    """Run ``run_steps(steps)`` under ``torch.profiler`` inside the
    ``bench.stretch`` range; returns the Chrome trace's path (in the
    run's temporary directory; the caller removes it)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            out = run_steps(steps)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_port_trace_")
    os.close(fd)
    prof.export_chrome_trace(path)
    return out, path
