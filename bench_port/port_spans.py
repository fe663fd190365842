"""The port's own spans (``mujoco_playground_tpu_torch/utils/profiler.py``:
``envs.*``, ``ops.k1``, ``rl.*``) in two stretches of the window's loop,
and the readings they give.

* ``drained_stretch``: steps each begun on a synchronised device (the
  benchmark's spans in their ``"drained"`` mode), the port's tracer in
  memory mode; ``Host`` reads its records on the host clock.
* ``profiled_stretch``: steps under ``torch.profiler`` with the port's
  spans as ``record_function`` ranges (and the benchmark's too);
  ``Profiled`` reads the Chrome trace.

Unlike ``trace.Trace.host_at``, which credits a launch to the latest span
begun before it if that span is still open, ``Profiled`` nests: a device
operation belongs to every port span that contains the host call that
enqueued it (by correlation id) on the same thread, and one enqueued
outside every port span to ``OUTSIDE``.  So every operation of the
stretch is accounted for, and each idle gap is credited to the innermost
port span open on the stretch's thread at the gap's middle.

This module imports nothing of the port: the caller hands it the port's
profiler module.  A reading with nothing to read is None.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import statistics

from bench_port import trace, window

PORT = re.compile(r"^(envs|ops|rl)\.")
OUTSIDE = "outside the port"
STEP_SPAN = "envs.step_autoreset_batch"
SPANS_PER_STEP = 64         # records a step may make, for the buffer's size
TOP_GAPS = 10


def drained_stretch(loop, states, steps, device, profiler):
    """Run ``steps`` steps with the benchmark's spans drained and the
    port's tracer (``profiler``, the port's module) in memory mode;
    returns (states, ``Host``, the benchmark's host spans)."""
    loop.spans = window.Spans("drained", device)
    rec = profiler.Recorder(SPANS_PER_STEP * steps)
    with profiler.tracing(rec):
        states = window.run(loop, states, steps=steps, device=device)[0]
    return states, Host(rec.records(), steps, rec.dropped), loop.spans.host


def profiled_stretch(loop, states, steps, device, profiler):
    """Run ``steps`` steps under ``torch.profiler`` with both the
    benchmark's and the port's spans as ranges; returns (states,
    ``Profiled``)."""
    loop.spans = window.Spans("profiler")
    with profiler.tracing(profiler.PROFILER):
        states, path = trace.profile_stretch(
            lambda n: window.run(loop, states, steps=n, device=device)[0],
            steps)
    try:
        with open(path) as f:
            prof = Profiled(json.load(f)["traceEvents"], steps)
    finally:
        os.remove(path)
    return states, prof


def _median(values):
    return statistics.median(values) if values else None


def _union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


class Host:
    """The memory records of a stretch, (name, parent record, step id,
    start ns, end ns) each (``Recorder.records``), over ``steps`` steps."""

    def __init__(self, records, steps, dropped=0):
        self.records, self.steps, self.dropped = records, steps, dropped
        child = [0] * len(records)
        for name, parent, _, a, b in records:
            if parent >= 0:
                child[parent] += b - a
        self.self_ns = [b - a - c for (_, _, _, a, b), c in
                        zip(records, child)]

    def durations_ms(self, name):
        return [(b - a) / 1e6 for n, _, _, a, b in self.records if n == name]

    def self_ms(self, name):
        return [s / 1e6 for (n, *_), s in zip(self.records, self.self_ns)
                if n == name]

    def table(self) -> dict:
        """Per span name: calls and host self ms, each per step."""
        out = {}
        for (name, *_), s in zip(self.records, self.self_ns):
            row = out.setdefault(name, dict(calls=0.0, host_self_ms=0.0))
            row["calls"] += 1 / self.steps
            row["host_self_ms"] += s / 1e6 / self.steps
        return out

    def step_owner(self, step, enqueue_ms):
        """(the port span with the most self time in step ``step``, or
        ``OUTSIDE``, and that ms): the time outside is ``enqueue_ms`` less
        the step's outermost port spans."""
        own, top = {}, 0.0
        for (name, parent, sid, a, b), s in zip(self.records, self.self_ns):
            if sid != step:
                continue
            own[name] = own.get(name, 0.0) + s / 1e6
            if parent < 0:
                top += (b - a) / 1e6
        own[OUTSIDE] = enqueue_ms - top
        name = max(own, key=own.get)
        return name, own[name]


class Profiled:
    """A profiled stretch of ``steps`` steps from its Chrome trace events
    (the ``bench.stretch`` range bounds it)."""

    def __init__(self, events, steps):
        self.steps = steps
        stretch = [e for e in events if e.get("name") == trace.STRETCH
                   and e.get("cat") == "user_annotation"]
        if not stretch:
            raise RuntimeError("the profiled stretch is not in the trace")
        s = stretch[0]
        self.t0, self.window_us = float(s["ts"]), float(s["dur"])
        self.tid = (s.get("pid"), s.get("tid"))
        t1 = self.t0 + self.window_us
        # each thread's port spans, parents before children
        self.threads = {}
        for e in events:
            if e.get("cat") == "user_annotation" and "dur" in e and \
                    PORT.match(e.get("name", "")):
                a = float(e["ts"])
                self.threads.setdefault((e.get("pid"), e.get("tid")),
                                        []).append(
                    [a, a + float(e["dur"]), e["name"], -1])
        self._starts = {}
        self.host_us = {}
        for key, spans in self.threads.items():
            spans.sort(key=lambda x: (x[0], -x[1]))
            open_ = []
            for i, sp in enumerate(spans):
                while open_ and spans[open_[-1]][1] < sp[1]:
                    open_.pop()
                sp[3] = open_[-1] if open_ else -1
                open_.append(i)
            self._starts[key] = [sp[0] for sp in spans]
            child = [0.0] * len(spans)
            for a, b, _, parent in spans:
                if parent >= 0:
                    child[parent] += b - a
            for (a, b, name, _), c in zip(spans, child):
                if self.t0 <= a <= t1:
                    self.host_us.setdefault(name, []).append(b - a - c)
        calls = {}
        for e in events:
            c = e.get("args", {}).get("correlation")
            if c is not None and e.get("cat", "").startswith("cuda_"):
                calls[c] = (float(e["ts"]), (e.get("pid"), e.get("tid")))
        # (name, start us, duration us, the port spans that enqueued it,
        # outermost first)
        self.ops = []
        for e in events:
            if e.get("cat") not in trace.DEVICE_CATS or "dur" not in e:
                continue
            a = float(e["ts"])
            d = float(e["dur"])
            if a + d < self.t0 or a > t1:
                continue
            call = calls.get(e.get("args", {}).get("correlation"))
            chain = self.chain(call[1], call[0]) if call else ()
            self.ops.append((e.get("name", ""), a, d, chain))

    def chain(self, thread, t) -> tuple:
        """The port spans open on ``thread`` at time ``t``, outermost
        first."""
        spans = self.threads.get(thread)
        if not spans:
            return ()
        i = bisect.bisect_right(self._starts[thread], t) - 1
        while i >= 0 and spans[i][1] < t:
            i = spans[i][3]
        out = []
        while i >= 0:
            out.append(spans[i][2])
            i = spans[i][3]
        return tuple(reversed(out))

    # ------------------------------------------------------------ readers
    def device_ms(self, inside, outside=None):
        """Device ms per step of the operations enqueued inside span
        ``inside`` and not inside ``outside`` (None where there are
        none)."""
        ds = [d for _, _, d, ch in self.ops
              if inside in ch and (outside is None or outside not in ch)]
        return sum(ds) / self.steps / 1e3 if ds else None

    def table(self) -> dict:
        """Per port span name: calls, host self ms on the trace's clock
        (the profiler's cost included), and the device ms and operations
        enqueued inside it, each per step; ``OUTSIDE`` for the rest."""
        out = {n: dict(calls=len(v) / self.steps,
                       traced_host_self_ms=sum(v) / 1e3 / self.steps,
                       device_ms=0.0, launches=0.0)
               for n, v in self.host_us.items()}
        for _, _, d, ch in self.ops:
            for n in set(ch) or (OUTSIDE,):
                row = out.setdefault(n, dict(device_ms=0.0, launches=0.0))
                row["device_ms"] += d / 1e3 / self.steps
                row["launches"] += 1 / self.steps
        return out

    def coverage(self):
        """Share of the device's busy time (the union of its operations)
        that operations enqueued inside a port span cover (None where the
        device ran nothing)."""
        all_ = [(a, a + d) for _, a, d, _ in self.ops]
        busy = _union(all_)
        if busy <= 0:
            return None
        return _union([(a, a + d) for _, a, d, ch in self.ops
                           if ch]) / busy

    def idle_gaps(self, top=TOP_GAPS):
        """[(the innermost port span open on the stretch's thread at the
        gap's middle, or ``OUTSIDE``; ms)] of the ``top`` longest stretches
        of the window with no device operation."""
        t1 = self.t0 + self.window_us
        end, gaps = self.t0, []
        for a, b in sorted((max(a, self.t0), min(a + d, t1))
                           for _, a, d, _ in self.ops):
            if a > end:
                gaps.append(((end + a) / 2, a - end))
            end = max(end, b)
        if t1 > end:
            gaps.append(((end + t1) / 2, t1 - end))
        gaps.sort(key=lambda g: -g[1])
        return [[(self.chain(self.tid, m) or (OUTSIDE,))[-1], d / 1e3]
                for m, d in gaps[:top]]


# ---------------------------------------------------------------- readings
def rl_policy_ms(prof: Profiled):
    """Device ms per step of the operations the policy's forward enqueues
    (``rl.policy``)."""
    return prof.device_ms("rl.policy")


def rl_value_ms(prof: Profiled):
    """Device ms per step of the value tower and head (``rl.critic``),
    which a greedy action discards."""
    return prof.device_ms("rl.critic")


def envs_glue_ms(prof: Profiled):
    """Device ms per step of the env step's operations other than K1's
    launch: inside ``envs.step_autoreset_batch``, outside ``ops.k1``."""
    return prof.device_ms(STEP_SPAN, outside="ops.k1")


def envs_step_host_ms(host: Host):
    """Median host ms of the env step's span over the drained stretch."""
    return _median(host.durations_ms(STEP_SPAN))


def k1_launch_host_ms(host: Host):
    """Median host self ms of K1's launch path (``ops.k1``) over the
    drained stretch."""
    return _median(host.self_ms("ops.k1"))


def counters_per_step(before: dict, after: dict, steps: int) -> dict:
    """Each counter's change over a stretch, per step."""
    return {k: (after[k] - before.get(k, 0)) / steps for k in after}
