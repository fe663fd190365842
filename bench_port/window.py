"""The timed window: a closed loop over lockstep env steps, dispatched
ahead, and its end-to-end arithmetic.

Each iteration makes the step's actions from the traffic (the policy's
forward on the observation in a policy cell), draws the fresh spawns and
builds them (``maze_core``), runs ``step_autoreset_batch`` and records a
CUDA event.  The host stays ``LAG`` steps ahead of the card: it waits on
the event of an older step and never drains the queue, so its enqueue
overlaps the card's work as in a rollout.  The window starts at a
synchronised point and ends with the last step enqueued before the time is
up, then one synchronise.
"""
from __future__ import annotations

import contextlib
import math
import random
import time

import torch

LAG = 3                 # steps the host runs ahead of the card
CHECKED_ENV_STEPS = 262144   # env steps of the window the reference checks
MAX_SAMPLED_STEPS = 4


class Spans:
    """Named host spans around the calls into each layer.  ``mode``:
    ``"off"`` (the timed runs), ``"drained"`` (host durations on the host
    clock, the profiler off, each span begun on a synchronised device, so
    it times the host's own work and never a wait on a full launch queue)
    or ``"profiler"`` (``record_function`` ranges that the trace
    attributes kernels and gaps to)."""

    def __init__(self, mode="off", device="cpu"):
        self.mode, self.device = mode, device
        self.host: dict = {}

    @contextlib.contextmanager
    def _host(self, name):
        synchronize(self.device)
        t = time.perf_counter()
        try:
            yield
        finally:
            self.host.setdefault(name, []).append(time.perf_counter() - t)

    def __call__(self, name):
        if self.mode == "drained":
            return self._host(name)
        if self.mode == "profiler":
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


class HostEvent:
    """A completion stamp on the host clock, where there is no card (the
    harness's CPU tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, later) -> float:
        return (later.t - self.t) * 1e3


def make_event(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return HostEvent()


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sampled_steps(num_envs: int) -> int:
    """Window steps the reference checks: whole steps, one to
    ``MAX_SAMPLED_STEPS``, of about ``CHECKED_ENV_STEPS`` env steps in
    all."""
    return max(1, min(MAX_SAMPLED_STEPS, CHECKED_ENV_STEPS // num_envs))


class Sampler:
    """A uniform sample of ``k`` window steps drawn from the seed
    (reservoir sampling), holding each sampled step's input states,
    actions, spawn draws and output states.  The program's states are
    fresh tensors every step, so holding them copies nothing."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(int(seed))
        self.k, self.items = k, []

    def offer(self, i, item):
        if len(self.items) < self.k:
            self.items.append((i, item))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = (i, item)


class Loop:
    """One iteration of the window's loop body."""

    def __init__(self, program, traffic, spans: Spans):
        self.program, self.traffic, self.spans = program, traffic, spans

    def step(self, states):
        sp, tr, prog = self.spans, self.traffic, self.program
        if prog.policy is not None:
            with sp("policy.forward"):
                actions = tr.actions(states.obs, prog.act)
        else:
            with sp("traffic.actions"):
                actions = tr.actions(states.obs)
        with sp("traffic.spawns"):
            draws = tr.spawns()
        with sp("env.maze_core"):
            fresh = prog.spawn(draws)
        with sp("env.step_autoreset_batch"):
            new = prog.step(states, actions, fresh)
        return new, actions, draws


def run(loop: Loop, states, seconds=None, steps=None, device="cuda",
        sampler: Sampler = None, stamps: list = None):
    """Run the loop from a synchronised start for ``seconds`` (or exactly
    ``steps`` steps) and synchronise; returns (states, steps run, wall
    seconds, per-step completion gaps in ms).  ``stamps``, where given,
    gets each step's host clock at its start and before its wait."""
    synchronize(device)
    start = make_event(device)
    events = []
    t0 = time.perf_counter()
    start.record()
    i = 0
    while (time.perf_counter() - t0 < seconds) if steps is None else \
            i < steps:
        t_step = time.perf_counter()
        new, actions, draws = loop.step(states)
        ev = make_event(device)
        ev.record()
        events.append(ev)
        if sampler is not None:
            sampler.offer(i, (states, actions, draws, new))
        states = new
        if stamps is not None:
            stamps.append((t_step, time.perf_counter()))
        if i >= LAG:
            with loop.spans("bench.wait"):
                events[i - LAG].synchronize()
        i += 1
    synchronize(device)
    wall = time.perf_counter() - t0
    gaps = [start.elapsed_time(events[0])] if events else []
    gaps += [events[k - 1].elapsed_time(events[k])
             for k in range(1, len(events))]
    return states, i, wall, gaps


def rate(num_envs: int, steps: int, wall_s: float) -> float:
    """Env steps per second over the whole window."""
    return num_envs * steps / wall_s


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) of all values, by nearest rank:
    the smallest value with at least q% of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
