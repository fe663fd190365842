"""The port's own spans and counters in a benchmark cell, beside the
benchmark's own readings, in one process.

    python3 scripts/torch_port_spans.py --workload <cell> --seed <n> \
        [--seconds 20]
    python3 scripts/torch_port_spans.py --workload umaze_random_64k \
        --seed <n> --cost 1 [--seconds 20]

Set-up as ``bench_port/run.py``'s traced run (the cell's env and policy,
the reset from the seed's draws, the warm-up), then:

1. the timed window with the port's tracer in memory mode
   (``utils/profiler.py``): each of its three longest enqueues is credited
   to the port span with the most self time in that step, or to the time
   outside the port, with the main thread's CPU ms and the allocator's
   new device allocations in that step (``stalls``, ``Probe``); the port's
   counters are read per step over it (``port_counters``), and the
   caching allocator's device allocations and frees (``allocator``);
2. the benchmark's own drained and profiled stretches, the port's spans
   off, read by its metric readers (``benchmark``: ``policy_ms``,
   ``env_host_ms``, ``launches_per_step``, ``k1_ms``, ``idle_share``);
3. the port's drained stretch (40 steps, memory mode) and profiled stretch
   (30 steps, the port's spans as profiler ranges),
   ``bench_port/port_spans.py``: the readings ``rl_policy_ms``,
   ``rl_value_ms``, ``envs_glue_ms``, ``envs_step_host_ms`` and
   ``k1_launch_host_ms``, each span's calls, host self ms, device ms and
   launches per step (``port_spans``), the ten longest idle gaps with
   their span (``port_idle_gaps``) and the share of device busy time
   enqueued inside a port span (``coverage``); and the benchmark's own
   ``env.step_autoreset_batch`` span in the port's drained stretch
   (``env_host_ms_port_on``), and again in a drained stretch after all
   with the port's spans off (``env_host_ms_after``): against the two
   stretches with the spans off, the tracer's host cost when on.

With ``--cost N``, instead of 1-3: N rounds of four windows, the tracer
off, in memory mode, in memory mode, off, and each window's env steps
per second.  Prints one JSON line with the card's name and power limit.
No reference check runs: a run of ``bench_port/run.py`` judges the
outputs.  ``--device cpu --num-envs 8`` rehearses on the plain twins.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from bench_port import (manifest, port_spans, program, run,  # noqa: E402
                        stalls, trace, window)
from bench_port.reference.scene import pointmaze_scene  # noqa: E402
from bench_port.traffic import Traffic  # noqa: E402
from mujoco_playground_tpu_torch.utils import profiler  # noqa: E402

WINDOW_STEPS_PER_S = 400     # sizes the window's record buffer


def set_up(name, seed, device, num_envs=None):
    """The cell's loop and warmed states, as ``run.run_cell`` makes
    them."""
    wl = manifest.workload(name)
    cfg = manifest.config(wl["config"])
    tspec = manifest.traffic(wl["traffic"])
    if num_envs is not None:
        tspec = dict(tspec, num_envs=num_envs)
    if device.type == "cuda":
        program.build_kernels()
    torch.set_grad_enabled(False)
    prog = program.Program(cfg, device)
    scene = pointmaze_scene(cfg["env"]["maze_id"])
    traffic = Traffic(tspec, cfg["env"], scene.free_cells, scene.cell_size,
                      seed, device)
    states = prog.reset(traffic.spawns()).replace(steps=traffic.phases())
    loop = window.Loop(prog, traffic, window.Spans("off"))
    k = window.sampled_steps(traffic.B)
    states = window.run(loop, states, steps=max(run.WARM_STEPS, 2 * k),
                        device=device, sampler=window.Sampler(seed, k))[0]
    loop.spans = window.Spans("profiler")
    states, path = trace.profile_stretch(
        lambda n: window.run(loop, states, steps=n, device=device)[0],
        run.PROFILER_WARM_STEPS)
    os.remove(path)
    loop.spans = window.Spans("off")
    return loop, states, traffic.B


class Probe(window.Loop):
    """The window's loop body, noting for each step the main thread's CPU
    time across its enqueue and the allocator's device allocations so
    far, so a long enqueue can be told apart: the thread computing or
    spinning, the thread off the CPU, or a ``cudaMalloc``."""

    def __init__(self, loop, device):
        super().__init__(loop.program, loop.traffic, loop.spans)
        self.device, self.marks = device, []

    def step(self, states):
        t = time.thread_time()
        out = super().step(states)
        self.marks.append((t, time.thread_time(),
                           allocator(self.device).get(SEGMENTS, 0)))
        return out

    def explain(self, i) -> dict:
        """Step ``i``'s thread CPU ms and new device allocations."""
        t0, t1, seg = self.marks[i]
        return dict(thread_cpu_ms=(t1 - t0) * 1e3,
                    new_segments=seg - (self.marks[i - 1][2] if i else seg))


SEGMENTS = "segment.all.allocated"


def allocator(device) -> dict:
    """The caching allocator's cumulative counts: device allocations and
    frees (``cudaMalloc``/``cudaFree``), retries after a failed one."""
    if device.type != "cuda":
        return {}
    m = torch.cuda.memory_stats(device)
    return {k: m.get(k, 0) for k in (SEGMENTS, "segment.all.freed",
                                     "num_alloc_retries")}


def timed_window(loop, states, seed, seconds, device, rec=None):
    """One window as the benchmark's, with the port's tracer in memory
    mode into ``rec`` where given; returns (states, steps, wall s, gaps,
    stamps, the ``stalls.Watch``)."""
    sampler = window.Sampler(seed, window.sampled_steps(loop.traffic.B))
    stamps = []
    gc.collect()
    window.synchronize(device)
    with stalls.Watch() as watch, profiler.tracing(rec):
        states, steps, wall, gaps = window.run(
            loop, states, seconds=seconds, device=device, sampler=sampler,
            stamps=stamps)
    return states, steps, wall, gaps, stamps, watch


def readings(args, device):
    loop, states, B = set_up(args.workload, args.seed, device,
                             args.num_envs)
    rec = profiler.Recorder(port_spans.SPANS_PER_STEP * WINDOW_STEPS_PER_S
                            * max(1, int(args.seconds)))
    gc.freeze()
    probe = Probe(loop, device)
    c0, m0 = profiler.counters(), allocator(device)
    states, steps, wall, gaps, stamps, watch = timed_window(
        probe, states, args.seed, args.seconds, device, rec)
    c1, m1 = profiler.counters(), allocator(device)
    host_w = port_spans.Host(rec.records(), steps, rec.dropped)
    report = watch.report(gaps, stamps)
    report["port"] = [[i, *host_w.step_owner(i, ms), probe.explain(i)]
                      for ms, i in report["longest_enqueues_ms"]]

    tr = trace.Trace(B)
    loop.spans = window.Spans("drained", device)
    states = window.run(loop, states, steps=trace.DRAINED_STEPS,
                        device=device)[0]
    tr.host_spans = loop.spans.host
    loop.spans = window.Spans("profiler")
    states, path = trace.profile_stretch(
        lambda n: window.run(loop, states, steps=n, device=device)[0],
        trace.PROFILED_STEPS)
    try:
        tr.load(path, trace.PROFILED_STEPS)
    finally:
        os.remove(path)
    bench = {n: manifest.reader(n)(tr) for n in (
        "policy_ms", "env_host_ms", "launches_per_step", "k1_ms",
        "idle_share")}

    states, host, drained = port_spans.drained_stretch(
        loop, states, trace.DRAINED_STEPS, device, profiler)
    states, prof = port_spans.profiled_stretch(
        loop, states, trace.PROFILED_STEPS, device, profiler)
    loop.spans = window.Spans("drained", device)
    window.run(loop, states, steps=trace.DRAINED_STEPS, device=device)
    after = loop.spans.host["env.step_autoreset_batch"]
    port = dict(
        rl_policy_ms=port_spans.rl_policy_ms(prof),
        rl_value_ms=port_spans.rl_value_ms(prof),
        envs_glue_ms=port_spans.envs_glue_ms(prof),
        envs_step_host_ms=port_spans.envs_step_host_ms(host),
        k1_launch_host_ms=port_spans.k1_launch_host_ms(host))
    d = drained.get("env.step_autoreset_batch")
    spans = prof.table()
    for name, row in host.table().items():
        spans.setdefault(name, {}).update(row)
    return dict(
        workload=args.workload, seed=args.seed, num_envs=B,
        window=dict(steps=steps, wall_s=wall,
                    env_steps_per_s=window.rate(B, steps, wall),
                    records=rec.n, dropped=rec.dropped),
        readings=port, benchmark=bench,
        env_host_ms_port_on=statistics.median(d) * 1e3,
        env_host_ms_after=statistics.median(after) * 1e3,
        coverage=prof.coverage(), port_spans=spans,
        port_idle_gaps=prof.idle_gaps(),
        port_counters=port_spans.counters_per_step(c0, c1, steps),
        allocator={k: m1[k] - m0[k] for k in m1},
        stalls=report, dropped=host.dropped + rec.dropped)


def cost(args, device):
    """Rates of windows with the tracer off and in memory mode, in the
    order off, memory, memory, off, ``args.cost`` times."""
    loop, states, B = set_up(args.workload, args.seed, device,
                             args.num_envs)
    cap = (port_spans.SPANS_PER_STEP * WINDOW_STEPS_PER_S
           * max(1, int(args.seconds)))
    gc.freeze()
    out = []
    for _ in range(args.cost):
        for mode in ("off", "memory", "memory", "off"):
            rec = profiler.Recorder(cap) if mode == "memory" else None
            states, steps, wall, *_ = timed_window(
                loop, states, args.seed, args.seconds, device, rec)
            out.append(dict(mode=mode, steps=steps, wall_s=wall,
                            env_steps_per_s=window.rate(B, steps, wall),
                            dropped=rec.dropped if rec else 0))
    return dict(workload=args.workload, seed=args.seed, num_envs=B,
                seconds=args.seconds, windows=out)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--cost", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=None)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; --device cpu runs the plain twins")
    out = cost(args, device) if args.cost else readings(args, device)
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    out["power_limit_w"] = run.power_limit() if device.type == "cuda" \
        else None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
