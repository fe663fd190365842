"""The benchmark of the PyTorch and CUDA port: lockstep env throughput on
the card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process per run: it loads the port, builds (first run of a checkout)
or loads its kernels from the checkout's ``build/``, builds the cell's env
and policy, resets the batch from the seed's draws, warms up every shape,
runs one timed window (``window.py``), judges the window's outputs
against the plain reference (``check.py``) and prints one JSON line as
the last line of its standard output.  With ``--trace 0`` the line holds
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics
(``trace.py``, ``metrics/``).  The numbers compared, each beside its
limit, are the last lines of standard error and the line's last key.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_port import (check, counts, manifest, modules,  # noqa: E402
                        program, stalls, trace, window)
from bench_port.reference.scene import pointmaze_scene  # noqa: E402
from bench_port.traffic import Traffic  # noqa: E402

WARM_STEPS = 20         # set-up steps through the window's own loop
PROFILER_WARM_STEPS = 3


class Unavailable(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(name, seed, seconds, trace_on, device="cuda", t_start=None,
             num_envs=None):
    """One run of cell ``name``; returns (result line dict, check rows).
    ``device`` other than the card and ``num_envs`` serve the harness's
    CPU tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    chips = int(cells[name]["chips"])
    wl = manifest.workload(name)
    cfg = manifest.config(wl["config"])
    tspec = manifest.traffic(wl["traffic"])
    if num_envs is not None:
        tspec = dict(tspec, num_envs=num_envs)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise Unavailable(f"cell {name} needs {chips} CUDA device(s); "
                              f"{torch.cuda.device_count()} available")
        program.build_kernels()
    torch.set_grad_enabled(False)

    prog = program.Program(cfg, device)
    scene = pointmaze_scene(cfg["env"]["maze_id"])
    traffic = Traffic(tspec, cfg["env"], scene.free_cells, scene.cell_size,
                      seed, device)
    B = traffic.B
    draws0, phases = traffic.spawns(), traffic.phases()
    states = prog.reset(draws0).replace(steps=phases)
    start = program.flat(states)
    loop = window.Loop(prog, traffic, window.Spans("off"))
    # a throwaway sample held through the warm-up grows the allocator's
    # pool by the window's sampled states, so the window allocates nothing
    k = window.sampled_steps(B)
    states = window.run(loop, states, steps=max(WARM_STEPS, 2 * k),
                        device=device, sampler=window.Sampler(seed, k))[0]
    if trace_on:
        loop.spans = window.Spans("profiler")
        states, path = trace.profile_stretch(
            lambda n: window.run(loop, states, steps=n, device=device)[0],
            PROFILER_WARM_STEPS)
        os.remove(path)
    # the set-up's objects (torch, the port, the env) move out of the
    # collector's sight: a full collection then scans only what the window
    # makes, instead of stalling the host ~0.1 s while the card drains
    gc.collect()
    gc.freeze()
    window.synchronize(device)
    setup_s = time.perf_counter() - t_start

    sampler = window.Sampler(seed, window.sampled_steps(B))
    stamps = []
    with stalls.Watch() as watch:
        states, steps, wall, gaps = window.run(
            loop, states, seconds=seconds, device=device, sampler=sampler,
            stamps=stamps)
    tr = None
    if trace_on:
        tr = trace.Trace(B)
        loop.spans = window.Spans("drained", device)
        states = window.run(loop, states, steps=trace.DRAINED_STEPS,
                            device=device)[0]
        tr.host_spans = loop.spans.host
        loop.spans = window.Spans("profiler")
        _, path = trace.profile_stretch(
            lambda n: window.run(loop, states, steps=n, device=device),
            trace.PROFILED_STEPS)
        try:
            tr.load(path, trace.PROFILED_STEPS)
        finally:
            os.remove(path)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del states, loop, prog

    t_ref = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    judge = check.Judge(cfg, device, policy_path=manifest.policy_path(cfg))
    limits = cfg.get("limits", {})
    judge.reset(draws0, phases, start)
    del start
    resets = 0
    for _, (s_in, actions, draws, s_out) in sorted(sampler.items,
                                                   key=lambda x: x[0]):
        judge.step(program.flat(s_in), actions, draws, program.flat(s_out),
                   limits)
        resets += int(s_out.done.sum())
    correct, failed, rows = judge.verdict(limits)
    ref_s = time.perf_counter() - t_ref
    ref_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)

    metrics = {}
    if trace_on:
        tr.k1_ops = counts.step_ops(
            judge.ref.model, [item[0].physics.qpos for _, item in sampler.items])
        tr.k1_bytes = counts.k1_bytes(judge.ref.model)
        if judge.policy is not None:
            tr.policy_ops = counts.policy_ops(judge.policy[0])
        for m in manifest.per_layer(bench, name):
            v = manifest.reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        values = dict(env_steps_per_s=window.rate(B, steps, wall),
                      step_ms_p95=window.percentile(gaps, 95.0),
                      setup_s=setup_s)
        for m in manifest.end_to_end(bench, name):
            metrics[m["name"]] = dict(value=float(values[m["name"]]),
                                      unit=m["unit"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=chips, memory_peak_bytes=int(peak))
    line = dict(correct=bool(correct), attempted=B * steps, failed=failed,
                metrics=metrics, device=dev)
    if tr is not None:
        dev.update(busy_s=tr.busy_us() / 1e6, window_s=tr.window_us / 1e6)
        line["breakdown"] = tr.breakdown()
    info = dict(steps=steps, wall_s=wall, setup_s=setup_s,
                sampled_steps=sorted(i for i, _ in sampler.items),
                checked_env_steps=judge.checked, resets_checked=resets,
                reference_s=ref_s, reference_peak_bytes=int(ref_peak),
                stalls=watch.report(gaps, stamps))
    line["info"] = info
    line["checks"] = {n: dict(value=v, limit=lim) for n, v, lim in rows}
    return line, rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        line, rows = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    except Unavailable as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 3
    found = modules.forbidden_loaded()
    if found:
        print("bench_port: the process holds JAX modules: "
              + ", ".join(found), file=sys.stderr)
        return 4
    line["device"]["power_limit_w"] = power_limit()
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
