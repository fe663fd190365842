"""The readings the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 bench_port/control.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--steps 40]

In one process, for each seed: the cell's reset from the seed's draws and
a short window of ``--steps`` steps at the cell's own width and load, with
the run's sample of steps (``window.sampled_steps``); then every number of
``check.py`` for the program against the reference (the lower readings)
and, on the control seeds, for the control against the reference (the
upper readings).  The control is the reference put in the program's place
in the nearest lower precision: its physics, scans and env rows computed
in bfloat16 from the same inputs (the configuration states float32), and
its policy with TF32 matrix products (the configuration states float32
with TF32 off).  One JSON line per seed and kind, then the largest lower
and the smallest upper reading of each number.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_port import check, manifest, program, window  # noqa: E402
from bench_port.reference.scene import pointmaze_scene  # noqa: E402
from bench_port.traffic import Traffic  # noqa: E402


def readings(name, seeds, control_seeds=(), steps=40, device="cuda",
             num_envs=None):
    """[(kind, seed, {number: reading})] over ``seeds`` (kind "program")
    and ``control_seeds`` (kind "control")."""
    wl = manifest.workload(name)
    cfg = manifest.config(wl["config"])
    tspec = manifest.traffic(wl["traffic"])
    if num_envs is not None:
        tspec = dict(tspec, num_envs=num_envs)
    device = torch.device(device)
    if device.type == "cuda":
        program.build_kernels()
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    prog = program.Program(cfg, device)
    scene = pointmaze_scene(cfg["env"]["maze_id"])
    path = manifest.policy_path(cfg)
    j32 = check.Judge(cfg, device, policy_path=path)
    j16 = check.Judge(cfg, device, dtype=torch.bfloat16, policy_path=path)
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        traffic = Traffic(tspec, cfg["env"], scene.free_cells,
                          scene.cell_size, seed, device)
        draws0, phases = traffic.spawns(), traffic.phases()
        states = prog.reset(draws0).replace(steps=phases)
        start = program.flat(states)
        sampler = window.Sampler(seed, window.sampled_steps(traffic.B))
        loop = window.Loop(prog, traffic, window.Spans("off"))
        window.run(loop, states, steps=steps, device=device,
                   sampler=sampler)
        del states, loop
        items = [item for _, item in sorted(sampler.items,
                                            key=lambda x: x[0])]
        if seed in seeds:
            j32.clear()
            j32.reset(draws0, phases, start)
            for s_in, act, draws, s_out in items:
                j32.step(program.flat(s_in), act, draws,
                         program.flat(s_out), cfg["limits"])
            out.append(("program", seed, dict(j32.readings)))
        if seed in control_seeds:
            res = control(j32, j16, items)
            res["reset_gap"] = control_reset(j32, j16, draws0, phases)
            out.append(("control", seed, res))
        del start, items, sampler
    return out


@torch.no_grad()
def control_reset(j32, j16, draws, phases) -> float:
    """The control's start states against the float32 reference's."""
    worst = 0.0
    B = phases.shape[0]
    for a in range(0, B, check.BLOCK):
        b = min(a + check.BLOCK, B)
        d = [t[a:b] for t in draws]
        r32 = j32.reset_outputs(d, phases[a:b])
        r16 = j16.reset_outputs(d, phases[a:b])
        r16 = {k: (v.float() if v.is_floating_point() else v)
               for k, v in r16.items()}
        worst = max(worst, float(check.reset_gap(r16, r32).max()))
    return worst


@torch.no_grad()
def control(j32, j16, items) -> dict:
    """The control's readings against the float32 reference on the
    program's sampled input states."""
    res = {}
    for s_in, act, draws, _ in items:
        p_in = program.flat(s_in)
        B = act.shape[0]
        for a in range(0, B, check.BLOCK):
            b = min(a + check.BLOCK, B)
            blk = check.rows(p_in, a, b, j32.device)
            ab = act[a:b].to(j32.device)
            d = [t[a:b] for t in draws]
            r32 = j32.outputs(blk, ab, d)
            r16 = j16.outputs(blk, ab, d)
            r16 = {k: (v.float() if v.is_floating_point() else v)
                   for k, v in r16.items()}
            act16 = ref32 = None
            if j32.policy is not None:
                ref32 = j32.action(blk["obs"])
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    act16 = j32.action(blk["obs"])
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
            for k, v in j32.compare(r16, r32, act16, ref32).items():
                v = float(v.sum()) if k == "flags_differ" else float(v.max())
                res[k] = res.get(k, 0.0) + v if k == "flags_differ" \
                    else max(res.get(k, 0.0), v)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--steps", type=int, default=40)
    args = p.parse_args(argv)
    rows = readings(args.workload, args.seeds, args.control_seeds,
                    args.steps)
    lower, upper = {}, {}
    for kind, seed, r in rows:
        print(json.dumps(dict(kind=kind, seed=seed, readings=r)))
        for k, v in r.items():
            if kind == "program":
                lower[k] = max(lower.get(k, 0.0), v)
            else:
                upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps(dict(workload=args.workload, lower=lower,
                          upper=upper,
                          device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
