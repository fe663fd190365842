"""Kernels K1 and K1e of two checkouts on one NVIDIA GPU, in the order
A B B A.

    python3 scripts/torch_k1_ab.py --trees build/parent,. [--B 16384]
        [--steps 200] [--warmup 20] [--reps 20]

Runs each checkout once per position of A B B A in a process of its own,
which imports the package and ``chip_smoke.py`` of that checkout, builds
its K1, K1e and K2 libraries (nvcc, cached under its ``build/``), and
prints one JSON line: the ptxas lines of K1's and K1e's variants
(registers, stack, spills), each flag set's shared bytes per block and
warps per SM (``chip_smoke.k1_occupancy_report``), the main path's ms per
env step (the umaze env at solver 4/3, ``step_autoreset_batch`` with
uniform random actions, CUDA events over ``--steps`` steps after
``--warmup``), and K1 (``<1,1,0>``, on the main path's last states) and
K1e (``<1,1,0,dr>``, on path A's, the default randomization) timed as
``chip_smoke.py`` times them: ``ms`` by CUDA events around each wrapper
call and ``device_ms`` by one replay of a CUDA graph of ``--reps`` calls.
The card's name and power limit go beside every line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def one(opt):
    import torch
    sys.path.insert(0, str(pathlib.Path(opt.tree).resolve()))
    import chip_smoke as cs
    from mujoco_playground_tpu_torch.envs import (DomainRandomizedEnv,
                                                  RandomizationConfig,
                                                  make_ackermann_env)
    from mujoco_playground_tpu_torch.ops import build
    from mujoco_playground_tpu_torch.ops import step as k1
    from mujoco_playground_tpu_torch.physics import engine
    logs = build.build(("step_kernel.cu", "step_kernel_dr.cu",
                        "lidar_kernel.cu"))
    ptxas = [r for r in cs.ptxas_report(logs) if r.startswith("step_")]
    occupancy = cs.k1_occupancy_report(build)
    dev = torch.device("cuda")
    B = opt.B
    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, seed=cs.SEED)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)

    def actions():
        return torch.rand((B, 2), generator=gen, device=dev) * 2 - 1
    st = env.reset(B)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for i in range(opt.steps):
        if i == opt.warmup:
            torch.cuda.synchronize()
            t0.record()
        st = env.step_autoreset_batch(st, actions())
    t1.record()
    torch.cuda.synchronize()
    step_ms = t0.elapsed_time(t1) / (opt.steps - opt.warmup)

    def rows(x):
        return x.reshape(x.shape[0], -1).T.contiguous()

    fresh_xy = env.reset_core(B).physics.qpos[:, :2]

    def args_of(s):
        ph = s.physics
        env_in = torch.cat([s.odom_ref.position[:, :2], s.goal,
                            s.prev_goal_distance[:, None], fresh_xy],
                           -1).T.contiguous()
        return (env.model, rows(ph.qpos), rows(ph.qvel),
                torch.rand((3, B), generator=gen, device=dev) * 2 - 1,
                rows(ph.qacc_warmstart), env_in, env._env_statics(),
                env._fresh_statics(), False)
    args = args_of(st)
    dr_env = DomainRandomizedEnv(
        env, B, torch.Generator(device=dev).manual_seed(cs.SEED + 3),
        RandomizationConfig())
    ds = dr_env.reset()
    for _ in range(opt.steps):
        ds = dr_env.step_autoreset_batch(ds, actions())
    dargs = args_of(ds)
    params = engine.dr_params(dr_env.models, env.model, B)
    out = dict(tree=opt.tree, B=B, card=cs.gpu_name_and_limit(),
               main_path_ms_per_step=step_ms, ptxas=ptxas,
               occupancy=occupancy)
    for name, call in (("K1", lambda: k1.step_fused(*args)),
                       ("K1e", lambda: k1.step_fused(*dargs,
                                                     dr_params=params))):
        out[f"{name}_ms"] = cs.cuda_ms(call, opt.reps)
        out[f"{name}_device_ms"] = cs.graph_ms(call, opt.reps)
    print(json.dumps(out), flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--trees", default=None)
    p.add_argument("--tree", default=None)
    p.add_argument("--B", type=int, default=16384)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--reps", type=int, default=20)
    opt = p.parse_args()
    if opt.tree:
        return one(opt)
    a, b = opt.trees.split(",")
    for tree in (a, b, b, a):
        cmd = [sys.executable, __file__, "--tree", tree, "--B", str(opt.B),
               "--steps", str(opt.steps), "--warmup", str(opt.warmup),
               "--reps", str(opt.reps)]
        subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
