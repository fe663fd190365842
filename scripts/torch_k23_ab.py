"""Checks and times kernels K2 (lidar) and K3 (Newton solve) of one or more
checkouts of the repo, on the same inputs, on one NVIDIA GPU.

    python3 scripts/torch_k23_ab.py [--trees DIR,DIR,...] [--B 16384]
                                    [--steps 200] [--reps 20]

The inputs come from this checkout: path B (the umaze env with the compat
manifolds, ``reference_flat_manifold`` and ``reference_wheel_patch``) runs
``--steps`` steps of ``step_autoreset_batch`` at B envs with uniform random
actions; K3 takes the Newton system of its last states
(``engine.newton_inputs``) with their warm start, K2 the frames of a
batched reset of the umaze env.  Each tree's ``lidar_kernel.cu`` and
``newton_kernel.cu`` are built by that tree's ``ops/build.py`` into its own
``build/`` and driven through this checkout's wrappers (the C interfaces
``k2_launch`` and ``k3_launch`` are the same in every tree).  Per tree it
prints the ptxas report, the occupancy where the library exports it, each
kernel's error against its plain twin (``chip_smoke.py``'s tolerances and
set-aside rule) and whether a second launch gives the same bits.  Then it
times the trees in the order given and back (A B B A for two), one JSON
line per timing: each kernel by CUDA events around each call
(``chip_smoke.cuda_ms``, ``K2_ms``/``K3_ms``, the host's launch path
included) and replayed from a CUDA graph (``chip_smoke.graph_ms``,
``K2_device_ms``/``K3_device_ms``, the kernel alone).  For an A/B, unpack the parent commit with ``git
archive`` under ``build/`` and pass ``--trees build/parent,.``.  Exits
non-zero without a CUDA device or when a kernel disagrees with its twin.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def load_build(tree, i):
    """The ``ops/build.py`` module of a tree, under a name of its own."""
    path = tree / "mujoco_playground_tpu_torch" / "ops" / "build.py"
    spec = importlib.util.spec_from_file_location(f"k23_build_{i}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", default=".")
    ap.add_argument("--B", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reps", type=int, default=20)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k23_ab: needs a CUDA device")
    import chip_smoke
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.physics import engine

    card = chip_smoke.gpu_name_and_limit()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    trees = [pathlib.Path(t) for t in opt.trees.split(",")]
    libs = []
    for i, tree in enumerate(trees):
        build = load_build(tree, i)
        logs = build.build(("lidar_kernel.cu", "newton_kernel.cu"))
        for row in chip_smoke.ptxas_report(logs):
            print(f"{tree}: ptxas {row}")
        libs.append((build.load("lidar_kernel.cu"),
                     build.load("newton_kernel.cu")))
        occ = [chip_smoke.occupancy_line(lib, name) or "not exported"
               for lib, name in zip(libs[-1], ("k2_occupancy",
                                               "k3_occupancy"))]
        print(f"{tree}: occupancy K2 {occ[0]}; K3 {occ[1]}")

    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, seed=0)
    model = env.model
    reset = env.reset(opt.B).physics
    xp = reset.xpos.reshape(opt.B, -1).T.contiguous()
    xq = reset.xquat.reshape(opt.B, -1).T.contiguous()
    cenv = make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, seed=0,
                              reference_flat_manifold=True,
                              reference_wheel_patch=True)
    states = cenv.reset(opt.B)
    for _ in range(opt.steps):
        states = cenv.step_autoreset_batch(
            states, torch.rand((opt.B, 2), generator=gen, device=dev) * 2 - 1)
    ph = states.physics
    sys_args = engine.newton_inputs(cenv.model, ph)
    ws = ph.qacc_warmstart.T.contiguous()
    active = sys_args[14].sum(0).float()
    print(f"K3 system B={opt.B} after {opt.steps} path B steps: "
          f"{float(active.mean()):.2f} of {sys_args[8].shape[0]} contact "
          f"rows in contact per env (max {int(active.max())})")
    want3 = k3.newton_solve_plain(*sys_args, warmstart=ws)
    want2 = k2.lidar_plain(model, xp, xq)
    def run2(lib2):
        return k2.launch_k2(lib2, model, xp, xq,
                            torch.cuda.current_stream().cuda_stream)

    def run3(lib3):
        return k3.launch_k3(lib3, *sys_args, ws,
                            torch.cuda.current_stream().cuda_stream)

    failures = []
    for tree, (lib2, lib3) in zip(trees, libs):
        for name, run, lib in (("K2", run2, lib2), ("K3", run3, lib3)):
            got, again = run(lib), run(lib)
            torch.cuda.synchronize()
            chip_smoke.check_repeat(f"{tree} {name}", [got], [again],
                                    failures)
            if name == "K2":
                chip_smoke.check_k2(f"{tree}", got, want2, failures)
            else:
                chip_smoke.check_k3(f"{tree}", got, want3, failures,
                                    chip_smoke.k3_witness(sys_args, ws, gen))
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    for i in order:
        lib2, lib3 = libs[i]
        times = {}
        for name, run, lib in (("K2", run2, lib2), ("K3", run3, lib3)):
            call = functools.partial(run, lib)
            times[f"{name}_ms"] = chip_smoke.cuda_ms(call, opt.reps)
            times[f"{name}_device_ms"] = chip_smoke.graph_ms(call, opt.reps)
        print(json.dumps({"tree": str(trees[i]), "B": opt.B, **times,
                          "k3_rows_in_contact": float(active.mean()),
                          "card": card}))
    if failures:
        sys.exit(f"torch_k23_ab: disagree with the twin: {failures}")


if __name__ == "__main__":
    main()
