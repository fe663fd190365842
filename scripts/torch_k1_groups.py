"""Times kernel K1 of one checkout of the repo on one NVIDIA GPU.

    python3 scripts/torch_k1_groups.py [--tree DIR] [--B 16384]
                                       [--sweep 264,2640]

Imports the package from ``--tree`` (default: the checkout that holds this
script), builds its ``step_kernel.cu`` and ``lidar_kernel.cu``, runs its
main path (``step_autoreset_batch`` of the umaze env with uniform random
actions) for ``--steps`` steps at B envs, holds K1's auto-reset step on the
last states against the plain twin with that tree's ``chip_smoke.py``
tolerances, checks that a second launch gives the same bits, prints the
ptxas report and, where the library has ``k1_occupancy``, the shared
memory per block and the warps per SM, and times K1 with CUDA events.
``--sweep`` also times it on the first n envs of the same states.  Prints
one JSON line per B.  An A/B of two builds runs it once per checkout in one
machine session: e.g. the parent commit unpacked with ``git archive`` under
``build/``, or a copy whose ``K1_G``/``K1_ENVS`` (``csrc/step_model.cuh``)
or ``SOURCE_FLAGS`` (``ops/build.py``) were edited.  Exits non-zero without
a CUDA device or when K1 disagrees with the twin.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--B", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", default="",
                    help="B values at which K1 is also timed (the first B "
                         "of the main-path states)")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k1_groups: needs a CUDA device")
    root = pathlib.Path(opt.tree or pathlib.Path(__file__).parents[1])
    sys.path.insert(0, str(root.resolve()))
    import chip_smoke
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    from mujoco_playground_tpu_torch.ops import build
    from mujoco_playground_tpu_torch.ops import step as k1

    card = chip_smoke.gpu_name_and_limit()
    tree = opt.tree or "this checkout"
    for row in chip_smoke.ptxas_report(
            build.build(("step_kernel.cu", "lidar_kernel.cu"))):
        print(f"{tree}: ptxas {row}")

    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, seed=0)
    model = env.model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    states = env.reset(opt.B)
    for _ in range(opt.steps):
        states = env.step_autoreset_batch(
            states, torch.rand((opt.B, 2), generator=gen, device=dev) * 2 - 1)
    ph = states.physics

    def rows(x):
        return x.reshape(x.shape[0], -1).T.contiguous()

    env_in = torch.cat([states.odom_ref.position[:, :2], states.goal,
                        states.prev_goal_distance[:, None],
                        env.reset_core(opt.B).physics.qpos[:, :2]],
                       -1).T.contiguous()
    args = (model, rows(ph.qpos), rows(ph.qvel),
            torch.rand((3, opt.B), generator=gen, device=dev) * 2 - 1,
            rows(ph.qacc_warmstart), env_in, env._env_statics(),
            env._fresh_statics(), False)
    active = k1.contact_activity(model, args[1]).sum(0).float()
    print(f"B={opt.B} after {opt.steps} main-path steps: "
          f"{float(active.mean()):.2f} active contact rows per env (max "
          f"{int(active.max())})")
    lib = build.load("step_kernel.cu")
    stream = torch.cuda.current_stream().cuda_stream
    failures = []
    got = k1.launch_k1(lib, *args, stream)
    again = k1.launch_k1(lib, *args, stream)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"{tree}: a second launch is bitwise equal: {same}")
    if not same:
        failures.append("repeat")
    chip_smoke.check_k1(f"{tree} B={opt.B}", got, k1.step_plain(*args),
                        model, failures)
    del got, again
    if hasattr(lib, "k1_occupancy"):
        lib.k1_occupancy.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        occ = (ctypes.c_int * 3)()
        lib.k1_occupancy(1, 1, 0, occ)
        print(f"{tree}: {occ[0]} B shared per block of {occ[1]} threads, "
              f"{occ[2]} blocks = {occ[2] * occ[1] // 32} warps per SM")
    for n in [opt.B] + [int(n) for n in opt.sweep.split(",") if n]:
        cut = (model,) + tuple(a[:, :n].contiguous() for a in args[1:6]) \
            + args[6:]
        t = [chip_smoke.cuda_ms(lambda: k1.launch_k1(lib, *cut, stream),
                                opt.reps) for _ in range(opt.rounds)]
        print(json.dumps({"tree": tree, "B": n, "ms": t,
                          "ms_mean": sum(t) / len(t),
                          "active_rows_per_env": float(active.mean()),
                          "card": card}))
    if failures:
        sys.exit(f"torch_k1_groups: disagree with the twin: {failures}")


if __name__ == "__main__":
    main()
