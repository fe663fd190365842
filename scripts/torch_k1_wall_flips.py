"""How often kernel K1 and its float32 twin part on wall-contact states, on
the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_k1_wall_flips.py [--B 1024]
        [--seed 11] [--fma]

Compiles ``csrc/step_kernel.cu`` as host C++ (as the CPU tests do; with
``--fma``, with fused multiply-adds, as nvcc compiles it for the card),
steps B umaze envs from ``wall_poses`` three times through it and through
the float32 twin, and prints per step the envs over ``chip_smoke.py``'s K1
tolerance, how far the float32 twin and the kernel each are from a float64
twin run (in tolerances), and whether the float64 step is converged there
(4 against 16 Newton iterations).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mujoco_playground_tpu_torch.envs import make_ackermann_env  # noqa: E402
from mujoco_playground_tpu_torch.envs.poses import wall_poses  # noqa: E402
from mujoco_playground_tpu_torch.ops import build  # noqa: E402
from mujoco_playground_tpu_torch.ops import step as k1  # noqa: E402


def rows(x):
    return x.reshape(x.shape[0], -1).T.contiguous()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--fma", action="store_true")
    opt = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        so = pathlib.Path(tmp) / "step_kernel.so"
        fp = ["-ffp-contract=fast", "-mfma"] if opt.fma else \
            ["-ffp-contract=off"]
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", *fp,
                        "-x", "c++", str(build.CSRC / "step_kernel.cu"), "-o",
                        str(so)], check=True)
        lib = ctypes.CDLL(str(so))
        env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                                 ls_iterations=3, device="cpu", seed=0)
        model = env.model
        m16 = dataclasses.replace(model, solver_iterations=16,
                                  ls_iterations=8)
        statics, fresh = env._env_statics(), env._fresh_statics()
        gen = torch.Generator().manual_seed(opt.seed)
        ph = wall_poses(env, opt.B, gen)
        q, v, ws = rows(ph.qpos), rows(ph.qvel), rows(ph.qacc_warmstart)
        st = env.reset(opt.B)
        env_in = rows(torch.cat([st.odom_ref.position[:, :2], st.goal,
                                 st.prev_goal_distance[:, None],
                                 ph.qpos[:, :2]], -1))
        active = k1.contact_activity(model, q).sum(0).float()
        print(f"B={opt.B} wall states, fma={opt.fma}: "
              f"{float(active.mean()):.2f} active contact rows per env "
              f"(max {int(active.max())})")
        for step in range(3):
            ctrl = torch.rand((3, opt.B), generator=gen) * 2 - 1
            args = (model, q, v, ctrl, ws, env_in, statics, fresh, False)
            got = k1.launch_k1(lib, *args, None)
            want = k1.step_plain(*args)
            f64 = [t.double() for t in args[1:6]]
            x4 = [t.float() for t in cs.k1_views(
                k1.step_plain(model, *f64, *args[6:]), model)]
            x16 = [t.float() for t in cs.k1_views(
                k1.step_plain(m16, *f64, *args[6:]), model)]
            g, w = cs.k1_views(got, model), cs.k1_views(want, model)
            over = cs.outputs_ratio(g, w, cs.K1_TOLS) > 1
            twin = cs.outputs_ratio(w, x4, cs.K1_TOLS)[over]
            kern = cs.outputs_ratio(g, x4, cs.K1_TOLS)[over]
            conv = cs.outputs_ratio(x4, x16, cs.K1_TOLS)[over]
            print(f"step {step}: {int(over.sum())} envs over tolerance; "
                  f"float32 twin from float64 "
                  f"{[round(float(x), 1) for x in twin]}; kernel from "
                  f"float64 {[round(float(x), 1) for x in kern]}; float64 "
                  f"4 vs 16 iterations, largest "
                  f"{float(conv.max()) if len(conv) else 0.0:.3g}")
            q, v, ws = want[0], want[1], want[4]


if __name__ == "__main__":
    main()
