"""Score a committed solved policy with the port, over several eval seeds.

    python3 scripts/torch_solved_eval.py --run solved_randyaw --seeds jax,0,1
    python3 scripts/torch_solved_eval.py --run solved_randyaw --heading 0

Restores ``rl_logs/<run>/ppo_torch/step_*.pt`` (a policy carried across
from the run's Orbax checkpoint by ``scripts/torch_convert_solved.py``)
through the CLI's ``--eval-only`` path and evaluates it with EVAL.json's
protocol (512 parallel episodes, a deterministic policy, at most 6000
steps, the recipe's env flags) once per eval seed, each seed drawing other
spawns and goals; the seed ``jax`` plays EVAL.json's own episodes (the
JAX package's draws for its eval seed 0, ``ppo_torch/eval_seed0.npz``).
Prints each seed's success rate, mean return and length beside the JAX
package's figure from the run's EVAL.json (``EVAL_fixed_heading.json``
for ``--heading 0`` of the random-heading run), the spread over the
numbered seeds and how far their mean lies from the JAX figure in
standard deviations of the difference (EVAL.json's figure is one draw of
512 episodes itself), and the card with its power limit.
Needs one CUDA card (or ``--device cpu`` with tiny ``--steps``).
"""
import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mujoco_playground_tpu_torch.rl import train as train_lib  # noqa: E402
from mujoco_playground_tpu_torch.rl.evaluate import (  # noqa: E402
    deterministic_policy, evaluate_agent)

# the env flags of the solved runs' EVAL.json
SOLVED_ENV = ["--maze", "umaze", "--max-velocity", "1.5", "--max-angular",
              "3.0", "--goal-threshold", "0.5", "--sane-collision",
              "--collision-penalty", "-1", "--geodesic-reward", "10",
              "--goal-compass", "--normalize", "--hidden", "256", "256"]
HEADING = {"solved": 0.0, "solved_randyaw": 3.14159265}


def card():
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--run", default="solved", choices=sorted(HEADING))
    p.add_argument("--seeds", default="0")
    p.add_argument("--heading", type=float, default=None,
                   help="spawn heading noise (default: the run's)")
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--device", default=None)
    args = p.parse_args()
    heading = HEADING[args.run] if args.heading is None else args.heading
    ref_name = ("EVAL.json" if heading == HEADING[args.run]
                else "EVAL_fixed_heading.json")
    with open(os.path.join(ROOT, "rl_logs", args.run, ref_name)) as f:
        ref = json.load(f)["eval"]
    src_dir = os.path.join(ROOT, "rl_logs", args.run, train_lib.CKPT_SUBDIR)
    with tempfile.TemporaryDirectory() as log_dir:
        os.makedirs(os.path.join(log_dir, train_lib.CKPT_SUBDIR))
        for name in os.listdir(src_dir):
            shutil.copy(os.path.join(src_dir, name),
                        os.path.join(log_dir, train_lib.CKPT_SUBDIR))
        argv = (SOLVED_ENV + ["--algo", "ppo", "--eval-only", "--log-dir",
                              log_dir, "--num-envs", str(args.episodes),
                              "--max-episode-steps", str(args.steps),
                              "--spawn-heading-noise", str(heading)]
                + (["--device", args.device] if args.device else []))
        config = train_lib.config_from_args(
            train_lib.make_parser().parse_args(argv))
        ts, env, net = train_lib.train_ppo(config, eval_only=True,
                                           verbose=False, device=args.device)
    policy = deterministic_policy(net, norm=ts.norm)
    rates = []
    for seed in args.seeds.split(","):
        core = None
        if seed == "jax":
            with np.load(os.path.join(src_dir, "eval_seed0.npz")) as d:
                d = {k: torch.from_numpy(d[k][:args.episodes]).to(env.device)
                     for k in d.files}
            core = env.maze_core(d["start_xy"], d["goal_xy"], d["goal_cell"],
                                 d["yaw"] if heading else None)
        t0 = time.perf_counter()
        stats = evaluate_agent(
            env, policy, num_episodes=args.episodes, core=core,
            generator=torch.Generator(device=env.device).manual_seed(
                0 if core is not None else int(seed)))
        secs = time.perf_counter() - t0
        if core is None:
            rates.append(stats["success_rate"])
        print(f"{args.run} heading noise {heading:g}, eval seed {seed}: "
              f"success_rate {stats['success_rate']:.4f}, mean_return "
              f"{stats['mean_return']:.2f}, mean_length "
              f"{stats['mean_length']:.1f}; {secs:.2f} s", flush=True)
    if not rates:
        return
    sd = math.sqrt(ref["success_rate"] * (1 - ref["success_rate"])
                   / args.episodes)
    mean = sum(rates) / len(rates)
    # the difference of a k-seed mean and EVAL.json's one draw of n
    far = (mean - ref["success_rate"]) / (sd * math.sqrt(1 + 1 / len(rates)))
    print(f"{args.run} heading noise {heading:g}: success over "
          f"{len(rates)} seeds mean {mean:.4f}, min {min(rates):.4f}, max "
          f"{max(rates):.4f}; the JAX package's {ref_name} "
          f"{ref['success_rate']:.4f} (1 binomial SD at n={args.episodes}: "
          f"{sd:.4f}; the difference is {far:.2f} SDs of a difference) "
          f"({card()})")


if __name__ == "__main__":
    main()
