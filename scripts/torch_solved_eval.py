"""Score a committed solved policy with the port, over several eval seeds.

    python3 scripts/torch_solved_eval.py --run solved_randyaw --seeds jax,0,1
    python3 scripts/torch_solved_eval.py --run solved_randyaw --heading 0
    python3 scripts/torch_solved_eval.py --run solved_medium --seeds jax \
        --out rl_logs/solved_medium/EVAL_torch.json

Restores ``rl_logs/<run>/ppo_torch/step_*.pt`` (a policy carried across
from the run's Orbax checkpoint by ``scripts/torch_convert_solved.py``)
through the CLI's ``--eval-only`` path and evaluates it with EVAL.json's
protocol (512 parallel episodes, a deterministic policy, the run's
episode budget and env flags, all read from the ``env`` block of its
EVAL.json: the maze, the step limit, the heading noise, the towers) once
per eval seed, each seed drawing other
spawns and goals; the seed ``jax`` plays EVAL.json's own episodes (the
JAX package's draws for its eval seed 0, ``ppo_torch/eval_seed0.npz``).
Prints each seed's success rate, mean return and length beside the JAX
package's figure from the run's EVAL.json (``EVAL_fixed_heading.json``
for ``--heading 0`` of the random-heading run), the spread over the
numbered seeds and how far their mean lies from the JAX figure in
standard deviations of the difference (EVAL.json's figure is one draw of
512 episodes itself), and the card with its power limit; ``--out`` also
writes them as JSON.  Needs one CUDA card (or ``--device cpu`` with tiny
``--steps``).
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

RUNS = ("solved", "solved_randyaw", "solved_medium")
# the CLI's --maze of each EVAL.json maze_id
MAZES = {"PointMaze_UMaze-v3": "umaze", "PointMaze_Open-v3": "open",
         "PointMaze_Medium-v3": "medium", "PointMaze_Large-v3": "large"}


def eval_flags(env):
    """The CLI flags of an EVAL.json ``env`` block (the run's recipe)."""
    flags = ["--maze", MAZES[env["maze_id"]],
             "--max-velocity", str(env["max_linear_velocity"]),
             "--max-angular", str(env["max_angular_velocity"]),
             "--max-episode-steps", str(env["max_episode_steps"]),
             "--goal-threshold", str(env["goal_threshold"]),
             "--collision-penalty", str(env["collision_penalty"]),
             "--progress-reward", str(env["progress_reward"]),
             "--geodesic-reward", str(env["geodesic_reward"]),
             "--spawn-heading-noise", str(env.get("spawn_heading_noise",
                                                  0.0)),
             "--hidden"] + [str(h) for h in env["hidden"]]
    return flags + [f for f, on in (("--sane-collision",
                                     env["sane_collision"]),
                                    ("--goal-compass", env["goal_compass"]),
                                    ("--normalize", env["normalize"])) if on]


def card():
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--run", default="solved", choices=RUNS)
    p.add_argument("--seeds", default="0")
    p.add_argument("--heading", type=float, default=None,
                   help="spawn heading noise (default: the run's)")
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--steps", type=int, default=None,
                   help="episode budget (default: the run's)")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None, help="write the results as JSON")
    args = p.parse_args()
    run_dir = os.path.join(ROOT, "rl_logs", args.run)
    with open(os.path.join(run_dir, "EVAL.json")) as f:
        env_block = json.load(f)["env"]
    own = env_block.get("spawn_heading_noise", 0.0)
    heading = own if args.heading is None else args.heading
    ref_name = "EVAL.json" if heading == own else "EVAL_fixed_heading.json"
    with open(os.path.join(run_dir, ref_name)) as f:
        ref = json.load(f)["eval"]
    steps = args.steps or env_block["max_episode_steps"]
    src_dir = os.path.join(run_dir, train_lib.CKPT_SUBDIR)
    with tempfile.TemporaryDirectory() as log_dir:
        os.makedirs(os.path.join(log_dir, train_lib.CKPT_SUBDIR))
        for name in os.listdir(src_dir):
            shutil.copy(os.path.join(src_dir, name),
                        os.path.join(log_dir, train_lib.CKPT_SUBDIR))
        argv = (eval_flags(env_block)
                + ["--algo", "ppo", "--eval-only", "--log-dir", log_dir,
                   "--num-envs", str(args.episodes),
                   "--max-episode-steps", str(steps),
                   "--spawn-heading-noise", str(heading)]
                + (["--device", args.device] if args.device else []))
        config = train_lib.config_from_args(
            train_lib.make_parser().parse_args(argv))
        ts, env, net = train_lib.train_ppo(config, eval_only=True,
                                           verbose=False, device=args.device)
    policy = deterministic_policy(net, norm=ts.norm)
    rates, results = [], {}
    where = card()
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
        results[seed] = dict(stats, seconds=secs,
                             env_steps_per_second=args.episodes * steps
                             / secs)
        print(f"{args.run} heading noise {heading:g}, eval seed {seed}: "
              f"success_rate {stats['success_rate']:.4f}, mean_return "
              f"{stats['mean_return']:.2f}, mean_length "
              f"{stats['mean_length']:.1f}; {args.episodes} x {steps} steps "
              f"in {secs:.2f} s ({where})", flush=True)
    sd = math.sqrt(ref["success_rate"] * (1 - ref["success_rate"])
                   / args.episodes)
    summary = dict(jax_success_rate=ref["success_rate"],
                   jax_eval_file=f"rl_logs/{args.run}/{ref_name}",
                   binomial_sd=sd,
                   bound_3sd=[ref["success_rate"] - 3 * sd,
                              ref["success_rate"] + 3 * sd])
    if "jax" in results:
        summary["jax_episodes_within_3sd"] = bool(
            abs(results["jax"]["success_rate"] - ref["success_rate"])
            <= 3 * sd)
    if rates:
        mean = sum(rates) / len(rates)
        # the difference of a k-seed mean and EVAL.json's one draw of n
        far = (mean - ref["success_rate"]) / (sd * math.sqrt(1
                                                             + 1 / len(rates)))
        summary.update(seeds_mean=mean, seeds_sds_of_difference=far)
        print(f"{args.run} heading noise {heading:g}: success over "
              f"{len(rates)} seeds mean {mean:.4f}, min {min(rates):.4f}, "
              f"max {max(rates):.4f}; the JAX package's {ref_name} "
              f"{ref['success_rate']:.4f} (1 binomial SD at "
              f"n={args.episodes}: {sd:.4f}; the difference is {far:.2f} SDs "
              f"of a difference) ({where})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(
                checkpoint=f"rl_logs/{args.run}/{train_lib.CKPT_SUBDIR}/"
                           + sorted(n for n in os.listdir(src_dir)
                                    if n.endswith(".pt"))[-1],
                protocol=(f"rl.evaluate.evaluate_agent through the CLI's "
                          f"--eval-only, {args.episodes} parallel episodes, "
                          f"deterministic policy, max {steps} steps; seed "
                          "'jax': the JAX package's episodes for its eval "
                          "seed 0 (ppo_torch/eval_seed0.npz)"),
                env=dict(env_block, spawn_heading_noise=heading,
                         max_episode_steps=steps),
                card=where, scored_by="scripts/torch_solved_eval.py",
                eval=results, **summary), f, indent=2)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
