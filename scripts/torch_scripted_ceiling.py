"""Scripted-expert ceiling probe, on the port: the counterpart of
``scripts/dev_scripted_ceiling.py``.

A hand-crafted goal-seeking policy (pure pursuit toward the goal, with
lidar wall repulsion, reversing to goals behind) is scored through the
same ``rl.evaluate.evaluate_agent`` the trainers use, which bounds what a
learned policy can reach in the arena and calibrates the solved runs'
success rates (PARITY.md: 44.3% umaze, 45.5% with a random spawn heading,
25.4% medium).

    python3 scripts/torch_scripted_ceiling.py --max-velocity 1.5 \\
        --max-angular 3.0 --max-episode-steps 6000
    python3 scripts/torch_scripted_ceiling.py --max-velocity 1.5 \\
        --max-angular 3.0 --max-episode-steps 6000 \\
        --spawn-heading-noise 3.14159265
    python3 scripts/torch_scripted_ceiling.py --max-velocity 1.5 \\
        --max-angular 3.0 --max-episode-steps 12000 \\
        --maze PointMaze_Medium-v3

The flags are the JAX script's (and its env: default solver,
``collision_ignores_nohit=True``), plus ``--device`` (default: the CUDA
card) and ``--out``.  The episodes are the JAX script's own: the spawn,
goal and yaw draws of ``evaluate_agent(..., rng=PRNGKey(7))`` for the
arena, written by ``scripts/torch_convert_solved.py`` to
``rl_logs/scripted_torch/scripted_seed7_<arena>.npz`` (the three arenas
of ``ARENAS``).  ``--out`` writes the statistics as JSON, beside the
card's name and power limit.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

DRAWS_DIR = os.path.join(ROOT, "rl_logs", "scripted_torch")
SEED = 7
# the arenas whose JAX draws are committed: (maze, heading noise) -> name
ARENAS = {("PointMaze_UMaze-v3", 0.0): "umaze",
          ("PointMaze_UMaze-v3", 3.14159265): "umaze_heading",
          ("PointMaze_Medium-v3", 0.0): "medium"}
# PARITY.md's figures of the JAX script (512 episodes each)
JAX_RATES = {"umaze": 0.443, "umaze_heading": 0.455, "medium": 0.254}


def scripted_policy(obs):
    """obs (B, 79) -> action (B, 2) in [-1, 1].

    obs layout: [72 lidar, x, y, heading, dx, dy, dist, angle_to_goal]
    (angle is the goal bearing minus the heading, wrapped).  Full throttle
    scaled down in turns, steering proportional to the bearing error,
    biased away from near walls; goals in the rear hemisphere are driven
    to in reverse (the robot's turn rate saturates near 0.6 rad/s, so a
    U-turn costs more than a short episode)."""
    angle = obs[..., 78]
    dist = obs[..., 77]
    lidar = obs[..., :72]
    valid = torch.where(lidar < 0, 12.0, lidar)
    left = valid[..., 6:30].amin(-1)
    right = valid[..., 42:66].amin(-1)
    front = torch.minimum(valid[..., :6].amin(-1), valid[..., 66:72].amin(-1))
    back = valid[..., 30:42].amin(-1)

    fwd = angle.abs() <= math.pi / 2
    e_rev = torch.where(angle > 0, angle - math.pi, angle + math.pi)
    err = torch.where(fwd, angle, e_rev)

    repulse = torch.where(torch.minimum(left, right) < 0.22,
                          torch.where(left < right, -1.0, 1.0), 0.0)
    steer = torch.clamp(3.0 * err + 1.0 * repulse, -1.0, 1.0)
    mag = torch.clamp(1.0 - 0.5 * err.abs(), 0.3, 1.0)
    clear = torch.where(fwd, front, back)
    mag = torch.where(clear < 0.2, 0.35, mag)
    mag = torch.where(dist < 0.3, 0.45, mag)
    speed = torch.where(fwd, mag, -mag)
    return torch.stack([speed, steer], dim=-1)


def make_env(args, device):
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    return make_ackermann_env(
        env_type="maze", maze_id=args.maze,
        max_linear_velocity=args.max_velocity,
        max_angular_velocity=args.max_angular,
        max_episode_steps=args.max_episode_steps,
        spawn_heading_noise=args.spawn_heading_noise,
        collision_ignores_nohit=True, device=device)


def jax_core(env, name, episodes):
    """The JAX script's episodes of arena ``name`` as a ``reset_core``
    batch of the port's env."""
    with np.load(os.path.join(DRAWS_DIR,
                              f"scripted_seed{SEED}_{name}.npz")) as d:
        d = {k: torch.from_numpy(d[k][:episodes]).to(env.device)
             for k in d.files}
    return env.maze_core(d["start_xy"], d["goal_xy"], d["goal_cell"],
                         d.get("yaw"))


def card(device):
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--max-velocity", type=float, default=1.5)
    p.add_argument("--max-angular", type=float, default=1.0)
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--maze", default="PointMaze_UMaze-v3")
    p.add_argument("--max-episode-steps", type=int, default=1000,
                   help="episode budget (500 Hz steps; 1000 = the "
                        "reference's 2 s)")
    p.add_argument("--spawn-heading-noise", type=float, default=0.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--out", default=None, help="write the results as JSON")
    return p


def main(argv=None):
    from mujoco_playground_tpu_torch.device import resolve_device
    from mujoco_playground_tpu_torch.rl.evaluate import evaluate_agent
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    env = make_env(args, device)
    name = ARENAS.get((args.maze, args.spawn_heading_noise))
    if name is None:
        raise SystemExit(f"no JAX draws for {args.maze} with heading noise "
                         f"{args.spawn_heading_noise}: {sorted(ARENAS)}")
    t0 = time.perf_counter()
    stats = evaluate_agent(env, scripted_policy, num_episodes=args.episodes,
                           core=jax_core(env, name, args.episodes))
    secs = time.perf_counter() - t0
    where = card(device)
    print(f"max_velocity={args.max_velocity} max_angular={args.max_angular} "
          f"episodes={args.episodes}")
    for k, v in stats.items():
        print(f"  {k}: {v:.3f}")
    result = dict(stats, seconds=secs)
    ref = JAX_RATES[name]
    sd = math.sqrt(ref * (1 - ref) / args.episodes)
    result.update(jax_success_rate=ref, binomial_sd=sd,
                  bound_3sd=[ref - 3 * sd, ref + 3 * sd],
                  within_3sd=bool(abs(stats["success_rate"] - ref)
                                  <= 3 * sd))
    print(f"  the JAX script's figure (PARITY.md) {ref:.3f}, 3 binomial SDs "
          f"at n={args.episodes}: +-{3 * sd:.3f}; within: "
          f"{result['within_3sd']}")
    print(f"{args.episodes} x {args.max_episode_steps} steps in {secs:.2f} s "
          f"({where})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(arena=name, flags=vars(args), card=where,
                           protocol="rl.evaluate.evaluate_agent, "
                           f"{args.episodes} parallel episodes, the "
                           f"scripted policy, max {args.max_episode_steps} "
                           "steps, collision_ignores_nohit=True, default "
                           "solver; the JAX script's episodes "
                           "(PRNGKey(7))",
                           scored_by="scripts/torch_scripted_ceiling.py",
                           eval=result), f, indent=2)
        print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
