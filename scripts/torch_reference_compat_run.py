"""The reference's published PPO learning dynamics, on the port: the
counterpart of ``scripts/reference_compat_run.py``.

The reference's shipped SB3 run trains ONE env on the open-floor arena
with n_steps=2048, batch 64, 10 epochs, lr 3e-4, gamma 0.99, lam 0.95,
clip 0.2, ent_coef 0.0, and its episode returns collapse from -129.5 +-
28.6 (at 10k steps) to -47,268 +- 35 (at 20k-30k): on the open floor
every lidar beam reads -1 (no hit), the reference env counts that as a
collision, and every step of every 1000-step episode pays -50.

This script runs the port's PPO under the same recipe with the
reference-artifact env flags on (``--reference-compat``: K1 ``<0,0,0>``
once and K2 twice a rollout step, at one env), rebuilds each episode's
return from the rollout stream (the analog of SB3's ``ep_info_buffer``),
and writes the JAX script's header, episode lines and summary to
``rl_logs/reference_compat/episodes_torch.jsonl`` (``--maze``: the walled
umaze arena, ``episodes_umaze_torch.jsonl``), beside the JAX package's
``episodes.jsonl`` and ``episodes_umaze.jsonl``, which it never writes.

    python3 scripts/torch_reference_compat_run.py            # the card
    python3 scripts/torch_reference_compat_run.py --maze
    python3 scripts/torch_reference_compat_run.py --device cpu \\
        --total-steps 64 --unroll-length 64 --out-dir /tmp/compat

``--total-steps`` and ``--unroll-length`` default to the recipe's
(65,536 and 2048).
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

TOTAL_STEPS = 65_536          # 32 iterations of 2048: 2x the reference's 30k
UNROLL = 2048
HEADER = {
    "recipe": "reference SB3 PPO (BASELINE.md row 'PPO run config')",
    "flags": {"reference_compat": True, "num_envs": 1, "n_steps": 2048,
              "batch": 64, "epochs": 10, "lr": 3e-4, "gamma": 0.99,
              "lam": 0.95, "clip": 0.2, "ent_coef": 0.0, "seed": 0},
    "baseline_anchor": {"10k": [-129.5, 28.6], "20k": [-47268, 35],
                        "30k": [-47269, 36]},
}


def compat_summary(returns, steps):
    """The JAX script's summary of the episodes' returns and end steps:
    mean, std and count within 5,000 steps of 10k, 20k and 30k, the mean
    after 15k and whether over 80% of those sit below -40,000."""
    rets, steps = np.asarray(returns), np.asarray(steps)
    summary = {}
    for anchor in (10_000, 20_000, 30_000):
        win = rets[(steps > anchor - 5000) & (steps <= anchor + 5000)]
        if len(win):
            summary[f"at_{anchor}"] = [float(win.mean()), float(win.std()),
                                       len(win)]
    late = rets[steps > 15_000]
    summary["late_mean"] = float(late.mean()) if len(late) else None
    summary["collapsed"] = bool(len(late) and (late < -40_000).mean() > 0.8)
    return summary


def recipe(maze, unroll, total_steps):
    from mujoco_playground_tpu_torch.rl.config import RLConfig
    return RLConfig(
        env_type="maze" if maze else "simple", reference_compat=True,
        num_envs=1, unroll_length=unroll, num_minibatches=32, ppo_epochs=10,
        learning_rate=3e-4, gamma=0.99, gae_lambda=0.95, clip_range=0.2,
        ent_coef=0.0, seed=0, total_timesteps=total_steps)


def episodes_of(rewards, dones, ep_ret, ep_len, gs):
    """Walks one rollout's rewards and done flags; returns the finished
    episodes and the carry (the open episode's return and length, the
    step count)."""
    done_eps = []
    for r, d in zip(rewards, dones):
        ep_ret += float(r)
        ep_len += 1
        gs += 1
        if d:
            done_eps.append({"global_step": gs, "episode_return": ep_ret,
                             "episode_length": ep_len})
            ep_ret, ep_len = 0.0, 0
    return done_eps, ep_ret, ep_len, gs


def run(maze=False, device=None, total_steps=TOTAL_STEPS, unroll=UNROLL,
        out_dir=None, iteration_hook=None):
    """Trains the recipe and writes the episodes file; returns its path
    and the summary.  ``iteration_hook(i, seconds)`` is called after each
    iteration."""
    from mujoco_playground_tpu_torch.device import resolve_device
    from mujoco_playground_tpu_torch.rl import ppo
    from mujoco_playground_tpu_torch.rl import train as train_lib
    device = resolve_device(device)
    config = recipe(maze, unroll, total_steps)
    env = train_lib.build_env(config, device)
    network = train_lib.make_network(config, env)
    ts = ppo.init_train_state(
        env, network, config,
        torch.Generator(device=device).manual_seed(config.seed),
        stagger_resets=False)
    step = ppo.make_train_step(env, config)
    out_dir = out_dir or os.path.join(ROOT, "rl_logs", "reference_compat")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "episodes_umaze_torch.jsonl" if maze
                        else "episodes_torch.jsonl")
    where = "cpu"
    if device.type == "cuda":
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    ep_ret, ep_len, gs, episodes = 0.0, 0, 0, []
    t0 = time.time()
    with open(path, "w") as f:
        f.write(json.dumps(dict(HEADER, port={
            "script": "scripts/torch_reference_compat_run.py",
            "arena": "umaze" if maze else "open floor", "card": where,
            "unroll": unroll, "total_steps": total_steps})) + "\n")
        i = 0
        while gs < total_steps:
            ti = time.time()
            ts, batch_data, _ = step.rollout_gae(ts)
            batch = batch_data[0]
            rew = batch["reward"].reshape(-1).double().cpu().numpy()
            done = batch["done"].reshape(-1).cpu().numpy() > 0
            ts, _ = step.update(ts, batch_data)
            new, ep_ret, ep_len, gs = episodes_of(rew, done, ep_ret, ep_len,
                                                  gs)
            for rec in new:
                f.write(json.dumps(rec) + "\n")
            episodes += new
            if iteration_hook is not None:
                iteration_hook(i, time.time() - ti)
            i += 1
            print(f"step {gs:>7d} | episodes {len(episodes)} | last returns: "
                  + " ".join(f"{e['episode_return']:.1f}"
                             for e in episodes[-3:]), flush=True)
        summary = compat_summary([e["episode_return"] for e in episodes],
                                 [e["global_step"] for e in episodes])
        secs = time.time() - t0
        f.write(json.dumps({"summary": summary, "seconds": secs,
                            "card": where}) + "\n")
    print("summary:", json.dumps(summary, indent=1))
    print(f"wrote {path} ({secs:.0f} s, {where})")
    return path, summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--maze", action="store_true",
                   help="the walled umaze arena instead of the open floor")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--total-steps", type=int, default=TOTAL_STEPS)
    p.add_argument("--unroll-length", type=int, default=UNROLL)
    p.add_argument("--out-dir", default=None,
                   help="default: rl_logs/reference_compat")
    args = p.parse_args(argv)
    return run(args.maze, args.device, args.total_steps, args.unroll_length,
               args.out_dir)


if __name__ == "__main__":
    main()
