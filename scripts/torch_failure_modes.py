"""Failure-mode analysis of a solved PPO policy on the port: the
counterpart of ``scripts/dev_failure_modes.py``.

Plays N deterministic episodes (one per env slot, no auto-reset, the
``evaluate_agent`` protocol) and classifies each one:

  * success            - reached the goal
  * stuck              - failed, slow on over 30% of its steps and a wall
                         within 0.4 m at the end (pressed against geometry)
  * timeout_progress   - failed, not stuck, and geodesically under half its
                         spawn distance at the end (ran out of budget)
  * lost               - failed, not stuck, not that much closer

with the JAX script's per-step collision and slow counters and its
start-cell x goal-cell ``pair_success`` matrix, and prints the JSON
summary (``--out`` also writes it, beside the card's name and power
limit).

    python3 scripts/torch_failure_modes.py --out rl_logs/solved/FAILURE_MODES_torch.json

It scores the committed ``rl_logs/solved/ppo_torch/*.pt`` with the run's
EVAL.json env flags on EVAL.json's own 512 episodes (``ppo_torch/eval_seed0.npz``, the JAX package's draws for
eval seed 0, which ``dev_failure_modes.py --seed 0`` plays too).  A
finished slot's final state is kept, as the JAX script's frozen slots
keep theirs.  Needs one CUDA card (or ``--device cpu`` with tiny
``--episodes``/``--max-episode-steps``).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# dev_failure_modes.py's thresholds
SLOW_SPEED = 0.05       # m/s: a step counts as slow below it
STUCK_SLOW_FRAC = 0.3   # stuck: slow on more than this share of its steps
STUCK_LIDAR = 0.4       # ... and the final min lidar under this (m)
CLOSER_FRAC = 0.5       # timeout_progress: final geodesic < this x spawn's


def classify(succ, length, slow, min_lidar, phi0, phi_n):
    """The four classes of per-episode numpy arrays, as boolean masks
    (``dev_failure_modes.py``'s rules)."""
    fail = ~succ
    stuck = fail & (slow > STUCK_SLOW_FRAC * length) & (min_lidar
                                                         < STUCK_LIDAR)
    closer = phi_n < CLOSER_FRAC * phi0
    return dict(success=succ, stuck=stuck,
                timeout_progress=fail & ~stuck & closer,
                lost=fail & ~stuck & ~closer)


def summarize(ep, cells, start_cell, goal_cell):
    """The JAX script's JSON summary of per-episode arrays ``ep``
    (succ, length, coll, slow, min_lidar, goal_distance, phi0, phi_n)."""
    succ, length = ep["succ"], ep["length"]
    classes = classify(succ, length, ep["slow"], ep["min_lidar"], ep["phi0"],
                       ep["phi_n"])
    fail = ~succ

    def mean(x, mask):
        return float(x[mask].mean()) if mask.any() else None

    out = {"episodes": int(succ.shape[0])}
    out.update({k: int(v.sum()) for k, v in classes.items()})
    out.update(
        succ_len_mean=mean(length, succ),
        fail_final_goal_dist_mean=mean(ep["goal_distance"], fail),
        fail_phi_frac_mean=mean(ep["phi_n"] / np.maximum(ep["phi0"], 1e-6),
                                fail),
        fail_collision_frac_mean=mean(ep["coll"] / np.maximum(length, 1),
                                      fail),
        fail_slow_frac_mean=mean(ep["slow"] / np.maximum(length, 1), fail),
        phi0_mean_fail=mean(ep["phi0"], fail),
        phi0_mean_succ=mean(ep["phi0"], succ))
    K = len(cells)
    mat_n = np.zeros((K, K), int)
    mat_s = np.zeros((K, K), int)
    for sc, gc, ok in zip(start_cell, goal_cell, succ):
        mat_n[sc, gc] += 1
        mat_s[sc, gc] += int(ok)
    out["cells"] = [list(map(float, c)) for c in cells]
    out["pair_success"] = [[f"{mat_s[i, j]}/{mat_n[i, j]}" for j in range(K)]
                           for i in range(K)]
    return out


@torch.no_grad()
def play(env, policy, states, steps):
    """The frozen-slot episode loop: per-episode numpy arrays of the
    success, length, collision and slow steps, and the final state's min
    lidar, goal distance and geodesic distance (phi)."""
    B, dev = states.obs.shape[0], states.obs.device
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    succ, length, coll, slow = finished.clone(), z, z.clone(), z.clone()
    last = dict(min_lidar=states.min_lidar, goal_distance=states.goal_distance,
                xy=states.physics.xpos[:, 1, :2])
    phi0 = env._geo_eval(states.goal_cell, last["xy"])[..., 0]
    for _ in range(steps):
        nxt = env.step_batch(states, policy(states.obs))
        live = ~finished
        succ = succ | (nxt.terminated & live)
        length = length + live.int()
        coll = coll + (nxt.collision & live).int()
        speed = torch.linalg.norm(nxt.physics.qvel[:, 0:2], dim=-1)
        slow = slow + ((speed < SLOW_SPEED) & live).int()
        finished = finished | nxt.done
        new = dict(min_lidar=nxt.min_lidar, goal_distance=nxt.goal_distance,
                   xy=nxt.physics.xpos[:, 1, :2])
        last = {k: torch.where(live.reshape((B,) + (1,) * (v.dim() - 1)),
                               new[k], v) for k, v in last.items()}
        states = nxt
    phi_n = env._geo_eval(states.goal_cell, last["xy"])[..., 0]
    np_ = lambda t: t.cpu().numpy()  # noqa: E731
    return dict(succ=np_(succ), length=np_(length), coll=np_(coll),
                slow=np_(slow), min_lidar=np_(last["min_lidar"]),
                goal_distance=np_(last["goal_distance"]), phi0=np_(phi0),
                phi_n=np_(phi_n))


def main(argv=None):
    from torch_solved_eval import card, eval_flags

    from mujoco_playground_tpu_torch.rl import ppo
    from mujoco_playground_tpu_torch.rl import train as train_lib
    from mujoco_playground_tpu_torch.rl.checkpoint import (latest_checkpoint,
                                                           restore_policy)
    from mujoco_playground_tpu_torch.rl.evaluate import deterministic_policy
    p = argparse.ArgumentParser()
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--max-episode-steps", type=int, default=None,
                   help="default: the run's EVAL.json budget")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    run_dir = os.path.join(ROOT, "rl_logs", "solved")
    with open(os.path.join(run_dir, "EVAL.json")) as f:
        env_block = json.load(f)["env"]
    steps = args.max_episode_steps or env_block["max_episode_steps"]
    cli = eval_flags(env_block) + [
        "--algo", "ppo", "--num-envs", str(args.episodes),
        "--max-episode-steps", str(steps)] + (
        ["--device", args.device] if args.device else [])
    config = train_lib.config_from_args(train_lib.make_parser().parse_args(
        cli))
    env = train_lib.build_env(config, args.device)
    net = train_lib.make_network(config, env)
    ts = ppo.init_train_state(env, net, config, torch.Generator(
        device=env.device).manual_seed(0), stagger_resets=False)
    ckpt = latest_checkpoint(os.path.join(run_dir, train_lib.CKPT_SUBDIR))
    ts = restore_policy(ckpt, ts)
    policy = deterministic_policy(net, norm=ts.norm)
    with np.load(os.path.join(run_dir, train_lib.CKPT_SUBDIR,
                              "eval_seed0.npz")) as d:
        d = {k: torch.from_numpy(d[k][:args.episodes]).to(env.device)
             for k in d.files}
    states = env.reset(core=env.maze_core(d["start_xy"], d["goal_xy"],
                                          d["goal_cell"]))
    cells = np.asarray(env.scene.free_cells)
    spawn = states.physics.xpos[:, 1, :2].cpu().numpy()
    start_cell = np.argmin(np.linalg.norm(spawn[:, None, :] - cells[None],
                                          axis=-1), axis=1)
    goal_cell = states.goal_cell.cpu().numpy()
    ep = play(env, policy, states, steps)
    out = summarize(ep, cells, start_cell, goal_cell)
    out["card"] = card() if env.device.type == "cuda" else "cpu"
    out["checkpoint"] = os.path.relpath(ckpt, ROOT)
    out["protocol"] = (f"{args.episodes} deterministic episodes of at most "
                       f"{steps} steps on EVAL.json's own episodes, the "
                       "run's EVAL.json env flags; "
                       "scripts/torch_failure_modes.py")
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
