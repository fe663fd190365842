"""Training CLI: the port of the JAX package's ``rl/train.py``.

The same flags and defaults (--algo random/ppo/sac/td3, --maze,
--timesteps, --num-envs, --unroll, --normalize, --anneal-lr, --resume,
--eval-only, --profile, ...) plus --device: the CUDA card by default,
``cpu`` for the plain PyTorch versions of the kernels.  Without a CUDA
device the entry points raise unless the CPU is asked for.  Checkpoints
and ``metrics.jsonl`` land in ``<log-dir>/<algo>_torch/`` (``step_*.pt``;
``ppo_torch``, ``sac_torch``, ``td3_torch``), apart from the JAX trainer's
``<log-dir>/<algo>/``, so the two trainers can share a ``--log-dir``
without reading each other's files.

SAC and TD3 run at most 256 envs, 4 collect steps and 4 gradient steps
per iteration, in chunks of ~100,000 env steps with one host read-back
per chunk (``train_off_policy``).

Examples:
    python -m mujoco_playground_tpu_torch.rl.train --algo random --episodes 100
    python -m mujoco_playground_tpu_torch.rl.train --algo ppo --maze umaze \\
        --num-envs 4096 --normalize --anneal-lr
    python -m mujoco_playground_tpu_torch.rl.train --algo sac --maze umaze \\
        --num-envs 256 --progress-reward 3
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import math
import os
import time

import torch

from mujoco_playground_tpu_torch.device import resolve_device
from mujoco_playground_tpu_torch.envs import (DomainRandomizedEnv,
                                              make_ackermann_env)
from mujoco_playground_tpu_torch.rl import checkpoint as ckpt_lib
from mujoco_playground_tpu_torch.rl import ppo
from mujoco_playground_tpu_torch.rl import sac as sac_lib
from mujoco_playground_tpu_torch.rl import td3 as td3_lib
from mujoco_playground_tpu_torch.rl.config import RLConfig
from mujoco_playground_tpu_torch.rl.evaluate import (deterministic_policy,
                                                     evaluate_agent)
from mujoco_playground_tpu_torch.rl.networks import ActorCritic
from mujoco_playground_tpu_torch.rl.random_policy import run_random_baseline
from mujoco_playground_tpu_torch.utils.logging import MetricsLogger

OFFPOLICY_MAX_ENVS = 256    # SAC/TD3 envs (the JAX trainer's cap)
OFFPOLICY_LOG_STEPS = 100_000   # env steps per chunk (one read-back each)


def ckpt_subdir(algo: str) -> str:
    """The port's checkpoint directory of ``algo`` under --log-dir (the
    JAX trainer uses ``algo`` itself)."""
    return f"{algo}_torch"


CKPT_SUBDIR = ckpt_subdir("ppo")


def build_env(config: RLConfig, device=None):
    env = _build_base_env(config, device)
    if config.domain_rand:
        env = DomainRandomizedEnv(
            env, config.num_envs,
            torch.Generator(device=env.device).manual_seed(
                config.seed ^ 0x5EED))
    return env


def _build_base_env(config: RLConfig, device=None):
    return make_ackermann_env(
        env_type=config.env_type, maze_id=config.maze_id,
        max_linear_velocity=config.max_linear_velocity,
        max_angular_velocity=config.max_angular_velocity,
        goal_distance_threshold=config.goal_distance_threshold,
        max_episode_steps=config.max_episode_steps,
        reference_delayed_obs=config.reference_compat,
        reference_lidar_aliasing=config.reference_compat,
        collision_ignores_nohit=config.sane_collision,
        progress_reward_scale=config.progress_reward,
        geodesic_reward_scale=config.geodesic_reward,
        goal_compass=config.goal_compass,
        spawn_heading_noise=config.spawn_heading_noise,
        collision_penalty=config.collision_penalty,
        solver_iterations=config.solver_iterations,
        ls_iterations=config.ls_iterations,
        device=device, seed=config.seed)


def make_network(config: RLConfig, env) -> ActorCritic:
    """The policy, its weights drawn on the CPU from ``config.seed`` and
    moved to the env's device."""
    return ActorCritic(env.obs_size, env.action_size,
                       hidden=tuple(config.hidden_sizes),
                       generator=torch.Generator().manual_seed(config.seed)
                       ).to(env.device)


def train_ppo(config: RLConfig, resume: bool = False, verbose: bool = True,
              profile_dir: str = None, eval_only: bool = False,
              device=None, env=None):
    """The PPO loop.  Returns ``(ts, env, network)``; ``env`` (default: one
    built from ``config``) is the env it trains in.

    Step accounting is host-side Python ints; metrics are read back once
    per log group of ~1M env steps (never more iterations than
    ``total_timesteps`` has left), which is the loop's only host sync."""
    device = resolve_device(device)
    env = build_env(config, device) if env is None else env
    network = make_network(config, env)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    ts = ppo.init_train_state(env, network, config, generator)

    log_dir = os.path.join(config.log_dir, CKPT_SUBDIR)
    resume_gs = None
    if resume or eval_only:
        latest = ckpt_lib.latest_checkpoint(log_dir)
        if latest:
            # an evaluation needs only the policy (a policy-only file, such
            # as a JAX checkpoint carried across by interop, holds no more)
            restore = (ckpt_lib.restore_policy if eval_only
                       else ckpt_lib.restore_checkpoint)
            ts = restore(latest, ts)
            resume_gs = ckpt_lib.checkpoint_step(latest)
            if verbose:
                print(f"Resumed from {latest}")
        elif eval_only:
            raise SystemExit(f"--eval-only: no checkpoint under {log_dir}")
    if eval_only:
        # read-only: no training loop, no logger, no final save
        return ts, env, network
    logger = MetricsLogger(log_dir)
    train_step = ppo.make_train_step(env, config)

    steps_per_iter = config.num_envs * config.unroll_length
    # resume-aware counters: start from the restored step count so a
    # resumed run neither re-trains past its target nor floods saves/evals
    # while the cadence counters catch up
    start_gs = resume_gs if resume_gs is not None else ts.global_step
    gs = start_gs
    next_save = (start_gs // config.save_freq + 1) * config.save_freq
    next_eval = (start_gs // config.eval_freq + 1) * config.eval_freq

    if profile_dir:
        # warm up, then trace one full train step; both steps train and
        # count (gs), so the checkpoint name stays the true step count
        ts, _ = train_step(ts)
        from mujoco_playground_tpu_torch.utils.profiler import trace_context
        with trace_context(profile_dir):
            ts, _ = train_step(ts)
        gs += 2 * steps_per_iter
        if verbose:
            print(f"profiler trace written to {profile_dir}")

    log_interval = max(1, 1_000_000 // steps_per_iter)
    t_start = time.time()
    t0 = time.time()
    prev = copy.deepcopy(ckpt_lib.state_dict(ts))   # the last finite state
    while gs < config.total_timesteps:
        remaining = -(-(config.total_timesteps - gs) // steps_per_iter)
        group = min(log_interval, remaining)
        for _ in range(group):
            ts, metrics = train_step(ts)
        # the group's one read-back (it waits for the device)
        values = torch.stack([v.detach().float().reshape(())
                              for v in metrics.values()]).tolist()
        metrics = dict(zip(metrics, values))
        dt = (time.time() - t0) / group
        t0 = time.time()
        gs += steps_per_iter * group
        # Failure detection: if an update produced non-finite losses, drop
        # the group and continue from the last finite state; the
        # generators run on, so the next iteration draws afresh.
        if not all(math.isfinite(v) for v in metrics.values()):
            print(f"step {gs}: non-finite metrics {metrics}; "
                  f"rolling back to the last finite state")
            ts = ckpt_lib.load_state_dict(
                ts, copy.deepcopy(prev), generators=False).replace(
                    global_step=ts.global_step)
            continue
        prev = copy.deepcopy(ckpt_lib.state_dict(ts))
        metrics["steps_per_second"] = steps_per_iter / dt
        metrics["global_step"] = gs
        logger.log(gs, metrics)
        if verbose:
            print(f"step {gs:>10d} | {steps_per_iter/dt/1e3:8.1f}k sps | "
                  f"reward/step {metrics['mean_reward']:+8.3f} | "
                  f"eps {metrics['episodes_finished']:.0f} | "
                  f"success {metrics['successes']:.0f} | "
                  f"kl {metrics['approx_kl']:.4f}")
        if gs >= next_save:
            path = ckpt_lib.save_checkpoint(log_dir, ts, gs)
            next_save += config.save_freq
            if verbose:
                print(f"  checkpoint -> {path}")
        if gs >= next_eval:
            stats = evaluate_agent(
                env, deterministic_policy(
                    network, norm=ts.norm if config.normalize_obs else None),
                num_episodes=config.eval_episodes,
                generator=torch.Generator(device=device).manual_seed(gs))
            logger.log(gs, {f"eval/{k}": v for k, v in stats.items()})
            next_eval += config.eval_freq
            if verbose:
                print(f"  eval: return {stats['mean_return']:.1f} "
                      f"± {stats['std_return']:.1f}, "
                      f"success {stats['success_rate']*100:.1f}%")
    if verbose:
        total = time.time() - t_start
        ran = gs - start_gs                    # steps THIS run (post-resume)
        print(f"Done: {gs} steps ({ran} this run) in "
              f"{total:.1f}s ({ran/max(total, 1e-9)/1e3:.1f}k steps/s)")
    ckpt_lib.save_checkpoint(log_dir, ts, gs)
    return ts, env, network


def train_off_policy(config: RLConfig, algo: str, total_timesteps: int,
                     eval_episodes: int = 10, verbose: bool = True,
                     resume: bool = False, eval_only: bool = False,
                     device=None, env=None):
    """The SAC/TD3 loop (``algo`` "sac" or "td3"); returns ``(state,
    stats)``, the final evaluation's statistics.

    ``config.num_envs`` is capped at 256.  An iteration is 4 collect steps
    and 4 gradient steps (``4 * num_envs`` env steps); while the step count
    is below ``sac_learning_starts`` the iterations collect with uniform
    random actions, and run their gradient steps too, as the JAX loop's
    do.  Then chunks of ``OFFPOLICY_LOG_STEPS // steps_per_iter``
    iterations (the last one cut to the remaining budget) run with one
    host read-back each: ``mean_reward`` averaged over the chunk, every
    other metric its last value, ``steps_per_second`` the chunk's marginal
    rate.  The full train state (buffer included) is saved every
    ``save_freq`` env steps and at the end; ``--eval-only`` restores the
    latest checkpoint's policy, evaluates it and writes nothing."""
    config = dataclasses.replace(
        config, num_envs=min(config.num_envs, OFFPOLICY_MAX_ENVS))
    device = resolve_device(device)
    log_dir = os.path.join(config.log_dir, ckpt_subdir(algo))
    latest = (ckpt_lib.latest_checkpoint(log_dir)
              if resume or eval_only else None)
    if eval_only:
        if latest is None:
            raise SystemExit(f"--eval-only: no checkpoint under {log_dir}")
        # evaluate a checkpoint of any width, as the JAX package does
        hidden = sac_lib.actor_hidden_of(torch.load(
            latest, map_location="cpu", weights_only=True)["actor"])
        config = dataclasses.replace(config, offpolicy_hidden_sizes=hidden)
    env = build_env(config, device) if env is None else env
    mod = sac_lib if algo == "sac" else td3_lib
    init, make_step = (sac_lib.make_sac(env, config) if algo == "sac"
                       else td3_lib.make_td3(env, config))
    state = init()

    def evaluate(state):
        stats = evaluate_agent(env, mod.deterministic_policy(state),
                               num_episodes=eval_episodes)
        if verbose:
            print(f"[{algo}] eval: return {stats['mean_return']:.1f} "
                  f"± {stats['std_return']:.1f}, "
                  f"success {stats['success_rate']*100:.1f}%")
        return stats

    resume_gs = None
    if latest:
        restore = (ckpt_lib.restore_policy if eval_only
                   else ckpt_lib.restore_checkpoint)
        state = restore(latest, state)
        resume_gs = ckpt_lib.checkpoint_step(latest)
        if verbose:
            print(f"[{algo}] resumed from {latest}")
    if eval_only:
        # read-only: no training loop, no logger, no save
        return state, evaluate(state)
    warmup_step = make_step(random_actions=True)
    train_step = make_step(random_actions=False)
    logger = MetricsLogger(log_dir)

    steps_per_iter = 4 * config.num_envs
    log_every = max(1, min(OFFPOLICY_LOG_STEPS, total_timesteps)
                    // steps_per_iter)
    # the checkpoint's name is the authoritative step count
    start_gs = resume_gs if resume_gs is not None else state.global_step
    gs = start_gs
    next_save = (start_gs // config.save_freq + 1) * config.save_freq
    while gs < config.sac_learning_starts and gs < total_timesteps:
        state, _ = warmup_step(state)
        gs += steps_per_iter
    t0 = time.time()
    while gs < total_timesteps:
        # the final chunk is cut to the remaining budget, so the loop
        # overshoots --timesteps by at most steps_per_iter - 1
        niter = min(log_every,
                    -(-(total_timesteps - gs) // steps_per_iter))
        rewards = []
        for _ in range(niter):
            state, metrics = train_step(state)
            rewards.append(metrics["mean_reward"])
        metrics["mean_reward"] = torch.stack(rewards).mean()
        # the chunk's one read-back (it waits for the device)
        names = [k for k, v in metrics.items()
                 if isinstance(v, torch.Tensor)]
        values = torch.stack([metrics[k].detach().float().reshape(())
                              for k in names]).tolist()
        metrics = {**metrics, **dict(zip(names, values))}
        t1 = time.time()
        gs += steps_per_iter * niter
        # marginal rate over this chunk (the first chunk's includes the
        # warm-up's queued work)
        metrics["steps_per_second"] = (steps_per_iter * niter
                                       / max(t1 - t0, 1e-9))
        t0 = t1
        logger.log(gs, metrics)
        if verbose:
            print(f"[{algo}] step {gs:>9d} | "
                  f"reward/step {metrics['mean_reward']:+8.3f} | "
                  f"{metrics['steps_per_second']/1e3:7.1f}k sps")
        if gs >= next_save:
            path = ckpt_lib.save_checkpoint(log_dir, state, gs)
            next_save = (gs // config.save_freq + 1) * config.save_freq
            if verbose:
                print(f"  checkpoint -> {path}")
    ckpt_lib.save_checkpoint(log_dir, state, gs)
    return state, evaluate(state)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train Ackermann Robot RL Agent")
    p.add_argument("--algo", default="random",
                   choices=["random", "ppo", "sac", "td3"])
    p.add_argument("--episodes", type=int, default=1000,
                   help="episodes (for --algo random)")
    p.add_argument("--timesteps", type=int, default=100000)
    p.add_argument("--max-velocity", type=float, default=1.0)
    p.add_argument("--max-angular", type=float, default=1.0,
                   help="cmd_vel angular_z cap (rad/s).  The reference env "
                        "pins 1.0, which at speed caps the bicycle steering "
                        "angle near 8 deg (arctan(L*w/v)); raise it (e.g. "
                        "3.0) to let policies use the real steering "
                        "envelope")
    p.add_argument("--goal-threshold", type=float, default=0.5)
    p.add_argument("--max-episode-steps", type=int, default=1000,
                   help="episode truncation (physics steps at 500 Hz); the "
                        "reference pins 1000 = 2 s of sim time")
    p.add_argument("--maze", default=None,
                   choices=[None, "umaze", "open", "medium", "large"])
    p.add_argument("--maze-id", default="PointMaze_UMaze-v3")
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--save-freq", type=int, default=10000)
    p.add_argument("--eval-freq", type=int, default=10000)
    p.add_argument("--eval-episodes", type=int, default=10)
    p.add_argument("--num-envs", type=int, default=2048)
    p.add_argument("--unroll", type=int, default=32)
    p.add_argument("--minibatches", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--anneal-lr", action="store_true")
    p.add_argument("--hidden", type=int, nargs="+", default=None,
                   help="policy/value tower widths (default 64 64 for PPO, "
                        "the reference checkpoint's; 256 256 for SAC/TD3, "
                        "SB3's off-policy default)")
    p.add_argument("--reference-compat", action="store_true",
                   help="reproduce the reference env's artifacts exactly "
                        "(stale-obs stepping + lidar name-aliasing bug)")
    p.add_argument("--normalize", action="store_true",
                   help="SB3 VecNormalize-equivalent running obs + reward "
                        "normalization in the PPO learner")
    p.add_argument("--sane-collision", action="store_true",
                   help="no-hit lidar beams (-1) do NOT count as collisions")
    p.add_argument("--progress-reward", type=float, default=0.0,
                   metavar="SCALE",
                   help="potential-based progress shaping: reward += "
                        "SCALE*(d_prev - d_new) toward the goal")
    p.add_argument("--geodesic-reward", type=float, default=0.0,
                   metavar="SCALE",
                   help="maze-aware potential shaping through the corridors")
    p.add_argument("--goal-compass", action="store_true",
                   help="append the geodesic-descent direction to the "
                        "observation (obs 79 -> 81)")
    p.add_argument("--spawn-heading-noise", type=float, default=0.0,
                   metavar="RAD",
                   help="uniform random spawn yaw in [-RAD, +RAD]")
    p.add_argument("--collision-penalty", type=float, default=-50.0,
                   help="per-step reward when min lidar < 0.15 m")
    p.add_argument("--shuffle-block", type=int, default=128,
                   help="PPO minibatch shuffle granularity (rows moved "
                        "together; 1 = SB3-exact per-row reshuffle)")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--domain-rand", action="store_true",
                   help="per-env randomized physics (mass/friction/damping/"
                        "actuators/floor); runs kernel K1e")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true",
                   help="restore the latest checkpoint under --log-dir and "
                        "evaluate it (no training, nothing written)")
    p.add_argument("--log-dir", default="rl_logs")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of one train step "
                        "into DIR (a Chrome trace, trace.json)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain PyTorch versions)")
    return p


def config_from_args(args) -> RLConfig:
    return RLConfig(
        env_type="maze" if args.maze else "simple",
        maze_id=args.maze or args.maze_id,
        max_linear_velocity=args.max_velocity,
        max_angular_velocity=args.max_angular,
        goal_distance_threshold=args.goal_threshold,
        max_episode_steps=args.max_episode_steps,
        total_timesteps=args.timesteps,
        learning_rate=args.learning_rate or 3e-4,
        save_freq=args.save_freq, eval_freq=args.eval_freq,
        eval_episodes=args.eval_episodes,
        num_envs=args.num_envs, unroll_length=args.unroll,
        num_minibatches=args.minibatches, seed=args.seed,
        anneal_lr=args.anneal_lr, gamma=args.gamma, ent_coef=args.ent_coef,
        shuffle_block_size=args.shuffle_block,
        hidden_sizes=tuple(args.hidden) if args.hidden else (64, 64),
        offpolicy_hidden_sizes=(tuple(args.hidden) if args.hidden
                                else (256, 256)),
        normalize_obs=args.normalize, normalize_reward=args.normalize,
        reference_compat=args.reference_compat,
        sane_collision=args.sane_collision,
        progress_reward=args.progress_reward,
        geodesic_reward=args.geodesic_reward,
        goal_compass=args.goal_compass,
        spawn_heading_noise=args.spawn_heading_noise,
        collision_penalty=args.collision_penalty, log_dir=args.log_dir,
        domain_rand=args.domain_rand)


def main(argv=None):
    """The CLI; returns the final evaluation's statistics (``--algo
    ppo|sac|td3``)."""
    args = make_parser().parse_args(argv)
    config = config_from_args(args)
    if args.eval_only and args.algo == "random":
        raise SystemExit("--eval-only needs a checkpointing algo "
                         "(ppo/sac/td3)")
    if args.algo in ("sac", "td3"):
        config = dataclasses.replace(
            config, num_envs=min(config.num_envs, OFFPOLICY_MAX_ENVS))
    device = resolve_device(args.device)

    print("=" * 60)
    print("Ackermann Robot RL Training (PyTorch)")
    print("=" * 60)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    arena = config.maze_id if config.env_type == "maze" else "open floor"
    print(f"env: {config.env_type} ({arena})")
    env = build_env(config, device)
    print(f"obs ({env.obs_size},), act ({env.action_size},), "
          f"num_envs {config.num_envs}")
    print("=" * 60)

    if args.algo == "random":
        run_random_baseline(env, episodes=args.episodes, seed=args.seed)
    elif args.algo in ("sac", "td3"):
        _, stats = train_off_policy(config, args.algo, args.timesteps,
                                    eval_episodes=args.eval_episodes,
                                    resume=args.resume,
                                    eval_only=args.eval_only, device=device,
                                    env=env)
        return stats
    elif args.algo == "ppo":
        ts, env, network = train_ppo(config, resume=args.resume,
                                     profile_dir=args.profile,
                                     eval_only=args.eval_only, device=device,
                                     env=env)
        stats = evaluate_agent(
            env, deterministic_policy(
                network, norm=ts.norm if config.normalize_obs else None),
            num_episodes=args.eval_episodes)
        print("\nEvaluation Results:")
        print(f"  Mean Return: {stats['mean_return']:.2f} "
              f"± {stats['std_return']:.2f}")
        print(f"  Mean Episode Length: {stats['mean_length']:.1f}")
        print(f"  Success Rate: {stats['success_rate']*100:.1f}%")
        return stats


if __name__ == "__main__":
    main()
