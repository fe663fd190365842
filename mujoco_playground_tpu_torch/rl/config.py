"""Single config surface for envs + training: the port's copy of the JAX
package's ``rl/config.py``, field for field (the port imports nothing of
the JAX package).  Defaults mirror the reference trainer's algorithm
defaults and env thresholds."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RLConfig:
    # Environment
    env_type: str = "simple"              # simple | maze | maze_flat
    maze_id: str = "PointMaze_UMaze-v3"
    max_episode_steps: int = 1000
    goal_distance_threshold: float = 0.5
    collision_threshold: float = 0.15
    max_linear_velocity: float = 1.0
    max_angular_velocity: float = 1.0
    # Reference-artifact fidelity (PARITY.md): stale-obs step semantics +
    # the f"lidar-{i}" sensor-name aliasing bug of the reference env.
    reference_compat: bool = False
    # sane-collision variant: no-hit beams (-1) do NOT count as collisions
    # (the reference counts them, PARITY.md "reference bugs" table)
    sane_collision: bool = False
    # potential-based progress shaping weight (0 = the faithful reference
    # reward; see EnvConfig.progress_reward_scale)
    progress_reward: float = 0.0
    # geodesic (maze-aware) potential shaping weight: like progress_reward
    # but the potential is Dijkstra distance through the maze corridors,
    # which has no off-goal local optimum behind walls (envs/geodesic.py).
    # The solved-task configs use this instead of progress_reward.
    geodesic_reward: float = 0.0
    # append the geodesic-descent direction (robot frame, 2 dims) to the
    # observation — the global-planner/local-policy split
    # (EnvConfig.goal_compass); obs grows 79 -> 81
    goal_compass: bool = False
    # uniform random spawn yaw in [-x, +x] rad (0 = the reference's fixed
    # template heading; pi = any heading — EnvConfig.spawn_heading_noise)
    spawn_heading_noise: float = 0.0
    # per-env randomized physics (mass/friction/damping/actuators/floor);
    # wraps the env in DomainRandomizedEnv -> kernel K1e
    domain_rand: bool = False

    # Reward weights (ackermann_env.py:287-301)
    distance_weight: float = -0.1
    goal_bonus: float = 100.0
    collision_penalty: float = -50.0
    step_penalty: float = -0.01

    # Vectorization (lockstep envs; the reference ran n_envs=1)
    num_envs: int = 4096
    unroll_length: int = 32               # T per rollout (n_steps per env)

    # Policy/value tower widths (reference checkpoint: 64x64 tanh).  Wider
    # towers help on the harder solved-task configs.
    hidden_sizes: Tuple[int, ...] = (64, 64)
    # SAC/TD3 tower widths (SB3's off-policy net_arch default: 256x256,
    # the architecture the committed off-policy checkpoints use).  The CLI
    # --hidden overrides this only when explicitly passed with
    # --algo sac/td3 (ADVICE r4: the flag used to be silently ignored).
    offpolicy_hidden_sizes: Tuple[int, ...] = (256, 256)

    # PPO (train.py:100-107)
    learning_rate: float = 3e-4
    num_minibatches: int = 32
    ppo_epochs: int = 10
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    anneal_lr: bool = False
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    normalize_advantage: bool = True
    # Minibatch shuffle granularity (rows of the flattened T*B batch moved
    # together).  1 = SB3-exact per-row reshuffle each epoch; the default
    # 128 shuffles 128-row blocks + a random roll that re-cuts block
    # boundaries every epoch (rl/ppo.py make_epoch_shuffle).  Values that
    # don't divide the minibatch size fall back to per-row.
    shuffle_block_size: int = 128
    # SB3 VecNormalize-equivalent running obs/reward scaling (off in the
    # reference's shipped run; the standard recipe for actually solving
    # this reward scale — collision -50/step vs distance -0.1/step)
    normalize_obs: bool = False
    normalize_reward: bool = False

    # SAC (train.py:108-114)
    sac_learning_rate: float = 3e-4
    sac_buffer_size: int = 100000
    sac_learning_starts: int = 1000
    sac_batch_size: int = 256
    sac_tau: float = 0.005

    # TD3 (train.py:115-121)
    td3_learning_rate: float = 3e-4
    td3_policy_noise: float = 0.2
    td3_noise_clip: float = 0.5
    td3_policy_delay: int = 2

    # Training cadence
    total_timesteps: int = 100_000
    eval_freq: int = 10_000
    eval_episodes: int = 10
    save_freq: int = 10_000
    log_dir: str = "rl_logs"
    seed: int = 0

    # Device/precision
    solver_iterations: int = 4
    ls_iterations: int = 3


default_config = RLConfig()
