"""Env factory: ``make_ackermann_env`` and ``list_available_mazes`` (port
of the JAX package's ``envs/make_env.py``)."""
from __future__ import annotations

import torch

from mujoco_playground_tpu_torch.envs.ackermann_env import (AckermannEnv,
                                                            EnvConfig)
from mujoco_playground_tpu_torch.spec.scene import (  # noqa: F401
    list_available_mazes,
    maze_flat_scene,
    pointmaze_scene,
)


def make_ackermann_env(env_type: str = "maze",
                       maze_id: str = "PointMaze_UMaze-v3",
                       max_linear_velocity: float = 0.5,
                       max_angular_velocity: float = 1.0,
                       goal_distance_threshold: float = 0.3,
                       max_episode_steps: int = 1000,
                       dtype=torch.float32,
                       maze_map=None,
                       device=None,
                       seed: int = 0,
                       **kwargs) -> AckermannEnv:
    """Create an Ackermann navigation env on ``device`` (``None`` = the CUDA
    card; pass ``"cpu"`` for the plain kernel twins).

    ``env_type``: 'maze' (a PointMaze arena), 'simple' (open floor) or
    'maze_flat' (the 38-obstacle grid).  ``seed`` seeds the reset
    generator.  ``**kwargs``: EnvConfig fields, plus ``solver_iterations``
    and ``ls_iterations``; unknown names raise.
    """
    env_kwargs = {k: kwargs.pop(k) for k in ("solver_iterations",
                                             "ls_iterations") if k in kwargs}
    unknown = [k for k in kwargs if k not in EnvConfig.__annotations__]
    if unknown:
        raise TypeError(f"make_ackermann_env: unknown kwargs {unknown}")
    config = EnvConfig(
        max_linear_velocity=max_linear_velocity,
        max_angular_velocity=max_angular_velocity,
        goal_distance_threshold=goal_distance_threshold,
        max_episode_steps=max_episode_steps, **kwargs)
    common = dict(config=config, dtype=dtype, device=device, seed=seed,
                  **env_kwargs)
    if env_type == "maze":
        return AckermannEnv(scene=pointmaze_scene(maze_id, maze_map=maze_map),
                            **common)
    if env_type == "simple":
        return AckermannEnv(**common)
    if env_type == "maze_flat":
        return AckermannEnv(scene=maze_flat_scene(), **common)
    raise ValueError(f"Unknown env_type {env_type!r} (expected 'maze', "
                     f"'simple', or 'maze_flat')")
