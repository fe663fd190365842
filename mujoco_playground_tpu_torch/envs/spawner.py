"""Map spawners (port of the JAX package's ``envs/spawner.py``).

The reference has ``SimpleMapSpawner.load_random_environment`` returning a
freshly-compiled ``(model, data, map_name)`` per reset
(src/rl/envs/simple_map_spawner.py:22-54) and references a richer
``MapSpawner`` whose source is lost.  Here spawners return the
*compiled-once* model plus a fresh one-env state for the per-env step
(``physics.engine.step``): compilation never happens at reset time.  The
models live on ``device`` (``None`` = the CUDA card); ``MapSpawner``
draws its scene index from a ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mujoco_playground_tpu_torch.physics.model import Model, make_model
from mujoco_playground_tpu_torch.physics.state import State, make_state
from mujoco_playground_tpu_torch.spec.robot import ackermann_robot_v2
from mujoco_playground_tpu_torch.spec.scene import (maze_flat_scene,
                                                    open_floor_scene,
                                                    pointmaze_scene)


def _spawn_qpos(model: Model, robot_pos, robot_quat):
    qpos = model.qpos0.clone()
    qpos[0:3] = torch.as_tensor(robot_pos, dtype=model.dtype,
                                device=model.device)
    if robot_quat is not None:
        qpos[3:7] = torch.as_tensor(robot_quat, dtype=model.dtype,
                                    device=model.device)
    return qpos


class SimpleMapSpawner:
    """Bare-floor spawner (reference SimpleMapSpawner).  It draws nothing:
    ``seed`` is taken so that either spawner can stand for the other."""

    def __init__(self, dtype=torch.float32, device=None, seed: int = 0):
        self.scene = open_floor_scene()
        self.model: Model = make_model(ackermann_robot_v2(), self.scene,
                                       dtype=dtype, device=device)

    def load_random_environment(self, robot_pos=None, robot_quat=None
                                ) -> Tuple[Model, State, str]:
        """Returns (model, state, map_name); model is compiled once."""
        robot_pos = [0.0, 0.0, 0.1] if robot_pos is None else robot_pos
        qpos = _spawn_qpos(self.model, robot_pos, robot_quat)
        return self.model, make_state(self.model, qpos=qpos), "simple_floor"


class MapSpawner:
    """Multi-map spawner (restores the lost reference MapSpawner
    capability): a library of scenes compiled once, one drawn per call."""

    def __init__(self, maze_ids=("PointMaze_UMaze-v3", "PointMaze_Open-v3",
                                 "PointMaze_Medium-v3", "PointMaze_Large-v3"),
                 include_maze_flat: bool = True, dtype=torch.float32,
                 device=None, seed: int = 0):
        self.scenes = [pointmaze_scene(mid) for mid in maze_ids]
        if include_maze_flat:
            self.scenes.append(maze_flat_scene())
        spec = ackermann_robot_v2()
        self.models = [make_model(spec, sc, dtype=dtype, device=device)
                       for sc in self.scenes]
        # the index is read on the host, so it is drawn there
        self.generator = torch.Generator().manual_seed(seed)

    def load_random_environment(self, robot_pos=None, robot_quat=None
                                ) -> Tuple[Model, State, str]:
        idx = int(torch.randint(0, len(self.scenes), (),
                                generator=self.generator))
        scene = self.scenes[idx]
        model = self.models[idx]
        z = scene.floor_z + 0.055 if scene.floor_z != 0.0 else 0.1
        robot_pos = [0.0, 0.0, z] if robot_pos is None else robot_pos
        qpos = _spawn_qpos(model, robot_pos, robot_quat)
        return model, make_state(model, qpos=qpos), scene.name
