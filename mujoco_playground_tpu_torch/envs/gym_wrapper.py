"""Gymnasium-compatible wrappers (port of the JAX package's
``envs/gym_wrapper.py``): the drop-in API of the reference envs.

The reference exposes ``AckermannRobotEnv(gym.Env)`` /
``AckermannGymnasiumMazeEnv(gym.Env)`` (src/rl/envs/).  These wrappers put
the same Gymnasium face (reset/step -> numpy, spaces, info dict with the
reference's keys: map_name/goal_position/start_position/step/velocities/
goal_distance/collision/min_lidar) on the port's env, so existing
SB3/Gymnasium user code of the JAX package ports by changing one import.

:class:`GymAckermannEnv` steps one env through the per-env API
(``AckermannEnv.step``, plain PyTorch); :class:`GymVectorAckermannEnv`
steps the batch through ``step_autoreset_batch`` (kernel K1 on the card,
K2 at reset).  Both keep their state on the env's device and hand numpy to
the caller.  gymnasium is optional: without it the wrappers keep their API
on a plain ``object`` base, with no spaces.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

try:
    import gymnasium as gym
    from gymnasium import spaces
    from gymnasium.vector import VectorEnv
    from gymnasium.vector.utils import batch_space
    from gymnasium.vector.vector_env import AutoresetMode
    _BASE = gym.Env
    _VBASE = VectorEnv
except ImportError:
    _BASE = object
    _VBASE = object
    spaces = None

from mujoco_playground_tpu_torch.envs.ackermann_env import (AckermannEnv,
                                                            EnvConfig,
                                                            EnvState,
                                                            _unbatch1)


def _host_all(*tensors):
    """Tensors as numpy arrays.  From the card, each is copied into fresh
    page-locked host memory without blocking and the stream is waited on
    once: one synchronization and DMA-rate copies, where a ``.cpu()`` per
    tensor waits once each and copies through pageable memory."""
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


class GymAckermannEnv(_BASE):
    """Single-env Gymnasium view of :class:`AckermannEnv`.

    Matches the reference observation/action spaces (Box(79,), Box(2,) —
    ackermann_env.py:94-108) and info keys.  ``reset(seed=)`` seeds the
    reset draw's ``torch.Generator``; with no seed the seed moves on by
    one, so each reset draws a new episode.
    """

    metadata = {"render_modes": ["human"], "render_fps": 50}

    def __init__(self, env: Optional[AckermannEnv] = None,
                 maze_id: Optional[str] = None,
                 config: EnvConfig = EnvConfig(),
                 render_mode: Optional[str] = None, device=None):
        self.env = env or AckermannEnv(maze_id=maze_id, config=config,
                                       device=device)
        self.render_mode = render_mode
        if spaces is not None:
            self.observation_space = spaces.Box(
                low=-np.inf, high=np.inf, shape=(self.env.obs_size,),
                dtype=np.float32)
            self.action_space = spaces.Box(
                low=-1.0, high=1.0, shape=(self.env.action_size,),
                dtype=np.float32)
        self._generator = torch.Generator(device=self.env.device)
        self._state: Optional[EnvState] = None
        self._viewer = None
        self._rng_seed = 0

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng_seed = seed
        else:
            self._rng_seed += 1
        self._generator.manual_seed(self._rng_seed)
        self._state = _unbatch1(self.env.reset(1, generator=self._generator))
        info = {
            "map_name": self.env.scene.name,
            "goal_position": _host_all(self._state.goal)[0].tolist(),
            "start_position": [0.0, 0.0],
        }
        if self.render_mode == "human":
            self._sync_viewer()
        return _host_all(self._state.obs.float())[0], info

    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        self._state = self.env.step(self._state, torch.from_numpy(action))
        s = self._state
        cfg = self.env.config
        info = {
            "step": int(s.steps),
            "linear_velocity": float(action[0] * cfg.max_linear_velocity),
            "angular_velocity": float(action[1] * cfg.max_angular_velocity),
            "goal_distance": float(s.goal_distance),
            "collision": bool(s.collision),
            "min_lidar": float(s.min_lidar),
        }
        if self.render_mode == "human":
            self._sync_viewer()
        return (_host_all(s.obs.float())[0], float(s.reward),
                bool(s.terminated), bool(s.truncated), info)

    # ------------------------------------------------------------- rendering
    def _sync_viewer(self):
        """Mirror the port's state into a MuJoCo passive viewer (optional:
        needs mujoco and a display; without them rendering turns off)."""
        try:
            viewer = self._ensure_viewer()
        except Exception as e:  # no mujoco, no GL, no display
            print(f"(viewer unavailable: {e}; rendering off)")
            self.render_mode = None
            return
        import mujoco
        self._mj_data.qpos[:], self._mj_data.qvel[:] = _host_all(
            self._state.physics.qpos, self._state.physics.qvel)
        mujoco.mj_forward(self._mj_model, self._mj_data)
        viewer.sync()

    def _ensure_viewer(self):
        if self._viewer is not None:
            return self._viewer
        import mujoco
        import mujoco.viewer

        from mujoco_playground_tpu_torch.spec.mjcf import to_mjcf
        from mujoco_playground_tpu_torch.spec.robot import ackermann_robot_v2
        self._mj_model = mujoco.MjModel.from_xml_string(
            to_mjcf(ackermann_robot_v2(), self.env.scene))
        self._mj_data = mujoco.MjData(self._mj_model)
        self._viewer = mujoco.viewer.launch_passive(self._mj_model,
                                                    self._mj_data)
        return self._viewer

    def render(self):
        if self.render_mode == "human":
            self._sync_viewer()

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None


class GymVectorAckermannEnv(_VBASE):
    """``gymnasium.vector.VectorEnv`` over the batched fast path.

    Implements the Gymnasium 1.x vector contract in SAME_STEP autoreset
    mode: when an episode ends, the returned observation is the next
    episode's first observation and the terminal observation/info arrive in
    ``info["final_obs"]`` / ``info["final_info"]`` with their ``_`` masks
    (the convention gymnasium's own SyncVectorEnv uses for this mode), only
    on steps where some env is done; ``metadata["autoreset_mode"]``
    advertises it.  Spaces follow the single/batched space split
    (``batch_space``).

    ``reset(seed=)`` seeds the vector env's ``torch.Generator``, which draws
    the reset batch and, every step, the auto-reset spawns (a reset with no
    seed reuses the last one, as the JAX wrapper's does); the env's own
    generator is left alone.
    """

    metadata = ({"autoreset_mode": AutoresetMode.SAME_STEP}
                if spaces is not None else {})

    def __init__(self, num_envs: int, env: Optional[AckermannEnv] = None,
                 maze_id: Optional[str] = None,
                 config: EnvConfig = EnvConfig(), seed: int = 0,
                 device=None):
        self.env = env or AckermannEnv(maze_id=maze_id, config=config,
                                       device=device)
        self.num_envs = num_envs
        if spaces is not None:
            self.single_observation_space = spaces.Box(
                low=-np.inf, high=np.inf, shape=(self.env.obs_size,),
                dtype=np.float32)
            self.single_action_space = spaces.Box(
                low=-1.0, high=1.0, shape=(self.env.action_size,),
                dtype=np.float32)
            self.observation_space = batch_space(
                self.single_observation_space, num_envs)
            self.action_space = batch_space(self.single_action_space,
                                            num_envs)
        self._generator = torch.Generator(device=self.env.device)
        self._seed = seed
        self._states: Optional[EnvState] = None

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._seed = seed
        self._generator.manual_seed(self._seed)
        self._states = self.env.reset(self.num_envs,
                                      generator=self._generator)
        return _host_all(self._states.obs.float())[0], {}

    def step(self, actions):
        actions = torch.as_tensor(np.asarray(actions, np.float32),
                                  device=self.env.device)
        fresh = self.env.reset_core(self.num_envs, self._generator)
        self._states = self.env.step_autoreset_batch(self._states, actions,
                                                     fresh=fresh)
        return self.to_host(self._states)

    @staticmethod
    def to_host(s: EnvState):
        """A stepped batch as the vector contract's numpy ``(obs, reward,
        terminated, truncated, info)``: the device-to-host copies of a
        step, one synchronization (two on a step where an env ends, for
        ``final_obs``)."""
        obs, reward, terminated, truncated, done, goal_distance, collision = (
            _host_all(s.obs.float(), s.reward, s.terminated, s.truncated,
                      s.done, s.goal_distance, s.collision))
        info = {"goal_distance": goal_distance, "collision": collision}
        if done.any():
            info["final_obs"] = _host_all(s.final_obs.float())[0]
            info["final_info"] = {
                "goal_distance": goal_distance,
                "collision": collision,
                "_goal_distance": done,
                "_collision": done,
            }
            info["_final_obs"] = done
            info["_final_info"] = done
        return obs, reward, terminated, truncated, info

    def close_extras(self, **kwargs):
        pass
