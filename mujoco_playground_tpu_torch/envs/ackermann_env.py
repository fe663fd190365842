"""Ackermann goal-navigation environment over batches of lockstep envs.

Port of the JAX package's ``envs/ackermann_env.py`` main path: the 79-d
observation (72 lidar beams + [x, y, heading] + [dx, dy, dist, angle]), the
2-d action in [-1, 1], the reward (-0.1 * goal distance - 0.01 per step, +100
at the goal, the collision penalty when the nearest beam is closer than the
threshold), the 1000-step truncation and the branchless auto-reset.

Everything is batched: the leaves of an :class:`EnvState` carry a leading
env axis.  One env step is one launch of kernel K1 (``ops/step.py``) with
the lidar, observation, reward and the auto-reset spawn scan fused in (K1e
under domain randomization, ``envs/domain_randomization.py``); the batched
reset takes its observation from kernel K2 (``ops/lidar.py``).  With a
compat contact manifold (``reference_flat_manifold`` /
``reference_wheel_patch``) the step is the staged step through kernel K3,
and the observation comes from K2.  Reset sampling draws from the env's
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from mujoco_playground_tpu_torch.core.controller import \
    bicycle_cmd_vel_to_controls
from mujoco_playground_tpu_torch.core.odometry import OdometryRef
from mujoco_playground_tpu_torch.device import resolve_device
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.physics import engine
from mujoco_playground_tpu_torch.physics.mathutil import quat_to_yaw
from mujoco_playground_tpu_torch.physics.model import Model, make_model
from mujoco_playground_tpu_torch.physics.state import State, make_state
from mujoco_playground_tpu_torch.spec.robot import ackermann_robot_v2
from mujoco_playground_tpu_torch.spec.scene import (SceneSpec,
                                                    open_floor_scene,
                                                    pointmaze_scene)

N_BEAMS = 72
OBS_SIZE = 79
ACTION_SIZE = 2


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Env hyperparameters (the JAX package's ``EnvConfig``)."""
    max_episode_steps: int = 1000
    goal_distance_threshold: float = 0.5
    collision_threshold: float = 0.15
    max_linear_velocity: float = 1.0
    max_angular_velocity: float = 1.0
    goal_distance_range: tuple = (2.0, 8.0)   # open-floor goal sampling
    cell_noise: float = 0.25                  # maze start/goal xy noise
    reference_lidar_aliasing: bool = False
    collision_ignores_nohit: bool = False
    reference_delayed_obs: bool = False
    physics_substeps: int = 1
    progress_reward_scale: float = 0.0
    reference_flat_manifold: bool = False
    reference_wheel_patch: bool = False
    geodesic_reward_scale: float = 0.0
    goal_compass: bool = False
    spawn_heading_noise: float = 0.0
    collision_penalty: float = -50.0


# configurations this port does not run yet, and the ROADMAP.md item that
# ports them
_UNPORTED = (
    ("reference_delayed_obs", "Queue 1, 'Solved-task and compat knobs'"),
    ("spawn_heading_noise", "Queue 1, 'Solved-task and compat knobs'"),
    ("goal_compass", "Queue 1, 'Solved-task and compat knobs'"),
    ("geodesic_reward_scale", "Queue 1, 'Solved-task and compat knobs'"),
)


def _check_ported(config: EnvConfig):
    for name, item in _UNPORTED:
        if getattr(config, name):
            raise NotImplementedError(
                f"EnvConfig.{name} is not ported yet (ROADMAP.md {item})")
    if config.physics_substeps != 1:
        raise NotImplementedError(
            "physics_substeps > 1 is not ported yet (ROADMAP.md Queue 1, "
            "'Solved-task and compat knobs')")


@dataclasses.dataclass
class EnvState:
    """Batched env state (leaves carry a leading env axis)."""
    physics: State
    odom_ref: OdometryRef
    goal: torch.Tensor                # (B, 2) goal in the odometry frame
    steps: torch.Tensor               # (B,) int32
    obs: torch.Tensor                 # (B, 79) next observation
    final_obs: torch.Tensor           # (B, 79) pre-reset observation
    reward: torch.Tensor
    terminated: torch.Tensor          # bool
    truncated: torch.Tensor           # bool
    done: torch.Tensor                # bool
    goal_distance: torch.Tensor
    collision: torch.Tensor           # bool
    min_lidar: torch.Tensor
    prev_goal_distance: torch.Tensor  # the progress-shaping potential
    goal_cell: torch.Tensor           # (B,) int32 goal cell index

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


def _map2(fn, a, b):
    """Apply ``fn`` leafwise to two dataclass trees of tensors."""
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    return dataclasses.replace(a, **{
        f.name: _map2(fn, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)})


def select_done(done, fresh, stepped):
    """Where ``done``, the fresh leaf, else the stepped one."""
    d = done.reshape(done.shape + (1,) * (fresh.dim() - done.dim()))
    return torch.where(d, fresh, stepped)


def _rows(t):
    """(B, ...) -> batch-last (rows, B), contiguous."""
    return t.reshape(t.shape[0], -1).T.contiguous()


def reward_terms(cfg, goal_distance, collision, terminated,
                 prev_goal_distance):
    """The env reward (the fused step computes the same formula in K1)."""
    return (-goal_distance * 0.1
            + torch.where(terminated, 100.0, 0.0)
            + torch.where(collision, cfg.collision_penalty, 0.0)
            - 0.01
            + cfg.progress_reward_scale
            * (prev_goal_distance - goal_distance))


class AckermannEnv:
    """The compiled environment: holds the model, the settled spawn
    template and the reset generator."""

    obs_size = OBS_SIZE
    action_size = ACTION_SIZE

    def __init__(self, scene: Optional[SceneSpec] = None,
                 maze_id: Optional[str] = None,
                 config: EnvConfig = EnvConfig(),
                 dtype=torch.float32,
                 solver_iterations: int = 8,
                 ls_iterations: int = 6,
                 device=None, seed: int = 0):
        _check_ported(config)
        self.config = config
        self.device = resolve_device(device)
        if maze_id is not None:
            scene = pointmaze_scene(maze_id)
        if scene is None:
            scene = open_floor_scene()
        self.scene = scene
        self.arena = "maze" if len(scene.free_cells) else "simple"
        self.dtype = dtype
        self.model: Model = make_model(
            ackermann_robot_v2(), scene, dtype=dtype,
            solver_iterations=solver_iterations, ls_iterations=ls_iterations,
            compat_flat_manifold=config.reference_flat_manifold,
            compat_wheel_patch=config.reference_wheel_patch,
            device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        qpos = self.model.qpos0.clone()
        if self.arena == "maze":
            # settle once at the origin with the chassis spawned 0.055 above
            # the floor (the reference's mj_forward + 3 settling steps); a
            # reset reuses the result at an xy offset, as physics is
            # translation-invariant in x/y
            qpos[2] = scene.floor_z + 0.055
            st = _batch1(make_state(self.model, qpos=qpos))
            for _ in range(3):
                st = engine.step_batch(self.model, st, ws_compare=True)
            self._template = _unbatch1(st)
            self._free_cells = torch.as_tensor(
                np.asarray(scene.free_cells), dtype=dtype, device=self.device)
        else:
            # the open floor drops the robot from z = 0.1 with no settling
            qpos[2] = 0.1
            self._template = make_state(self.model, qpos=qpos)
            self._free_cells = None
        tw, tx, ty, tz = self._template.xquat[1].double().cpu().numpy()
        self._heading0 = float(
            np.arctan2(2 * (tw * tz + tx * ty), 1 - 2 * (ty * ty + tz * tz)))
        t = self._template
        self._fresh_statics_cache = (
            tuple(tuple(float(v) for v in row) for row in t.xpos.cpu()),
            tuple(tuple(float(v) for v in row) for row in t.xquat.cpu()),
            (float(t.qpos[0]), float(t.qpos[1])))

    # ------------------------------------------------------------------ reset
    def reset_core(self, num_envs: int) -> EnvState:
        """A batch of fresh states without their observation (obs fields
        are zero placeholders): start and goal cells (start != goal) with
        +-cell_noise cell noise in a maze, a random goal on the open
        floor."""
        B, dtype, dev, g = num_envs, self.dtype, self.device, self.generator
        tpl = self._template
        if self.arena == "maze":
            n = self._free_cells.shape[0]
            gi = torch.randint(0, n, (B,), generator=g, device=dev)
            si = torch.randint(0, n - 1, (B,), generator=g, device=dev)
            si = si + (si >= gi).to(si.dtype)      # uniform over cells != gi
            c = self.config.cell_noise
            noise = (torch.rand((B, 4), generator=g, device=dev, dtype=dtype)
                     * (2 * c) - c)
            cell = self.scene.cell_size
            start_xy = self._free_cells[si] + noise[:, :2] * cell
            goal_xy = self._free_cells[gi] + noise[:, 2:] * cell
            qpos = tpl.qpos.expand(B, -1).clone()
            qpos[:, 0:2] = start_xy
            xpos = tpl.xpos.expand(B, -1, -1).clone()
            xpos[:, 1:, 0:2] += (start_xy - tpl.qpos[0:2])[:, None, :]
            physics = State(
                qpos=qpos, qvel=tpl.qvel.expand(B, -1).clone(),
                ctrl=tpl.ctrl.expand(B, -1).clone(),
                time=torch.zeros(B, dtype=dtype, device=dev), xpos=xpos,
                xquat=tpl.xquat.expand(B, -1, -1).clone(),
                qacc_warmstart=tpl.qacc_warmstart.expand(B, -1).clone())
            goal = goal_xy - xpos[:, 1, :2]
            goal_cell = gi.to(torch.int32)
        else:
            physics = _expand(tpl, B)
            lo, hi = self.config.goal_distance_range
            u = torch.rand((B, 2), generator=g, device=dev, dtype=dtype)
            dist = lo + (hi - lo) * u[:, 0]
            ang = 2 * math.pi * u[:, 1]
            goal = torch.stack([dist * torch.cos(ang), dist * torch.sin(ang)],
                               dim=-1)
            goal_cell = torch.zeros(B, dtype=torch.int32, device=dev)
        ref = OdometryRef(position=physics.xpos[:, 1].clone(),
                          quat=physics.xquat[:, 1].clone())
        zero = torch.zeros(B, dtype=dtype, device=dev)
        false = torch.zeros(B, dtype=torch.bool, device=dev)
        obs0 = torch.zeros((B, self.obs_size), dtype=dtype, device=dev)
        return EnvState(
            physics=physics, odom_ref=ref, goal=goal,
            steps=torch.zeros(B, dtype=torch.int32, device=dev), obs=obs0,
            final_obs=obs0, reward=zero, terminated=false, truncated=false,
            done=false, goal_distance=zero, collision=false, min_lidar=zero,
            prev_goal_distance=torch.linalg.norm(goal, dim=-1).to(dtype),
            goal_cell=goal_cell)

    def reset(self, num_envs: Optional[int] = None,
              core: Optional[EnvState] = None) -> EnvState:
        """A batch of fresh states with their observation.  ``core`` (a
        ``reset_core`` batch, e.g. another sampler's) skips the sampling.
        The lidar comes from kernel K2 on the spawn frames."""
        if core is None:
            core = self.reset_core(num_envs)
        obs, metrics = self._observe_batch(core.physics, core.odom_ref,
                                           core.goal)
        return core.replace(obs=obs, final_obs=obs, **metrics)

    # ------------------------------------------------------------------- step
    def _env_statics(self):
        """The env constants of the fused observation and reward."""
        cfg = self.config
        return (float(cfg.collision_threshold),
                float(cfg.goal_distance_threshold),
                float(cfg.progress_reward_scale),
                bool(cfg.reference_lidar_aliasing),
                bool(cfg.collision_ignores_nohit),
                float(cfg.collision_penalty))

    def _fresh_statics(self):
        """The settled template's frames and chassis xy, for the fused
        auto-reset spawn scan (a fresh pose is the template shifted in
        xy)."""
        return self._fresh_statics_cache

    def step_batch(self, states: EnvState, actions, models=None,
                   base_model=None, _fresh_xy=None):
        """One env step of the batch.  ``_fresh_xy`` (from
        ``step_autoreset_batch``): each env's fresh spawn xy; the return
        is then ``(EnvState, fresh_lidar)`` with the spawn scan fused into
        the same launch (``fresh_lidar`` is None on the staged step, which
        observes through K2 instead).  ``models``/``base_model``: domain
        randomization, the randomized leaves with a leading env axis and
        the unbatched base model (``engine.step_batch``)."""
        cfg = self.config
        model = self.model if models is None else models
        actions = torch.clamp(actions.to(self.dtype), -1.0, 1.0)
        ctrl = bicycle_cmd_vel_to_controls(
            actions[..., 0] * cfg.max_linear_velocity,
            actions[..., 1] * cfg.max_angular_velocity)
        physics = states.physics.replace(ctrl=ctrl)
        if engine.is_compat(self.model):
            return self._step_staged(states, physics, model, base_model,
                                     _fresh_xy)
        cols = [states.odom_ref.position[:, :2], states.goal,
                states.prev_goal_distance[:, None]]
        if _fresh_xy is not None:
            cols.append(_fresh_xy)
        env_in = torch.cat(cols, dim=-1).to(self.dtype)
        physics, slab = engine.step_batch(
            model, physics, base_model=base_model,
            with_env=self._env_statics(), env_in=env_in,
            with_fresh=(self._fresh_statics() if _fresh_xy is not None
                        else None))
        ns = self.model.nsite
        obs = slab[:, :ns + 7]
        terminated = slab[:, ns + 11] > 0.5
        steps = states.steps + 1
        truncated = (steps >= cfg.max_episode_steps) & ~terminated
        goal_distance = slab[:, ns + 8]
        new = states.replace(
            physics=physics, obs=obs, final_obs=obs,
            reward=slab[:, ns + 7], steps=steps, terminated=terminated,
            truncated=truncated, done=terminated | truncated,
            goal_distance=goal_distance, collision=slab[:, ns + 10] > 0.5,
            min_lidar=slab[:, ns + 9], prev_goal_distance=goal_distance)
        if _fresh_xy is not None:
            return new, slab[:, ns + 12:]
        return new

    def _step_staged(self, states, physics, model, base_model, fresh_xy):
        """The env step without the fused step: the staged physics step,
        then the observation, reward and termination through K2."""
        cfg = self.config
        physics = engine.step_batch(model, physics, base_model=base_model)
        obs, metrics = self._observe_batch(physics, states.odom_ref,
                                           states.goal)
        goal_distance = metrics["goal_distance"]
        collision = metrics["collision"]
        terminated = goal_distance < cfg.goal_distance_threshold
        reward = reward_terms(cfg, goal_distance, collision, terminated,
                              states.prev_goal_distance).to(self.dtype)
        steps = states.steps + 1
        truncated = (steps >= cfg.max_episode_steps) & ~terminated
        new = states.replace(
            physics=physics, obs=obs, final_obs=obs, reward=reward,
            steps=steps, terminated=terminated, truncated=truncated,
            done=terminated | truncated, goal_distance=goal_distance,
            collision=collision, min_lidar=metrics["min_lidar"],
            prev_goal_distance=goal_distance)
        return (new, None) if fresh_xy is not None else new

    def step_autoreset_batch(self, states: EnvState, actions,
                             fresh: Optional[EnvState] = None, models=None,
                             base_model=None) -> EnvState:
        """One env step with branchless auto-reset: where the step ends an
        episode, the continuation (physics, obs, goal, counters) is a fresh
        reset, while the step's outcome (reward, done flags, info and
        ``final_obs``) is kept.

        ``fresh`` (a ``reset_core`` batch) replaces the sampling from the
        env's generator.  The fresh observation needs only the lidar at the
        spawn pose (odometry is zero and the heading is the template's),
        which K1 scans in the same launch as the step; the staged step
        observes the merged state through K2 instead.  ``models``/
        ``base_model``: domain randomization, as in :meth:`step_batch`
        (resets use the base model)."""
        B = states.steps.shape[0]
        if fresh is None:
            fresh = self.reset_core(B)
        st, fresh_lidar = self.step_batch(
            states, actions, models=models, base_model=base_model,
            _fresh_xy=fresh.physics.xpos[:, 1, :2])
        done = st.done
        merged = _map2(lambda f, s: select_done(done, f, s), fresh, st)
        keep = dict(reward=st.reward, terminated=st.terminated,
                    truncated=st.truncated, done=st.done,
                    final_obs=st.final_obs, goal_distance=st.goal_distance,
                    collision=st.collision, min_lidar=st.min_lidar)
        if fresh_lidar is None:
            obs, _ = self._observe_batch(merged.physics, merged.odom_ref,
                                         merged.goal)
            return merged.replace(obs=obs, **keep)
        g = fresh.goal
        heading0 = self._heading0
        ang = torch.atan2(g[:, 1], g[:, 0]) - heading0
        ang = torch.atan2(torch.sin(ang), torch.cos(ang))
        fresh_obs = torch.cat([
            fresh_lidar,
            torch.zeros((B, 2), dtype=self.dtype, device=self.device),
            torch.full((B, 1), heading0, dtype=self.dtype,
                       device=self.device),
            g, fresh.prev_goal_distance[:, None], ang[:, None]], dim=-1)
        return merged.replace(
            obs=torch.where(done[:, None], fresh_obs, st.obs), **keep)

    # ------------------------------------------------------------------- obs
    def _observe_batch(self, physics: State, ref: OdometryRef, goal):
        """Observation and metrics of a batch, with the lidar from K2."""
        cfg = self.config
        lidar = k2.lidar(self.model, _rows(physics.xpos),
                         _rows(physics.xquat)).T
        if cfg.reference_lidar_aliasing:
            lidar = torch.cat([lidar[:, 71:72].expand(-1, 10),
                               lidar[:, 10:]], dim=-1)
        pos_diff = physics.xpos[:, 1] - ref.position
        heading = quat_to_yaw(physics.xquat[:, 1])
        goal_vec = goal - pos_diff[:, :2]
        goal_distance = torch.linalg.norm(goal_vec, dim=-1)
        goal_angle = torch.atan2(goal_vec[:, 1], goal_vec[:, 0]) - heading
        goal_angle = torch.atan2(torch.sin(goal_angle), torch.cos(goal_angle))
        obs = torch.cat([
            lidar,
            torch.stack([pos_diff[:, 0], pos_diff[:, 1], heading], dim=-1),
            torch.stack([goal_vec[:, 0], goal_vec[:, 1], goal_distance,
                         goal_angle], dim=-1)], dim=-1).to(self.dtype)
        if cfg.collision_ignores_nohit:
            min_lidar = torch.where(lidar < 0, math.inf, lidar).amin(-1)
        else:
            min_lidar = lidar.amin(-1)
        return obs, dict(goal_distance=goal_distance,
                         collision=min_lidar < cfg.collision_threshold,
                         min_lidar=min_lidar)


def _batch1(s: State) -> State:
    return _map2(lambda a, _: a[None], s, s)


def _unbatch1(s: State) -> State:
    return _map2(lambda a, _: a[0], s, s)


def _expand(s: State, B: int) -> State:
    return _map2(lambda a, _: a.expand((B,) + a.shape).clone(), s, s)
