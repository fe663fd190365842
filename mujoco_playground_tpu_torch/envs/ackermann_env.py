"""Ackermann goal-navigation environment over batches of lockstep envs.

Port of the JAX package's ``envs/ackermann_env.py`` main path: the 79-d
observation (72 lidar beams + [x, y, heading] + [dx, dy, dist, angle]), the
2-d action in [-1, 1], the reward (-0.1 * goal distance - 0.01 per step, +100
at the goal, the collision penalty when the nearest beam is closer than the
threshold), the 1000-step truncation and the branchless auto-reset.  The
solved-task knobs: geodesic progress shaping (``geodesic_reward_scale``),
the goal compass (``goal_compass``, two more observation columns) and a
random spawn heading (``spawn_heading_noise``).

Everything is batched: the leaves of an :class:`EnvState` carry a leading
env axis.  One env step is one launch of kernel K1 (``ops/step.py``) with
the lidar, observation, reward and the auto-reset spawn scan fused in (K1e
under domain randomization, ``envs/domain_randomization.py``); the batched
reset takes its observation from kernel K2 (``ops/lidar.py``).  With a
compat contact manifold (``reference_flat_manifold`` /
``reference_wheel_patch``) the step is the staged step through kernel K3,
and the observation comes from K2.  Under ``spawn_heading_noise`` the
auto-reset observes the merged state through K2 (K1's fused spawn scan
bakes the template's heading).  The geodesic lookups of the shaping and the
compass are plain torch ops beside the kernels (``envs/geodesic.py``).
Reset sampling draws from the env's ``torch.Generator``.
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
from mujoco_playground_tpu_torch.envs import geodesic
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.physics import engine
from mujoco_playground_tpu_torch.physics.mathutil import quat_mul, quat_to_yaw
from mujoco_playground_tpu_torch.physics.model import Model, make_model
from mujoco_playground_tpu_torch.physics.state import State, make_state
from mujoco_playground_tpu_torch.spec.robot import ackermann_robot_v2
from mujoco_playground_tpu_torch.spec.scene import (SceneSpec,
                                                    open_floor_scene,
                                                    pointmaze_scene)

N_BEAMS = 72
OBS_SIZE = 79
ACTION_SIZE = 2
GEO_RES = 0.05      # the geodesic fields' grid spacing (m)


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


# the ROADMAP.md item that ports the configurations this port does not run
# yet
_COMPAT_ITEM = "Queue 1, item 1 'Reference-compat knobs'"
_STAGED_DR_ITEM = "Queue 1, item 2 'Staged DR fallback'"


def _check_ported(config: EnvConfig):
    if config.reference_delayed_obs:
        raise NotImplementedError(
            f"EnvConfig.reference_delayed_obs is not ported yet (ROADMAP.md "
            f"{_COMPAT_ITEM})")
    if config.physics_substeps != 1:
        raise NotImplementedError(
            f"physics_substeps > 1 is not ported yet (ROADMAP.md "
            f"{_COMPAT_ITEM})")


@dataclasses.dataclass
class EnvState:
    """Batched env state (leaves carry a leading env axis)."""
    physics: State
    odom_ref: OdometryRef
    goal: torch.Tensor                # (B, 2) goal in the odometry frame
    steps: torch.Tensor               # (B,) int32
    obs: torch.Tensor                 # (B, obs_size) next observation
    final_obs: torch.Tensor           # (B, obs_size) pre-reset observation
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


def rotate_spawn(template: State, th) -> State:
    """The settle template turned by yaw ``th`` (B,) about its chassis
    origin, one pose per env: ``qpos[3:7]``, ``qvel[0:2]``, ``xpos[1:]``
    and ``xquat[1:]`` (physics is invariant under a rotation about z, as
    under the xy shift a reset adds)."""
    zero = torch.zeros_like(th)
    qz = torch.stack([torch.cos(th / 2), zero, zero, torch.sin(th / 2)], -1)
    c, s = torch.cos(th), torch.sin(th)
    ctr = template.xpos[1]
    rel = template.xpos[1:] - ctr
    rot = torch.stack([rel[:, 0] * c[:, None] - rel[:, 1] * s[:, None],
                       rel[:, 0] * s[:, None] + rel[:, 1] * c[:, None],
                       rel[:, 2].expand(th.shape[0], -1)], dim=-1)
    v0, v1 = template.qvel[0], template.qvel[1]
    out = _expand(template, th.shape[0])
    out.qpos[:, 3:7] = quat_mul(qz, template.qpos[3:7])
    out.qvel[:, 0:2] = torch.stack([v0 * c - v1 * s, v0 * s + v1 * c], -1)
    out.xpos[:, 1:] = ctr + rot
    out.xquat[:, 1:] = quat_mul(qz[:, None], template.xquat[1:])
    return out


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
        if ((config.geodesic_reward_scale or config.goal_compass)
                and self.arena == "maze"):
            # packed (K, H, W, 3) = [phi, dphi/dx, dphi/dy]: one bilinear
            # lookup per position serves the shaping and the compass
            fields, origin = geodesic.build_fields(scene, GEO_RES)
            grad = geodesic.build_grad_fields(fields, GEO_RES)
            self._geo_pack = torch.as_tensor(
                np.concatenate([fields[..., None], grad], axis=-1),
                device=self.device)
            self._geo_origin = torch.as_tensor(origin, device=self.device)
        else:
            self._geo_pack = None
        self.obs_size = OBS_SIZE + (2 if config.goal_compass else 0)
        tw, tx, ty, tz = self._template.xquat[1].double().cpu().numpy()
        self._heading0 = float(
            np.arctan2(2 * (tw * tz + tx * ty), 1 - 2 * (ty * ty + tz * tz)))
        t = self._template
        self._fresh_statics_cache = (
            tuple(tuple(float(v) for v in row) for row in t.xpos.cpu()),
            tuple(tuple(float(v) for v in row) for row in t.xquat.cpu()),
            (float(t.qpos[0]), float(t.qpos[1])))

    # ------------------------------------------------------------------ reset
    def reset_core(self, num_envs: int,
                   generator: Optional[torch.Generator] = None) -> EnvState:
        """A batch of fresh states without their observation (obs fields
        are zero placeholders): start and goal cells (start != goal) with
        +-cell_noise cell noise in a maze, a random goal on the open
        floor.  Under ``spawn_heading_noise`` each maze spawn is also
        turned by a yaw drawn uniformly from +-spawn_heading_noise.  Draws
        from ``generator`` (default: the env's own)."""
        B, dtype, dev = num_envs, self.dtype, self.device
        g = self.generator if generator is None else generator
        if self.arena == "maze":
            n = self._free_cells.shape[0]
            gi = torch.randint(0, n, (B,), generator=g, device=dev)
            si = torch.randint(0, n - 1, (B,), generator=g, device=dev)
            si = si + (si >= gi).to(si.dtype)      # uniform over cells != gi
            c = self.config.cell_noise
            noise = (torch.rand((B, 4), generator=g, device=dev, dtype=dtype)
                     * (2 * c) - c)
            cell = self.scene.cell_size
            lim = self.config.spawn_heading_noise
            yaw = (torch.rand(B, generator=g, device=dev, dtype=dtype)
                   * (2 * lim) - lim) if lim else None
            return self.maze_core(self._free_cells[si] + noise[:, :2] * cell,
                                  self._free_cells[gi] + noise[:, 2:] * cell,
                                  gi, yaw)
        lo, hi = self.config.goal_distance_range
        u = torch.rand((B, 2), generator=g, device=dev, dtype=dtype)
        dist = lo + (hi - lo) * u[:, 0]
        ang = 2 * math.pi * u[:, 1]
        goal = torch.stack([dist * torch.cos(ang), dist * torch.sin(ang)],
                           dim=-1)
        return self._core(_expand(self._template, B), goal,
                          torch.zeros(B, dtype=torch.int32, device=dev))

    def maze_core(self, start_xy, goal_xy, goal_cell, yaw=None) -> EnvState:
        """Maze spawns at given draws, without their observation: the
        settled template turned by ``yaw`` (B,) about its chassis origin
        (``rotate_spawn``; None keeps the template's heading) and moved to
        ``start_xy`` (B, 2); the goal at world ``goal_xy`` (B, 2) in free
        cell ``goal_cell`` (B,).  ``reset_core`` draws them; a caller may
        pass another sampler's (such as the JAX package's evaluation
        draws)."""
        tpl = self._template
        B = start_xy.shape[0]
        physics = _expand(tpl, B) if yaw is None else rotate_spawn(tpl, yaw)
        physics.qpos[:, 0:2] = start_xy
        physics.xpos[:, 1:, 0:2] += (start_xy - tpl.qpos[0:2])[:, None, :]
        physics = physics.replace(
            time=torch.zeros(B, dtype=self.dtype, device=self.device))
        return self._core(physics, goal_xy - physics.xpos[:, 1, :2],
                          goal_cell.to(torch.int32))

    def _core(self, physics: State, goal, goal_cell) -> EnvState:
        """A fresh EnvState batch at ``physics`` with ``goal`` in the
        odometry frame (obs fields are zero placeholders)."""
        B, dtype, dev = goal.shape[0], self.dtype, self.device
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
              core: Optional[EnvState] = None,
              generator: Optional[torch.Generator] = None) -> EnvState:
        """A batch of fresh states with their observation.  ``core`` (a
        ``reset_core`` batch, e.g. another sampler's) skips the sampling;
        ``generator`` replaces the env's own for it.  The lidar comes from
        kernel K2 on the spawn frames."""
        if core is None:
            core = self.reset_core(num_envs, generator)
        obs, metrics = self._observe_batch(
            core.physics, core.odom_ref, core.goal,
            geo_vec=self._geo_eval(core.goal_cell,
                                   core.physics.xpos[:, 1, :2]))
        return core.replace(obs=obs, final_obs=obs, **metrics)

    # ---------------------------------------------------------------- compass
    def _geo_eval(self, goal_cell, xy):
        """One bilinear lookup of the packed field: (..., 3) = [phi,
        dphi/dx, dphi/dy] (None when no field is built)."""
        if self._geo_pack is None:
            return None
        return geodesic.sample_vec(self._geo_pack, self._geo_origin, GEO_RES,
                                   goal_cell, xy)

    def _compass_from(self, grad, heading, goal_vec):
        """(cos, sin) of the geodesic descent direction in the robot frame.

        ``grad`` is the sampled field gradient (None on the open floor);
        where it vanishes (a goal cell's center) the straight-line goal
        direction takes over."""
        if grad is None:
            d = goal_vec
        else:
            d = torch.where(
                torch.linalg.norm(grad, dim=-1, keepdim=True) > 1e-4,
                -grad, goal_vec)
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                            min=1e-6)
        c, s = torch.cos(heading), torch.sin(heading)
        return torch.stack([c * d[..., 0] + s * d[..., 1],
                            -s * d[..., 0] + c * d[..., 1]],
                           dim=-1).to(self.dtype)

    def _compass(self, xy, heading, goal_cell, goal_vec):
        """The compass at a position (samples the packed field)."""
        geo = self._geo_eval(goal_cell, xy)
        return self._compass_from(None if geo is None else geo[..., 1:3],
                                  heading, goal_vec)

    def _geo_delta(self, prev_phys: State, goal_cell, geo_new):
        """The geodesic shaping term, ``scale * (phi(prev) - phi(new))``
        from the pre-step chassis xy and the post-step packed sample
        ``geo_new`` (0.0 when the knob is off).  No carried state: it
        telescopes within an episode, and the done step shapes against its
        own episode's goal cell."""
        scale = self.config.geodesic_reward_scale
        if self._geo_pack is None or not scale:
            return 0.0
        phi_p = self._geo_eval(goal_cell, prev_phys.xpos[:, 1, :2])[..., 0]
        return (scale * (phi_p - geo_new[..., 0])).to(self.dtype)

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
        # the compass and the shaping ride outside the kernel, on one
        # packed sample at the stepped chassis xy
        geo_new = self._geo_eval(states.goal_cell, physics.xpos[:, 1, :2])
        if cfg.goal_compass:
            goal_vec = states.goal - (physics.xpos[:, 1, :2]
                                      - states.odom_ref.position[:, :2])
            obs = torch.cat([obs, self._compass_from(
                None if geo_new is None else geo_new[..., 1:3],
                slab[:, ns + 2], goal_vec)], dim=-1)
        reward = slab[:, ns + 7] + self._geo_delta(
            states.physics, states.goal_cell, geo_new)
        terminated = slab[:, ns + 11] > 0.5
        steps = states.steps + 1
        truncated = (steps >= cfg.max_episode_steps) & ~terminated
        goal_distance = slab[:, ns + 8]
        new = states.replace(
            physics=physics, obs=obs, final_obs=obs,
            reward=reward, steps=steps, terminated=terminated,
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
        geo_new = self._geo_eval(states.goal_cell, physics.xpos[:, 1, :2])
        obs, metrics = self._observe_batch(physics, states.odom_ref,
                                           states.goal, geo_vec=geo_new)
        goal_distance = metrics["goal_distance"]
        collision = metrics["collision"]
        terminated = goal_distance < cfg.goal_distance_threshold
        reward = reward_terms(cfg, goal_distance, collision, terminated,
                              states.prev_goal_distance).to(self.dtype)
        reward = reward + self._geo_delta(states.physics, states.goal_cell,
                                          geo_new)
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
        which K1 scans in the same launch as the step; the staged step, and
        any step under ``spawn_heading_noise`` (K1's spawn scan bakes the
        template's heading), observe the merged state through K2 instead.
        ``models``/``base_model``: domain randomization, as in
        :meth:`step_batch` (resets use the base model)."""
        B = states.steps.shape[0]
        if fresh is None:
            fresh = self.reset_core(B)
        if self.config.spawn_heading_noise:
            if models is not None:
                # the merged state's observation needs each env's own model
                # (a randomized plane_z), which K2 does not take
                raise NotImplementedError(
                    f"domain randomization with spawn_heading_noise needs "
                    f"the staged DR fallback's per-env observation, which "
                    f"is not ported yet (ROADMAP.md {_STAGED_DR_ITEM})")
            st, fresh_lidar = self.step_batch(states, actions), None
        else:
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
            obs, _ = self._observe_batch(
                merged.physics, merged.odom_ref, merged.goal,
                geo_vec=self._geo_eval(merged.goal_cell,
                                       merged.physics.xpos[:, 1, :2]))
            return merged.replace(obs=obs, **keep)
        g = fresh.goal
        heading0 = torch.full((B,), self._heading0, dtype=self.dtype,
                              device=self.device)
        ang = torch.atan2(g[:, 1], g[:, 0]) - self._heading0
        ang = torch.atan2(torch.sin(ang), torch.cos(ang))
        cols = [fresh_lidar,
                torch.zeros((B, 2), dtype=self.dtype, device=self.device),
                heading0[:, None], g, fresh.prev_goal_distance[:, None],
                ang[:, None]]
        if self.config.goal_compass:
            cols.append(self._compass(fresh.physics.xpos[:, 1, :2], heading0,
                                      fresh.goal_cell, g))
        fresh_obs = torch.cat(cols, dim=-1)
        return merged.replace(
            obs=torch.where(done[:, None], fresh_obs, st.obs), **keep)

    # ------------------------------------------------------------------- obs
    def _observe_batch(self, physics: State, ref: OdometryRef, goal,
                       geo_vec=None):
        """Observation and metrics of a batch, with the lidar from K2;
        ``geo_vec`` (``_geo_eval`` at the chassis xy) feeds the compass."""
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
        cols = [lidar,
                torch.stack([pos_diff[:, 0], pos_diff[:, 1], heading], dim=-1),
                torch.stack([goal_vec[:, 0], goal_vec[:, 1], goal_distance,
                             goal_angle], dim=-1)]
        if cfg.goal_compass:
            cols.append(self._compass_from(
                None if geo_vec is None else geo_vec[..., 1:3], heading,
                goal_vec))
        obs = torch.cat(cols, dim=-1).to(self.dtype)
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
