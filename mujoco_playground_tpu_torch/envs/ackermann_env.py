"""Ackermann goal-navigation environment over batches of lockstep envs.

Port of the JAX package's ``envs/ackermann_env.py`` main path: the 79-d
observation (72 lidar beams + [x, y, heading] + [dx, dy, dist, angle]), the
2-d action in [-1, 1], the reward (-0.1 * goal distance - 0.01 per step, +100
at the goal, the collision penalty when the nearest beam is closer than the
threshold), the 1000-step truncation and the branchless auto-reset.  The
solved-task knobs: geodesic progress shaping (``geodesic_reward_scale``),
the goal compass (``goal_compass``, two more observation columns) and a
random spawn heading (``spawn_heading_noise``).

The batched API's :class:`EnvState` leaves carry a leading env axis.  One
env step is one launch of kernel K1 (``ops/step.py``) with the lidar,
observation, reward and the auto-reset spawn scan fused in (K1e
under domain randomization, ``envs/domain_randomization.py``); the batched
reset takes its observation from kernel K2 (``ops/lidar.py``).  With a
compat contact manifold (``reference_flat_manifold`` /
``reference_wheel_patch``) the step is the staged step through kernel K3,
and the observation comes from K2.  Under ``spawn_heading_noise`` the
auto-reset observes the merged state through K2 (K1's fused spawn scan
bakes the template's heading).  The reference-compat knobs:
``physics_substeps`` runs K1 without the env (``<0,0,0>``) for every
substep but the last; ``reference_delayed_obs`` observes the pre-step
physics through K2, and its auto-reset observes a whole fresh batch.
Under domain randomization off the fused step, the observation takes each
env's own model (``_scan_batch``).  The geodesic lookups of the shaping and
the compass are plain torch ops beside the kernels (``envs/geodesic.py``).
Reset sampling draws from the env's ``torch.Generator``.

``step`` and ``step_autoreset`` step one env (unbatched leaves), as the JAX
package's per-env functions do: the per-env physics step and raycast in
plain PyTorch on the env's device.
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
from mujoco_playground_tpu_torch.physics import engine, raycast, sensors
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
                   generator: Optional[torch.Generator] = None,
                   rows: slice = slice(None)) -> EnvState:
        """A batch of fresh states without their observation (obs fields
        are zero placeholders): start and goal cells (start != goal) with
        +-cell_noise cell noise in a maze, a random goal on the open
        floor.  Under ``spawn_heading_noise`` each maze spawn is also
        turned by a yaw drawn uniformly from +-spawn_heading_noise.  Draws
        from ``generator`` (default: the env's own).

        ``rows`` (a slice of ``range(num_envs)``, a rank's share of a
        sharded batch) builds only those envs: the draws are still made
        for all ``num_envs``, in the same order and shapes, so the
        generator moves as one process's does and the rows are bitwise
        that process's."""
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
            gi, si, noise = gi[rows], si[rows], noise[rows]
            yaw = None if yaw is None else yaw[rows]
            return self.maze_core(self._free_cells[si] + noise[:, :2] * cell,
                                  self._free_cells[gi] + noise[:, 2:] * cell,
                                  gi, yaw)
        lo, hi = self.config.goal_distance_range
        u = torch.rand((B, 2), generator=g, device=dev, dtype=dtype)[rows]
        B = u.shape[0]
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

    def _geo_delta(self, prev_phys: State, new_phys: State, goal_cell,
                   geo_new=None):
        """The geodesic shaping term, ``scale * (phi(prev) - phi(new))``
        from the pre- and post-step chassis xy (0.0 when the knob is off).
        ``geo_new``: the post-step packed sample, where the caller has it
        (the compass shares it).  No carried state: it telescopes within an
        episode, and the done step shapes against its own episode's goal
        cell.  One env or a batch."""
        scale = self.config.geodesic_reward_scale
        if self._geo_pack is None or not scale:
            return 0.0
        phi_p = self._geo_eval(goal_cell, prev_phys.xpos[..., 1, :2])[..., 0]
        if geo_new is None:
            geo_new = self._geo_eval(goal_cell, new_phys.xpos[..., 1, :2])
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

    def step(self, state: EnvState, action, model=None) -> EnvState:
        """One env step of one env (unbatched leaves): the per-env physics
        step (``engine.step``, plain PyTorch; it makes MuJoCo's warm-start
        pick, as the staged step does) ``physics_substeps`` times, then the
        observation, reward and termination from the per-env scan
        (``_observe``).  ``model``: this env's own model (domain
        randomization)."""
        cfg = self.config
        model = self.model if model is None else model
        action = torch.clamp(torch.as_tensor(action, dtype=self.dtype,
                                             device=self.device), -1.0, 1.0)
        ctrl = bicycle_cmd_vel_to_controls(
            action[0] * cfg.max_linear_velocity,
            action[1] * cfg.max_angular_velocity)
        physics = state.physics.replace(ctrl=ctrl)
        for _ in range(cfg.physics_substeps):
            physics = engine.step(model, physics)
        obs_src = state.physics if cfg.reference_delayed_obs else physics
        geo_obs = self._geo_eval(state.goal_cell, obs_src.xpos[..., 1, :2])
        obs, metrics = self._observe(obs_src, state.odom_ref, state.goal,
                                     model=model, geo_vec=geo_obs)
        return self._outcome(
            state, physics, obs, metrics,
            self._geo_delta(state.physics, physics, state.goal_cell,
                            None if cfg.reference_delayed_obs else geo_obs))

    def step_autoreset(self, state: EnvState, action,
                       fresh: Optional[EnvState] = None) -> EnvState:
        """``step`` with the branchless auto-reset of one env: where the
        step ends the episode, the continuation is ``fresh`` (one env's
        ``reset_core`` state, observed here; default: drawn from the env's
        generator), while the step's outcome is kept."""
        st = self.step(state, action)
        if fresh is None:
            fresh = _unbatch1(self.reset_core(1))
        obs, metrics = self._observe(
            fresh.physics, fresh.odom_ref, fresh.goal,
            geo_vec=self._geo_eval(fresh.goal_cell,
                                   fresh.physics.xpos[..., 1, :2]))
        fresh = fresh.replace(obs=obs, final_obs=obs, **metrics)
        merged = _map2(lambda f, s: select_done(st.done, f, s), fresh, st)
        return merged.replace(**_outcome_fields(st))

    def _outcome(self, states, physics, obs, metrics, geo_delta):
        """The stepped state from an observation of it: reward,
        termination, truncation, and the shaping potential."""
        cfg = self.config
        goal_distance = metrics["goal_distance"]
        collision = metrics["collision"]
        terminated = goal_distance < cfg.goal_distance_threshold
        reward = reward_terms(cfg, goal_distance, collision, terminated,
                              states.prev_goal_distance).to(self.dtype)
        steps = states.steps + 1
        truncated = (steps >= cfg.max_episode_steps) & ~terminated
        return states.replace(
            physics=physics, obs=obs, final_obs=obs,
            reward=reward + geo_delta, steps=steps, terminated=terminated,
            truncated=truncated, done=terminated | truncated,
            goal_distance=goal_distance, collision=collision,
            min_lidar=metrics["min_lidar"], prev_goal_distance=goal_distance)

    def step_batch(self, states: EnvState, actions, models=None,
                   base_model=None, _fresh_xy=None):
        """One env step of the batch.  ``_fresh_xy`` (from
        ``step_autoreset_batch``): each env's fresh spawn xy; the return
        is then ``(EnvState, fresh_lidar)`` with the spawn scan fused into
        the same launch (``fresh_lidar`` is None off the fused step).
        ``models``/``base_model``: domain randomization, the randomized
        leaves with a leading env axis and the unbatched base model
        (``engine.step_batch``).

        ``physics_substeps`` steps run K1 without the env (``<0,0,0>``)
        but the last, which fuses the observation unless
        ``reference_delayed_obs`` observes the pre-step physics instead.
        Off the fused step (delayed obs, the staged step), the observation
        comes from ``_observe_batch``: kernel K2, with each env's floor
        height under domain randomization."""
        cfg = self.config
        model = self.model if models is None else models
        actions = torch.clamp(actions.to(self.dtype), -1.0, 1.0)
        ctrl = bicycle_cmd_vel_to_controls(
            actions[..., 0] * cfg.max_linear_velocity,
            actions[..., 1] * cfg.max_angular_velocity)
        physics = states.physics.replace(ctrl=ctrl)
        slab = None
        for i in range(cfg.physics_substeps):
            if i == cfg.physics_substeps - 1 and not cfg.reference_delayed_obs:
                cols = [states.odom_ref.position[:, :2], states.goal,
                        states.prev_goal_distance[:, None]]
                if _fresh_xy is not None:
                    cols.append(_fresh_xy)
                env_in = torch.cat(cols, dim=-1).to(self.dtype)
                physics, slab = engine.step_batch(
                    model, physics, base_model=base_model,
                    with_env=self._env_statics(), env_in=env_in,
                    with_fresh=(self._fresh_statics()
                                if _fresh_xy is not None else None))
            else:
                physics = engine.step_batch(model, physics,
                                            base_model=base_model)
        if slab is None:
            obs_src = states.physics if cfg.reference_delayed_obs else physics
            geo_obs = self._geo_eval(states.goal_cell,
                                     obs_src.xpos[:, 1, :2])
            obs, metrics = self._observe_batch(
                obs_src, states.odom_ref, states.goal, geo_vec=geo_obs,
                models=models, base_model=base_model)
            new = self._outcome(
                states, physics, obs, metrics,
                self._geo_delta(states.physics, physics, states.goal_cell,
                                None if cfg.reference_delayed_obs
                                else geo_obs))
            return (new, None) if _fresh_xy is not None else new
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
            states.physics, physics, states.goal_cell, geo_new)
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
        which K1 scans in the same launch as the step.  Off the fused step,
        and under ``spawn_heading_noise`` (K1's spawn scan bakes the
        template's heading), the merged state is observed through K2
        instead, with each env's own model under domain randomization.
        Under ``reference_delayed_obs`` the step observes the pre-step
        physics, so a reset env's continuation is observed apart: the
        whole fresh batch through K2 with the base model, as the JAX
        package's per-env reset does, then selected by ``done``.
        ``models``/``base_model``: domain randomization, as in
        :meth:`step_batch` (resets use the base model)."""
        B = states.steps.shape[0]
        cfg = self.config
        if cfg.reference_delayed_obs:
            st = self.step_batch(states, actions, models=models,
                                 base_model=base_model)
            fresh = self.reset(core=fresh if fresh is not None
                               else self.reset_core(B))
            merged = _map2(lambda f, s: select_done(st.done, f, s), fresh, st)
            return merged.replace(**_outcome_fields(st))
        if fresh is None:
            fresh = self.reset_core(B)
        if cfg.spawn_heading_noise:
            st = self.step_batch(states, actions, models=models,
                                 base_model=base_model)
            fresh_lidar = None
        else:
            st, fresh_lidar = self.step_batch(
                states, actions, models=models, base_model=base_model,
                _fresh_xy=fresh.physics.xpos[:, 1, :2])
        done = st.done
        merged = _map2(lambda f, s: select_done(done, f, s), fresh, st)
        keep = _outcome_fields(st)
        if fresh_lidar is None:
            obs, _ = self._observe_batch(
                merged.physics, merged.odom_ref, merged.goal,
                geo_vec=self._geo_eval(merged.goal_cell,
                                       merged.physics.xpos[:, 1, :2]),
                models=models, base_model=base_model)
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
        if cfg.goal_compass:
            cols.append(self._compass(fresh.physics.xpos[:, 1, :2], heading0,
                                      fresh.goal_cell, g))
        fresh_obs = torch.cat(cols, dim=-1)
        return merged.replace(
            obs=torch.where(done[:, None], fresh_obs, st.obs), **keep)

    # ------------------------------------------------------------------- obs
    def _scan_batch(self, physics: State, models=None, base_model=None):
        """The lidar of a batch, (B, nsite).  The names of the randomized
        leaves pick the route: with no randomized scan field, or only the
        floor height (``plane_z``, the default randomization), kernel K2
        (with each env's floor); with any other randomized scan field
        (``raycast.SCAN_FIELDS``: a site frame, a scene box, the plane's
        extent or the cutoff), the plain raycast batched over each env's
        own leaves, as the JAX package scans under every randomization."""
        leaves = ({} if base_model is None
                  else engine.batched_field_dict(models, base_model))
        if any(n in leaves for n in raycast.SCAN_FIELDS if n != "plane_z"):
            return raycast.lidar(models, physics.xpos, physics.xquat)
        return k2.lidar(self.model, _rows(physics.xpos),
                        _rows(physics.xquat), leaves.get("plane_z")).T

    def _observe_batch(self, physics: State, ref: OdometryRef, goal,
                       geo_vec=None, models=None, base_model=None):
        """Observation and metrics of a batch, the lidar from
        ``_scan_batch``; ``geo_vec`` (``_geo_eval`` at the chassis xy)
        feeds the compass."""
        return self._obs_metrics(self._scan_batch(physics, models,
                                                  base_model),
                                 physics, ref, goal, geo_vec)

    def _observe(self, physics: State, ref: OdometryRef, goal, model=None,
                 geo_vec=None):
        """Observation and metrics of one env, the lidar from the per-env
        raycast (``sensors.lidar_scan``) with ``model`` (default: the
        env's)."""
        model = self.model if model is None else model
        return self._obs_metrics(sensors.lidar_scan(model, physics), physics,
                                 ref, goal, geo_vec)

    def _obs_metrics(self, lidar, physics: State, ref: OdometryRef, goal,
                     geo_vec):
        """The observation [lidar, x, y, heading, dx, dy, dist, angle(,
        compass)] and the metrics, one env or a batch."""
        cfg = self.config
        if cfg.reference_lidar_aliasing:
            lidar = torch.cat([lidar[..., 71:72].expand(
                lidar.shape[:-1] + (10,)), lidar[..., 10:]], dim=-1)
        pos_diff = physics.xpos[..., 1, :] - ref.position
        heading = quat_to_yaw(physics.xquat[..., 1, :])
        goal_vec = goal - pos_diff[..., :2]
        goal_distance = torch.linalg.norm(goal_vec, dim=-1)
        goal_angle = (torch.atan2(goal_vec[..., 1], goal_vec[..., 0])
                      - heading)
        goal_angle = torch.atan2(torch.sin(goal_angle), torch.cos(goal_angle))
        cols = [lidar,
                torch.stack([pos_diff[..., 0], pos_diff[..., 1], heading],
                            dim=-1),
                torch.stack([goal_vec[..., 0], goal_vec[..., 1],
                             goal_distance, goal_angle], dim=-1)]
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


def _outcome_fields(st: EnvState) -> dict:
    """The step's outcome, which an auto-reset keeps over the fresh
    state."""
    return dict(reward=st.reward, terminated=st.terminated,
                truncated=st.truncated, done=st.done,
                final_obs=st.final_obs, goal_distance=st.goal_distance,
                collision=st.collision, min_lidar=st.min_lidar)


def _batch1(s: State) -> State:
    return _map2(lambda a, _: a[None], s, s)


def _unbatch1(s: State) -> State:
    return _map2(lambda a, _: a[0], s, s)


def _expand(s: State, B: int) -> State:
    return _map2(lambda a, _: a.expand((B,) + a.shape).clone(), s, s)
