"""The Ackermann goal-navigation env over a batch, in plain PyTorch: what
the port's ``AckermannEnv`` computes on its fused path (no heading noise,
no delayed observation, one physics substep), worked out again from the
robot spec, the PointMaze scene and the configuration.

A state is a flat dict of batch-first tensors named as the port's
``EnvState`` leaves (``LEAVES``).  ``spawn`` builds fresh states from
given draws (start xy, goal xy, goal cell), ``reset`` observes them, and
``step_autoreset`` is one env step with the branchless auto-reset onto
given fresh states: the physics step and its fused scans from ``step.py``,
the observation, reward, done flags, goal compass and geodesic shaping,
then the merge.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import geodesic
from .lidar import lidar_plain
from .model import make_model
from .robot import ackermann_robot_v2
from .scene import pointmaze_scene
from .step import physics_plain, step_plain

GEO_RES = 0.05      # the geodesic fields' grid spacing (m)
PHYSICS = ("qpos", "qvel", "ctrl", "time", "xpos", "xquat", "qacc_warmstart")
LEAVES = PHYSICS + ("ref_position", "ref_quat", "goal", "steps", "obs",
                    "final_obs", "reward", "terminated", "truncated", "done",
                    "goal_distance", "collision", "min_lidar",
                    "prev_goal_distance", "goal_cell")
OUTCOME = ("reward", "terminated", "truncated", "done", "final_obs",
           "goal_distance", "collision", "min_lidar")

# the rear-drive bicycle controller (the robot's steering servo and two rear
# wheel velocity actuators)
WHEEL_RADIUS, WHEELBASE, TRACK_WIDTH = 0.0325, 0.20, 0.174
STEER_CLIP, STEER_ANGLE_LIMIT, WHEEL_SPEED_CLIP = 0.61, math.radians(35.0), 50.0


def bicycle_controls(v, omega):
    """(linear_x, angular_z) -> ctrl (..., 3) = [steering, w_left,
    w_right]."""
    eps = 1e-5
    v_safe = torch.where(torch.abs(v) > eps, v, torch.sign(omega) * eps)
    v_safe = torch.where(v_safe == 0, eps, v_safe)
    ratio = WHEELBASE * omega / v_safe
    delta = torch.where(torch.abs(omega) < 1e-6, 0.0, torch.atan(ratio))
    delta = torch.clamp(delta, -STEER_ANGLE_LIMIT, STEER_ANGLE_LIMIT)
    tan_d = torch.tan(delta)
    tan_safe = torch.where(torch.abs(tan_d) > eps, tan_d, eps)
    R = WHEELBASE / tan_safe
    omega_turn = torch.where(torch.abs(R) > eps, v / R, 0.0)
    v_left_turn = omega_turn * (R - TRACK_WIDTH / 2.0)
    v_right_turn = omega_turn * (R + TRACK_WIDTH / 2.0)
    straight = torch.abs(delta) < 1e-6
    v_left = torch.where(straight, v, v_left_turn)
    v_right = torch.where(straight, v, v_right_turn)
    return torch.stack([
        torch.clamp(delta, -STEER_CLIP, STEER_CLIP),
        torch.clamp(v_left / WHEEL_RADIUS, -WHEEL_SPEED_CLIP,
                    WHEEL_SPEED_CLIP),
        torch.clamp(v_right / WHEEL_RADIUS, -WHEEL_SPEED_CLIP,
                    WHEEL_SPEED_CLIP)], dim=-1)


def quat_to_yaw(q):
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def _rows(t):
    """(B, ...) -> batch-last (rows, B), contiguous."""
    return t.reshape(t.shape[0], -1).T.contiguous()


class RefEnv:
    """The env of one configuration (``configs/<name>.json``'s ``env``
    block) on ``device``.  The model and the spawn template are float32,
    as the configuration states; ``dtype`` is the precision the steps
    compute in (float32; a lower one for the control).  Static scalars
    stay Python floats."""

    def __init__(self, env_cfg: dict, device, dtype=torch.float32):
        self.cfg = env_cfg
        self.device, self.dtype = torch.device(device), dtype
        self.scene = pointmaze_scene(env_cfg["maze_id"])
        self.model = make_model(
            ackermann_robot_v2(), self.scene, dtype=torch.float32,
            solver_iterations=env_cfg["solver_iterations"],
            ls_iterations=env_cfg["ls_iterations"], device=self.device)
        self.free_cells = np.asarray(self.scene.free_cells)
        self.cell_size = float(self.scene.cell_size)
        self.template = self._settle()
        t = self.template
        tw, tx, ty, tz = t["xquat"][1].double().cpu().numpy()
        self.heading0 = float(np.arctan2(2 * (tw * tz + tx * ty),
                                         1 - 2 * (ty * ty + tz * tz)))
        self.fresh_statics = (
            tuple(tuple(float(v) for v in row) for row in t["xpos"].cpu()),
            tuple(tuple(float(v) for v in row) for row in t["xquat"].cpu()),
            (float(t["qpos"][0]), float(t["qpos"][1])))
        self.env_statics = (
            float(env_cfg["collision_threshold"]),
            float(env_cfg["goal_distance_threshold"]),
            float(env_cfg["progress_reward_scale"]), False,
            bool(env_cfg["collision_ignores_nohit"]),
            float(env_cfg["collision_penalty"]))
        self.geo = None
        if env_cfg["geodesic_reward_scale"] or env_cfg["goal_compass"]:
            fields, origin = geodesic.build_fields(self.scene, GEO_RES)
            grad = geodesic.build_grad_fields(fields, GEO_RES)
            self.geo = (torch.as_tensor(np.concatenate(
                [fields[..., None], grad], axis=-1), device=self.device),
                torch.as_tensor(origin, device=self.device))
        self.obs_size = 79 + (2 if env_cfg["goal_compass"] else 0)

    # ---------------------------------------------------------------- spawn
    def _settle(self) -> dict:
        """The spawn template: the robot at the origin with its chassis
        0.055 above the floor, settled by 3 physics steps that pick the
        Newton start by primal cost (MuJoCo's warm-start pick); one env,
        on the reference's device (on the card, CUDA's float32 operations
        round as the program's kernel does; the CPU's last bits differ
        by ~1e-6 m in the settled pose)."""
        m = self.model
        qpos = m.qpos0.clone()
        qpos[2] = self.scene.floor_z + 0.055
        qvel = torch.zeros(m.nv, dtype=m.dtype, device=self.device)
        ctrl = torch.zeros(m.nu, dtype=m.dtype, device=self.device)
        ws = torch.zeros(m.nv, dtype=m.dtype, device=self.device)
        xpos = xquat = None
        for _ in range(3):
            qpos, qvel, xpos, xquat, ws = (
                t[:, 0] for t in physics_plain(
                    m, qpos[:, None], qvel[:, None], ctrl[:, None],
                    ws[:, None], ws_compare=True))
        return dict(qpos=qpos, qvel=qvel, ctrl=ctrl,
                    time=torch.zeros((), dtype=m.dtype, device=self.device)
                    + 3 * m.timestep, xpos=xpos.reshape(m.nbody, 3),
                    xquat=xquat.reshape(m.nbody, 4), qacc_warmstart=ws)

    def spawn(self, start_xy, goal_xy, goal_cell) -> dict:
        """Fresh states at given draws, without their observation (obs
        fields are zero placeholders): the settled template moved to
        ``start_xy`` (B, 2), the goal at world ``goal_xy`` in free cell
        ``goal_cell``."""
        tpl, B = self.template, start_xy.shape[0]
        s = {k: tpl[k].to(self.dtype).expand((B,) + tpl[k].shape).clone()
             for k in PHYSICS}
        s["qpos"][:, 0:2] = start_xy
        s["xpos"][:, 1:, 0:2] += (start_xy - tpl["qpos"][0:2].to(
            self.dtype))[:, None, :]
        s["time"] = torch.zeros(B, dtype=self.dtype, device=self.device)
        goal = goal_xy - s["xpos"][:, 1, :2]
        zero = torch.zeros(B, dtype=self.dtype, device=self.device)
        false = torch.zeros(B, dtype=torch.bool, device=self.device)
        obs0 = torch.zeros((B, self.obs_size), dtype=self.dtype,
                           device=self.device)
        s.update(ref_position=s["xpos"][:, 1].clone(),
                 ref_quat=s["xquat"][:, 1].clone(), goal=goal,
                 steps=torch.zeros(B, dtype=torch.int32, device=self.device),
                 obs=obs0, final_obs=obs0, reward=zero, terminated=false,
                 truncated=false, done=false, goal_distance=zero,
                 collision=false, min_lidar=zero,
                 prev_goal_distance=torch.linalg.norm(goal, dim=-1).to(
                     self.dtype),
                 goal_cell=goal_cell.to(torch.int32))
        return s

    def reset(self, start_xy, goal_xy, goal_cell) -> dict:
        """Fresh states with their observation (the lidar scanned on the
        spawn frames)."""
        s = self.spawn(start_xy, goal_xy, goal_cell)
        lidar = lidar_plain(self.model, _rows(s["xpos"]),
                            _rows(s["xquat"])).T
        obs, met = self._obs_metrics(
            lidar, s, self._geo_eval(s["goal_cell"], s["xpos"][:, 1, :2]))
        s.update(obs=obs, final_obs=obs, **met)
        return s

    # ------------------------------------------------------------- geodesic
    def _geo_eval(self, goal_cell, xy):
        if self.geo is None:
            return None
        return geodesic.sample_vec(self.geo[0], self.geo[1], GEO_RES,
                                   goal_cell, xy)

    def _compass_from(self, grad, heading, goal_vec):
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

    def _obs_metrics(self, lidar, s, geo_vec):
        cfg = self.cfg
        pos_diff = s["xpos"][..., 1, :] - s["ref_position"]
        heading = quat_to_yaw(s["xquat"][..., 1, :])
        goal_vec = s["goal"] - pos_diff[..., :2]
        goal_distance = torch.linalg.norm(goal_vec, dim=-1)
        goal_angle = (torch.atan2(goal_vec[..., 1], goal_vec[..., 0])
                      - heading)
        goal_angle = torch.atan2(torch.sin(goal_angle), torch.cos(goal_angle))
        cols = [lidar,
                torch.stack([pos_diff[..., 0], pos_diff[..., 1], heading], -1),
                torch.stack([goal_vec[..., 0], goal_vec[..., 1],
                             goal_distance, goal_angle], -1)]
        if cfg["goal_compass"]:
            cols.append(self._compass_from(
                None if geo_vec is None else geo_vec[..., 1:3], heading,
                goal_vec))
        obs = torch.cat(cols, dim=-1).to(self.dtype)
        if cfg["collision_ignores_nohit"]:
            min_lidar = torch.where(lidar < 0, math.inf, lidar).amin(-1)
        else:
            min_lidar = lidar.amin(-1)
        return obs, dict(goal_distance=goal_distance,
                         collision=min_lidar < cfg["collision_threshold"],
                         min_lidar=min_lidar)

    # ----------------------------------------------------------------- step
    def step_autoreset(self, s: dict, actions, fresh: dict) -> dict:
        """One env step of the batch ``s`` under ``actions`` (B, 2), with
        the auto-reset onto ``fresh`` (a ``spawn`` batch) where it ends an
        episode; the step's outcome (reward, flags, ``final_obs``, goal
        distance, collision, nearest beam) is kept."""
        cfg, m, dt = self.cfg, self.model, self.dtype
        B = actions.shape[0]
        actions = torch.clamp(actions.to(dt), -1.0, 1.0)
        ctrl = bicycle_controls(actions[..., 0] * cfg["max_linear_velocity"],
                                actions[..., 1] * cfg["max_angular_velocity"])
        env_in = torch.cat([s["ref_position"][:, :2], s["goal"],
                            s["prev_goal_distance"][:, None],
                            fresh["xpos"][:, 1, :2]], dim=-1).to(dt)
        qpos, qvel, xpos, xquat, qacc, slab = step_plain(
            m, _rows(s["qpos"]), _rows(s["qvel"]), _rows(ctrl),
            _rows(s["qacc_warmstart"]), env_in=_rows(env_in),
            env_statics=self.env_statics, fresh_statics=self.fresh_statics)
        slab = slab.T
        st = dict(s)
        st.update(qpos=qpos.T, qvel=qvel.T, ctrl=ctrl,
                  time=s["time"] + m.timestep,
                  xpos=xpos.T.reshape(B, m.nbody, 3),
                  xquat=xquat.T.reshape(B, m.nbody, 4), qacc_warmstart=qacc.T)
        ns = m.nsite
        obs = slab[:, :ns + 7]
        geo_new = self._geo_eval(s["goal_cell"], st["xpos"][:, 1, :2])
        if cfg["goal_compass"]:
            goal_vec = s["goal"] - (st["xpos"][:, 1, :2]
                                    - s["ref_position"][:, :2])
            obs = torch.cat([obs, self._compass_from(
                None if geo_new is None else geo_new[..., 1:3],
                slab[:, ns + 2], goal_vec)], dim=-1)
        reward = slab[:, ns + 7]
        scale = cfg["geodesic_reward_scale"]
        if self.geo is not None and scale:
            phi_p = self._geo_eval(s["goal_cell"],
                                   s["xpos"][..., 1, :2])[..., 0]
            reward = reward + (scale * (phi_p - geo_new[..., 0])).to(dt)
        terminated = slab[:, ns + 11] > 0.5
        steps = s["steps"] + 1
        truncated = (steps >= cfg["max_episode_steps"]) & ~terminated
        goal_distance = slab[:, ns + 8]
        st.update(obs=obs, final_obs=obs, reward=reward, steps=steps,
                  terminated=terminated, truncated=truncated,
                  done=terminated | truncated, goal_distance=goal_distance,
                  collision=slab[:, ns + 10] > 0.5,
                  min_lidar=slab[:, ns + 9], prev_goal_distance=goal_distance)
        fresh_lidar = slab[:, ns + 12:]
        done = st["done"]
        merged = {}
        for k in LEAVES:
            d = done.reshape(done.shape + (1,) * (fresh[k].dim() - 1))
            merged[k] = torch.where(d, fresh[k], st[k])
        g = fresh["goal"]
        heading0 = torch.full((B,), self.heading0, dtype=dt,
                              device=self.device)
        ang = torch.atan2(g[:, 1], g[:, 0]) - self.heading0
        ang = torch.atan2(torch.sin(ang), torch.cos(ang))
        cols = [fresh_lidar, torch.zeros((B, 2), dtype=dt, device=self.device),
                heading0[:, None], g, fresh["prev_goal_distance"][:, None],
                ang[:, None]]
        if cfg["goal_compass"]:
            geo = self._geo_eval(fresh["goal_cell"], fresh["xpos"][:, 1, :2])
            cols.append(self._compass_from(
                None if geo is None else geo[..., 1:3], heading0, g))
        fresh_obs = torch.cat(cols, dim=-1)
        merged["obs"] = torch.where(done[:, None], fresh_obs, st["obs"])
        for k in OUTCOME:
            merged[k] = st[k]
        return merged
