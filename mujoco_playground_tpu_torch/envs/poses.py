"""Physics states of a maze env in contact with its walls and floor.

The states a reset never reaches, but a rollout does: robots against wall
boxes, and robots pressed into the floor.  They hold many contact rows per
env at once, so checks of the step kernels use them (``chip_smoke.py`` and
the host-build tests).
"""
from __future__ import annotations

import math

import torch

from mujoco_playground_tpu_torch.physics import batchlast
from mujoco_playground_tpu_torch.physics import mathutil as mu


def wall_poses(env, B, gen, sink=(0.0, 0.0)):
    """B states of a maze env next to walls, at rest controls: the settled
    template moved to a random free cell, pushed 0.37-0.43 m from the
    cell's center toward one of its four sides (walls bound most of them),
    at a random yaw, so wheels and hulls touch wall boxes at depths up to a
    few cm; ``sink`` (lo, hi) m lowers each robot by a uniform depth into
    the floor."""
    dev = env.device
    tpl = env._template
    cells = env._free_cells
    ci = torch.randint(0, cells.shape[0], (B,), generator=gen, device=dev)
    side = torch.randint(0, 4, (B,), generator=gen, device=dev)
    dirs = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]],
                        device=dev)[side]
    u = torch.rand((B, 3), generator=gen, device=dev)
    xy = cells[ci] + dirs * (0.37 + 0.06 * u[:, :1])
    yaw = (u[:, 1] * 2 - 1) * math.pi
    qz = torch.stack([torch.cos(yaw / 2), torch.zeros_like(yaw),
                      torch.zeros_like(yaw), torch.sin(yaw / 2)], -1)
    qpos = tpl.qpos.expand(B, -1).clone()
    qpos[:, :2] = xy
    qpos[:, 3:7] = mu.quat_mul(qz, tpl.qpos[3:7].expand(B, 4))
    qvel = 0.05 * (torch.rand((B, env.model.nv), generator=gen, device=dev)
                   * 2 - 1)
    if sink[1] > 0:
        depth = torch.rand((B,), generator=gen, device=dev)
        qpos[:, 2] = qpos[:, 2] - (sink[0] + (sink[1] - sink[0]) * depth)
    xpos, xquat = batchlast.fk_bl(env.model, qpos.T)
    return env.reset_core(B).physics.replace(
        qpos=qpos, qvel=qvel, xpos=torch.stack([x.T for x in xpos], 1),
        xquat=torch.stack([x.T for x in xquat], 1),
        ctrl=torch.zeros((B, env.model.nu), device=dev))
