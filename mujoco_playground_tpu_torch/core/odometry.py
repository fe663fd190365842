"""Functional odometry (port of the JAX package's ``core/odometry.py``).

The reference pose captured at reset is explicit state
(:class:`OdometryRef`), and every readout is a function of the chassis
frame, for one env or a batch.
"""
from __future__ import annotations

import dataclasses

import torch

from mujoco_playground_tpu_torch.physics.mathutil import quat_to_yaw


@dataclasses.dataclass
class OdometryRef:
    position: torch.Tensor  # (..., 3) world chassis position at reset
    quat: torch.Tensor      # (..., 4) world chassis orientation at reset

    def replace(self, **kw) -> "OdometryRef":
        return dataclasses.replace(self, **kw)


def odometry_reset(xpos_chassis, xquat_chassis) -> OdometryRef:
    return OdometryRef(position=xpos_chassis, quat=xquat_chassis)


def calculate_odom(ref: OdometryRef, xpos_chassis, xquat_chassis) -> dict:
    """The reference's ``calculate_odom`` keys: the position relative to
    the reset pose, the orientation, the heading and the distance
    travelled from the reset pose."""
    diff = xpos_chassis - ref.position
    return dict(
        position=diff,
        orientation=xquat_chassis,
        heading=quat_to_yaw(xquat_chassis),
        distance=torch.linalg.norm(diff, dim=-1),
        reference_position=ref.position,
        current_position=xpos_chassis,
    )


def get_distance_to_point(xpos_chassis, target_point):
    target = torch.as_tensor(target_point, dtype=xpos_chassis.dtype,
                             device=xpos_chassis.device)
    return torch.linalg.norm(xpos_chassis - target, dim=-1)


def get_bearing_to_point(xpos_chassis, target_point):
    target = torch.as_tensor(target_point, dtype=xpos_chassis.dtype,
                             device=xpos_chassis.device)
    to_target = target - xpos_chassis
    return torch.atan2(to_target[..., 1], to_target[..., 0])
