"""cmd_vel -> actuator controls for the bicycle-steered Ackermann robot.

Port of the JAX package's ``core/controller.py``
(``bicycle_cmd_vel_to_controls``): one steering servo and two rear wheel
velocity actuators, with the reference controller's branch thresholds,
epsilon guards and clip bounds.
"""
from __future__ import annotations

import math

import torch

WHEEL_RADIUS = 0.0325
WHEELBASE = 0.20
TRACK_WIDTH = 0.174
STEER_CLIP = 0.61                       # steering actuator ctrlrange
STEER_ANGLE_LIMIT = math.radians(35.0)
WHEEL_SPEED_CLIP = 50.0


def bicycle_cmd_vel_to_controls(linear_x, angular_z,
                                wheel_radius=WHEEL_RADIUS,
                                wheelbase=WHEELBASE,
                                track_width=TRACK_WIDTH):
    """(linear_x, angular_z) tensors -> ctrl (..., 3) = [steering, w_left,
    w_right]: delta = atan(wb * omega / v) clipped to +-35 degrees, and
    differential rear wheel speeds from the turn radius."""
    v = linear_x
    omega = angular_z
    eps = 1e-5
    v_safe = torch.where(torch.abs(v) > eps, v, torch.sign(omega) * eps)
    v_safe = torch.where(v_safe == 0, eps, v_safe)      # omega == 0 guard
    ratio = wheelbase * omega / v_safe
    delta = torch.where(torch.abs(omega) < 1e-6, 0.0, torch.atan(ratio))
    delta = torch.clamp(delta, -STEER_ANGLE_LIMIT, STEER_ANGLE_LIMIT)

    tan_d = torch.tan(delta)
    tan_safe = torch.where(torch.abs(tan_d) > eps, tan_d, eps)
    R = wheelbase / tan_safe
    omega_turn = torch.where(torch.abs(R) > eps, v / R, 0.0)
    v_left_turn = omega_turn * (R - track_width / 2.0)
    v_right_turn = omega_turn * (R + track_width / 2.0)
    straight = torch.abs(delta) < 1e-6
    v_left = torch.where(straight, v, v_left_turn)
    v_right = torch.where(straight, v, v_right_turn)
    return torch.stack([
        torch.clamp(delta, -STEER_CLIP, STEER_CLIP),
        torch.clamp(v_left / wheel_radius, -WHEEL_SPEED_CLIP,
                    WHEEL_SPEED_CLIP),
        torch.clamp(v_right / wheel_radius, -WHEEL_SPEED_CLIP,
                    WHEEL_SPEED_CLIP),
    ], dim=-1)
