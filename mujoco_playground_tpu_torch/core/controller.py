"""cmd_vel -> actuator controls: bicycle and Ackermann steering geometry.

Port of the JAX package's ``core/controller.py``:
:func:`bicycle_cmd_vel_to_controls` (one steering servo and two rear wheel
velocity actuators, the one the envs use) and
:func:`ackermann_cmd_vel_to_controls` (per-wheel steering for the legacy
maze_flat robot's independent steering actuators), with the reference
controllers' branch thresholds, epsilon guards and clip bounds; and the
functional PID.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

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


def ackermann_cmd_vel_to_controls(linear_x, angular_z,
                                  wheel_radius=WHEEL_RADIUS,
                                  wheelbase=WHEELBASE,
                                  track_width=TRACK_WIDTH):
    """(linear_x, angular_z) tensors -> ctrl (..., 4) = [delta_left,
    delta_right, w_left, w_right]: inner and outer wheel steering angles
    about the turn radius v / omega (straight ahead below |omega| 1e-4),
    for scenes with independent steering actuators."""
    v = linear_x
    omega = angular_z
    straight = torch.abs(omega) < 1e-4
    omega_safe = torch.where(straight, 1.0, omega)
    R = v / omega_safe
    R_inner = R - track_width / 2.0
    R_outer = R + track_width / 2.0
    inner = torch.atan(wheelbase / R_inner)
    outer = torch.atan(wheelbase / R_outer)
    left_turn = omega > 0
    delta_left = torch.where(straight, 0.0,
                             torch.where(left_turn, inner, outer))
    delta_right = torch.where(straight, 0.0,
                              torch.where(left_turn, outer, inner))
    v_left = torch.where(straight, v, omega * R_inner)
    v_right = torch.where(straight, v, omega * R_outer)
    return torch.stack([
        torch.clamp(delta_left, -STEER_CLIP, STEER_CLIP),
        torch.clamp(delta_right, -STEER_CLIP, STEER_CLIP),
        torch.clamp(v_left / wheel_radius, -WHEEL_SPEED_CLIP,
                    WHEEL_SPEED_CLIP),
        torch.clamp(v_right / wheel_radius, -WHEEL_SPEED_CLIP,
                    WHEEL_SPEED_CLIP),
    ], dim=-1)


class PIDState(NamedTuple):
    """The functional PID's carried state."""
    integral: Any
    prev_error: Any


def pid_init(dtype=torch.float32, device=None) -> PIDState:
    zero = torch.zeros((), dtype=dtype, device=device)
    return PIDState(zero, zero.clone())


def pid_compute(state: PIDState, kp, ki, kd, target, current, dt=0.002):
    """One PID update: ``(output, new state)``."""
    error = target - current
    integral = state.integral + error * dt
    derivative = (error - state.prev_error) / dt
    out = kp * error + ki * integral + kd * derivative
    return out, PIDState(integral, error)
