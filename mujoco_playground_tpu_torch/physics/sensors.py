"""Sensor readout of one env: the sensordata vector in MuJoCo's layout
(the port of the JAX package's ``physics/sensors.py``).

For the Ackermann robot that is 77 slots: 4 wheel encoders and the steering
angle, then the 72 rangefinder beams.  Scalar sensors are gathers; the
rangefinders go through the raycast (``raycast.lidar``).
"""
from __future__ import annotations

import torch

from mujoco_playground_tpu_torch.physics import raycast
from mujoco_playground_tpu_torch.physics.model import Model
from mujoco_playground_tpu_torch.physics.state import State


def sensordata(model: Model, state: State):
    """(nsensordata,) sensor vector of one env."""
    lidar_vals = None
    out = []
    for kind, obj in zip(model.sensor_kinds, model.sensor_obj):
        if kind == "jointpos":
            out.append(state.qpos[obj])
        elif kind == "jointvel":
            out.append(state.qvel[obj])
        elif kind == "rangefinder":
            if lidar_vals is None:
                lidar_vals = raycast.lidar(model, state.xpos, state.xquat)
            out.append(lidar_vals[obj])
    return torch.stack(out)


def lidar_scan(model: Model, state: State):
    """(n_beams,) rangefinder distances only (the env's observation)."""
    return raycast.lidar(model, state.xpos, state.xquat)
