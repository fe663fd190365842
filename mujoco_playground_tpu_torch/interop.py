"""Carry models and env states across from the JAX package as numpy.

The port imports nothing of the JAX package; a caller that has both
flattens the JAX objects to numpy itself and hands the arrays over by name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_playground_tpu_torch.core.odometry import OdometryRef
from mujoco_playground_tpu_torch.envs.ackermann_env import EnvState
from mujoco_playground_tpu_torch.physics.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS, Model)
from mujoco_playground_tpu_torch.physics.state import State

# dotted names of an EnvState's leaves, in declaration order
ENV_STATE_FIELDS = tuple(
    [f"physics.{f.name}" for f in dataclasses.fields(State)]
    + [f"odom_ref.{f.name}" for f in dataclasses.fields(OdometryRef)]
    + [f.name for f in dataclasses.fields(EnvState)
       if f.name not in ("physics", "odom_ref")])

_INT_FIELDS = ("steps", "goal_cell")
_BOOL_FIELDS = ("terminated", "truncated", "done", "collision")


def model_from_arrays(leaves: dict, device, dtype=torch.float32) -> Model:
    """A port ``Model`` from the JAX ``Model``'s fields by name: the array
    leaves as numpy, the static topology as Python values.  Fields the port
    does not keep are ignored."""
    statics = {k: leaves[k] for k in STATIC_FIELDS}
    arrays = {k: torch.tensor(np.asarray(leaves[k]), dtype=dtype,
                              device=device) for k in ARRAY_FIELDS}
    return Model(**statics, **arrays)


def randomized_model_from_arrays(base: Model, leaves: dict) -> Model:
    """The port's randomized ``Model``: ``base`` with the leaves a JAX
    ``randomize_model`` result carries with a leading env axis, as numpy
    by name (the other fields stay the base model's)."""
    return dataclasses.replace(base, **{
        name: torch.tensor(np.asarray(v), dtype=base.dtype,
                           device=base.device)
        for name, v in leaves.items()})


def env_state_from_arrays(d: dict, device) -> EnvState:
    """A port ``EnvState`` batch from numpy leaves keyed by
    ``ENV_STATE_FIELDS`` (a JAX ``rng`` leaf, if present, is ignored)."""
    def t(name):
        a = np.asarray(d[name])
        if name in _INT_FIELDS:
            return torch.tensor(a.astype(np.int32), device=device)
        if name in _BOOL_FIELDS:
            return torch.tensor(a.astype(bool), device=device)
        return torch.tensor(a.astype(np.float32), device=device)

    physics = State(**{f.name: t(f"physics.{f.name}")
                       for f in dataclasses.fields(State)})
    ref = OdometryRef(**{f.name: t(f"odom_ref.{f.name}")
                         for f in dataclasses.fields(OdometryRef)})
    return EnvState(physics=physics, odom_ref=ref, **{
        f.name: t(f.name) for f in dataclasses.fields(EnvState)
        if f.name not in ("physics", "odom_ref")})


def env_state_to_arrays(state: EnvState) -> dict:
    """An ``EnvState``'s leaves as numpy, keyed by ``ENV_STATE_FIELDS``."""
    out = {}
    for name in ENV_STATE_FIELDS:
        v = state
        for part in name.split("."):
            v = getattr(v, part)
        out[name] = v.detach().cpu().numpy()
    return out
