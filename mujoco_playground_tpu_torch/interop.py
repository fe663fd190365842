"""Carry models, env states and policies across from the JAX package as
numpy.

The port imports nothing of the JAX package; a caller that has both
flattens the JAX objects to numpy itself and hands the arrays over by name.
A JAX package checkpoint (Orbax) reaches the port only this way, in a
process that has JAX to restore it.
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
from mujoco_playground_tpu_torch.rl.ppo import NormState

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
    randomized model carries with a leading env axis, as numpy by name
    (any array field, not only K1e's nine; the other fields stay the base
    model's)."""
    return dataclasses.replace(base, **{
        name: torch.tensor(np.asarray(v), dtype=base.dtype,
                           device=base.device)
        for name, v in leaves.items()})


def env_state_from_arrays(d: dict, device) -> EnvState:
    """A port ``EnvState`` from numpy leaves keyed by ``ENV_STATE_FIELDS``:
    a batch's, or one env's (the per-env API's unbatched state).  A JAX
    ``rng`` leaf, if present, is ignored."""
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


def _dense_from_flax(out: dict, name: str, leaves: dict):
    """``out[name.weight]``, ``out[name.bias]`` from a flax ``Dense``'s
    leaves: its kernel (in, out) transposed to a ``Linear`` weight (out,
    in)."""
    out[f"{name}.weight"] = torch.tensor(
        np.asarray(leaves["kernel"], np.float32).T.copy())
    out[f"{name}.bias"] = torch.tensor(np.asarray(leaves["bias"], np.float32))


def actor_critic_from_flax(params: dict) -> dict:
    """A port ``ActorCritic`` ``state_dict`` from the JAX package's
    ``ActorCritic`` parameters: the nested dict of numpy arrays that
    ``network.init`` or an Orbax restore gives (with or without its top
    ``"params"`` level).  A flax ``Dense`` kernel is (in, out), a torch
    ``Linear`` weight (out, in): kernels are transposed."""
    p = params.get("params", params)
    out = {}
    for tower in ("pi_tower", "vf_tower"):
        for layer in sorted(p[tower], key=lambda k: int(k.split("_")[1])):
            _dense_from_flax(out, f"{tower}.{layer}", p[tower][layer])
    _dense_from_flax(out, "action_head", p["action_head"])
    _dense_from_flax(out, "value_head", p["value_head"])
    out["log_std"] = torch.tensor(np.asarray(p["log_std"], np.float32))
    return out


def norm_state_from_arrays(d: dict, device) -> NormState:
    """A port ``NormState`` from a JAX ``NormState``'s leaves as numpy, by
    name."""
    return NormState(**{
        f.name: torch.tensor(np.asarray(d[f.name], np.float32),
                             device=device)
        for f in dataclasses.fields(NormState)})


def ppo_checkpoint_from_flax(params: dict, norm: dict = None,
                             global_step: int = 0) -> dict:
    """A policy-only port checkpoint (``torch.save`` it as
    ``<log-dir>/ppo_torch/step_<global_step:010d>.pt``) from a JAX PPO
    train state's leaves as numpy: ``params`` as for
    ``actor_critic_from_flax`` and ``norm`` the ``NormState`` leaves by
    name.  It holds the network, the norm statistics without the per-env
    running returns (trainer state, not policy) and the step count: what
    ``rl.checkpoint.restore_policy`` (``--eval-only``) reads."""
    out = {"network": actor_critic_from_flax(params),
           "global_step": int(global_step), "norm": None}
    if norm is not None:
        out["norm"] = {
            f.name: torch.tensor(np.asarray(norm[f.name], np.float32))
            for f in dataclasses.fields(NormState)
            if f.name != "env_returns"}
    return out


# the off-policy states' parameter trees and the port modules they fill
_OFFPOLICY_TREES = (("actor_params", "actor"),
                    ("actor_target_params", "actor_target"),
                    ("q_params", "q"), ("q_target_params", "q_target"))


def dense_stack_from_flax(params: dict) -> dict:
    """A port module ``state_dict`` from flax parameters whose top level
    is ``Dense`` layers by name (``sac.TanhGaussianActor``'s ``dense_i``,
    ``mean``, ``log_std``; ``td3.DeterministicActor``'s ``out``;
    ``sac.TwinQ``'s ``q1_dense_i`` ... ``q2_out``), with or without the
    top ``"params"`` level."""
    p = params.get("params", params)
    out = {}
    for layer in sorted(p):
        _dense_from_flax(out, layer, p[layer])
    return out


def offpolicy_checkpoint_from_flax(state: dict) -> dict:
    """A policy-only port SAC/TD3 checkpoint (``torch.save`` it as
    ``<log-dir>/<algo>_torch/step_<global_step:010d>.pt``) from a JAX
    ``SACState``/``TD3State``'s leaves as numpy by name:
    ``actor_params``, ``q_params``, ``q_target_params``, TD3's
    ``actor_target_params`` and SAC's ``log_alpha``, and ``global_step``
    (the fields ``scripts/strip_offpolicy_ckpts.py`` keeps).  It holds
    the networks, ``log_alpha`` and the step count, and no optimizer,
    buffer or env state: what ``rl.checkpoint.restore_policy``
    (``--eval-only``) reads."""
    out = {module: dense_stack_from_flax(state[tree])
           for tree, module in _OFFPOLICY_TREES if tree in state}
    if "log_alpha" in state:
        out["log_alpha"] = torch.tensor(np.asarray(state["log_alpha"],
                                                   np.float32))
    out["global_step"] = int(np.asarray(state["global_step"]))
    return out
