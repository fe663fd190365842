"""Dynamic physics state: a dataclass of tensors (one env, or a batch with a
leading env axis)."""
from __future__ import annotations

import dataclasses

import torch

from mujoco_playground_tpu_torch.physics.model import Model


@dataclasses.dataclass
class State:
    qpos: torch.Tensor    # (..., nq)
    qvel: torch.Tensor    # (..., nv)
    ctrl: torch.Tensor    # (..., nu)
    time: torch.Tensor    # (...)
    xpos: torch.Tensor    # (..., nbody, 3) world body frames, kept in sync
    xquat: torch.Tensor   # (..., nbody, 4)
    # previous step's constraint solution: the Newton solve's initial point
    # (MuJoCo's qacc_warmstart; zeros at reset)
    qacc_warmstart: torch.Tensor  # (..., nv)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def make_state(model: Model, qpos=None, qvel=None) -> State:
    """Fresh single-env state at qpos0 (or the given qpos/qvel), with FK."""
    from mujoco_playground_tpu_torch.physics import kinematics

    qpos = (model.qpos0.clone() if qpos is None
            else torch.as_tensor(qpos, dtype=model.dtype, device=model.device))
    qvel = (torch.zeros(model.nv, dtype=model.dtype, device=model.device)
            if qvel is None else torch.as_tensor(qvel, dtype=model.dtype,
                                                 device=model.device))
    xpos, xquat = kinematics.fk(model, qpos)
    return State(qpos=qpos, qvel=qvel, ctrl=qpos.new_zeros(model.nu),
                 time=qpos.new_zeros(()), xpos=xpos, xquat=xquat,
                 qacc_warmstart=qpos.new_zeros(model.nv))
