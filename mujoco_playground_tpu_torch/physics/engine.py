"""Batched physics step: the port of the JAX package's ``physics/engine.py``
``step_batch``, with its two paths.

* The fused step: one launch of kernel K1 (``ops/step.py``) per step, or
  of K1e under domain randomization, when every randomized leaf is one of
  ``DR_SUPPORTED``.  On a CUDA device the kernel, on the CPU its twin.
* The staged step (``staged_step``), which the compat contact manifolds
  always take: batch-last smooth dynamics (``batchlast.py``), batched
  collision and constraint assembly (``newton_inputs``), the standalone
  Newton kernel K3 (``ops/newton.py``), then implicit-damping Euler and
  FK.

The port's K1 takes any batch size, so ragged batches stay on K1.
"""
from __future__ import annotations

import types

import torch

from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.ops.newton import newton_solve
from mujoco_playground_tpu_torch.physics import (batchlast, collision,
                                                 constraint, linalg_small,
                                                 solver_batched)
from mujoco_playground_tpu_torch.physics.model import ARRAY_FIELDS, Model
from mujoco_playground_tpu_torch.physics.state import State


def batched_field_dict(model: Model, base_model: Model) -> dict:
    """Names -> leaves of ``model`` that carry an extra leading env axis
    against ``base_model`` (domain randomization)."""
    return {name: getattr(model, name) for name in ARRAY_FIELDS
            if getattr(model, name).dim()
            == getattr(base_model, name).dim() + 1}


def is_compat(model: Model) -> bool:
    """Whether the model uses a compat contact manifold (staged step)."""
    return model.compat_flat_manifold or model.compat_wheel_patch


def dr_params(models: Model, base_model: Model, B: int):
    """K1e's packed ``(DR_ROWS, B)`` parameters of a randomized model: every
    ``DR_SUPPORTED`` field, the unrandomized ones broadcast from the base
    model.  Cached on ``models`` (its leaves do not change)."""
    key = ("dr_params", id(base_model), B)
    packed = models.cache.get(key)
    if packed is None:
        leaves = batched_field_dict(models, base_model)
        full = {name: leaves.get(name, getattr(base_model, name).expand(
                    (B,) + getattr(base_model, name).shape))
                for name in k1.DR_SUPPORTED}
        packed = k1.pack_dr_params(types.SimpleNamespace(**full),
                                   k1.DR_SUPPORTED).to(base_model.dtype)
        models.cache[key] = packed
    return packed


def step_batch(model: Model, states: State, base_model: Model = None,
               with_env: tuple = None, env_in=None, with_fresh: tuple = None,
               ws_compare: bool = False):
    """One step of a batch of states (leaves carry a leading env axis).

    ``with_env`` (the env constants, see ``ops.step.env_plain``) fuses the
    lidar, observation and reward: pass ``env_in (B, 5)`` (``(B, 7)`` with
    ``with_fresh``) and the return is ``(states', env_slab (B, rows))``; on
    the staged path the slab is None and the caller observes.
    ``ws_compare`` picks the Newton start by primal cost (MuJoCo's
    ``mj_warmstart``); the fused default starts from the warm start as the
    fused TPU step does, the staged step always picks.

    Domain randomization: pass a ``model`` whose randomized leaves carry a
    leading env axis and the unbatched ``base_model``.  Randomized leaves
    outside ``DR_SUPPORTED``, and randomization with a compat manifold,
    raise: the JAX package's staged DR fallback is not ported.
    """
    B = states.qpos.shape[0]
    kernel_model, params = model, None
    if base_model is not None:
        names = sorted(batched_field_dict(model, base_model))
        other = [n for n in names if n not in k1.DR_SUPPORTED]
        if other or is_compat(base_model):
            why = (f"randomized fields {other} outside DR_SUPPORTED" if other
                   else "domain randomization with a compat manifold")
            raise NotImplementedError(
                f"{why} need the staged DR fallback, which is not ported "
                f"yet (ROADMAP.md Queue 1, 'Staged DR fallback')")
        kernel_model = base_model
        if names:
            params = dr_params(model, base_model, B)
    if is_compat(kernel_model):
        new = staged_step(kernel_model, states)
        return (new, None) if with_env is not None else new

    def rows(t):
        return t.reshape(B, -1).T.contiguous()

    outs = k1.step_fused(
        kernel_model, rows(states.qpos), rows(states.qvel),
        rows(states.ctrl), rows(states.qacc_warmstart),
        env_in=None if env_in is None else rows(env_in),
        env_statics=with_env, fresh_statics=with_fresh,
        ws_compare=ws_compare, dr_params=params)
    qpos, qvel, xpos, xquat, qacc = outs[:5]
    new = states.replace(
        qpos=qpos.T, qvel=qvel.T, time=states.time + kernel_model.timestep,
        xpos=xpos.T.reshape(B, kernel_model.nbody, 3),
        xquat=xquat.T.reshape(B, kernel_model.nbody, 4), qacc_warmstart=qacc.T)
    if with_env is not None:
        return new, outs[5].T
    return new


def newton_inputs(model: Model, states: State) -> tuple:
    """The Newton system the staged step solves for ``states``: batch-last
    CRBA/RNEA, actuation and smooth solve, then batched collision and
    constraint rows, as kernel K3's positional arguments
    (``solver_batched.newton_args``; the warm start is the caller's)."""
    qpos_bl, qvel_bl = states.qpos.T, states.qvel.T
    xpos_l = [states.xpos[:, b].T for b in range(model.nbody)]
    xquat_l = [states.xquat[:, b].T for b in range(model.nbody)]
    M_bl, bias_bl, S_bl, anchor_bl = batchlast.crba_bias_bl(
        model, xpos_l, xquat_l, qvel_bl, model.gravity)
    qfrc_smooth_bl = (batchlast.actuator_force_bl(model, qpos_bl, qvel_bl,
                                                  states.ctrl.T)
                      - _damping_col(model) * qvel_bl - bias_bl)
    qacc_smooth_bl = linalg_small.cho_solve_bl(
        linalg_small.cholesky_bl(M_bl), qfrc_smooth_bl)
    contacts = collision.collide(model, states.xpos, states.xquat)
    efc = constraint.make_efc(model, states.qpos, states.qvel,
                              torch.movedim(S_bl, -1, 0), anchor_bl.T,
                              contacts)
    return solver_batched.newton_args(model, M_bl, qacc_smooth_bl, efc)


def _damping_col(model: Model):
    """dof_damping as a batch-last column (nv, 1), or (nv, B) when
    randomized."""
    damp = batchlast._param_bl(model.dof_damping, 1)
    return damp[:, None] if damp.dim() == 1 else damp


def staged_step(model: Model, states: State) -> State:
    """The staged step (JAX ``engine.step_batch`` without the megakernel):
    the Newton system of ``newton_inputs``; its solve through K3 from the
    previous qacc with MuJoCo's two-sided warm-start pick; implicit-damping
    Euler ((M + h D) v' = M v + h D v + h M a) and FK."""
    h = model.timestep
    args = newton_inputs(model, states)
    a = newton_solve(*args,
                     warmstart=states.qacc_warmstart.T.contiguous())
    M_bl, qvel_bl, damp_col = args[0], states.qvel.T, _damping_col(model)
    rhs = ((M_bl * (qvel_bl + h * a)[None]).sum(1)
           + h * damp_col * qvel_bl)
    eye = torch.eye(model.nv, dtype=a.dtype, device=a.device)
    MhDt = M_bl + h * (eye[:, :, None] * damp_col[:, None, :])
    qvel_new_bl = linalg_small.cho_solve_bl(linalg_small.cholesky_bl(MhDt),
                                            rhs)
    qpos_new_bl = batchlast.integrate_pos_bl(model, states.qpos.T,
                                             qvel_new_bl, h)
    xpos_l, xquat_l = batchlast.fk_bl(model, qpos_new_bl)
    return states.replace(
        qpos=qpos_new_bl.T, qvel=qvel_new_bl.T, time=states.time + h,
        xpos=torch.stack([x.T for x in xpos_l], 1),
        xquat=torch.stack([x.T for x in xquat_l], 1), qacc_warmstart=a.T)
