"""The physics step: the port of the JAX package's ``physics/engine.py``.

``step_batch`` steps a batch, by one of two paths:

* The fused step: one launch of kernel K1 (``ops/step.py``) per step, or
  of K1e under domain randomization, when every randomized leaf is one of
  ``DR_SUPPORTED``.  On a CUDA device the kernel, on the CPU its twin.
* The staged step (``staged_step``), which the compat contact manifolds
  and any other randomization take: batch-last smooth dynamics
  (``batchlast.py``), batched collision and constraint assembly
  (``newton_inputs``) with each env's own leaves, the standalone Newton
  kernel K3 (``ops/newton.py``), then implicit-damping Euler and FK.

The port's K1 takes any batch size, so ragged batches stay on K1.

``forward`` and ``step`` step one env, as the JAX functions of those names
do: plain PyTorch on the state's device (the JAX package runs them as XLA
code on every platform), through the batched collision and constraint
assembly on a batch of one and the per-env Newton solve
(``solver.solve``), which makes MuJoCo's warm-start pick as the staged
step does.
"""
from __future__ import annotations

import dataclasses
import types

import torch

from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.ops.newton import newton_solve
from mujoco_playground_tpu_torch.physics import (batchlast, collision,
                                                 constraint, constraint_bl,
                                                 inertia, kinematics,
                                                 linalg_small, solver,
                                                 solver_batched)
from mujoco_playground_tpu_torch.physics import mathutil as mu
from mujoco_playground_tpu_torch.physics.model import (JNT_FREE, Model,
                                                       randomized_fields)
from mujoco_playground_tpu_torch.physics.state import State


def batched_field_dict(model: Model, base_model: Model) -> dict:
    """Names -> leaves of ``model`` that carry an extra leading env axis
    against ``base_model`` (domain randomization)."""
    return {name: getattr(model, name) for name in randomized_fields(model)
            if name not in randomized_fields(base_model)}


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
    the staged path the slab is None and the caller observes.  Without
    ``with_env`` the fused path is K1's plain physics step.
    ``ws_compare`` picks the Newton start by primal cost (MuJoCo's
    ``mj_warmstart``); the fused default starts from the warm start as the
    fused TPU step does, the staged step always picks.

    Domain randomization: pass a ``model`` whose randomized leaves carry a
    leading env axis and the unbatched ``base_model``.  When every
    randomized leaf is one of ``DR_SUPPORTED`` and the manifolds are the
    default ones, the step is K1e; otherwise it is the staged step with
    each env's own leaves (the JAX package's staged DR fallback).
    """
    B = states.qpos.shape[0]
    kernel_model, params = model, None
    if base_model is not None:
        names = sorted(batched_field_dict(model, base_model))
        if (is_compat(base_model)
                or any(n not in k1.DR_SUPPORTED for n in names)):
            new = staged_step(model, states)
            return (new, None) if with_env is not None else new
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


def newton_inputs(model: Model, states: State,
                  kernel_layout: bool = False) -> tuple:
    """The Newton system the staged step solves for ``states``: batch-last
    CRBA/RNEA, actuation and smooth solve, then batched collision and
    constraint rows, as kernel K3's positional arguments
    (``solver_batched.newton_args``; the warm start is the caller's).
    ``kernel_layout`` assembles the rows batch-last in K3's own layout
    (``constraint_bl.make_efc_bl``, for ``newton_solve(...,
    pre_transposed=True)``; an unrandomized model only)."""
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
    if kernel_layout:
        e = constraint_bl.make_efc_bl(model, qpos_bl, qvel_bl, S_bl,
                                      anchor_bl, contacts)
        return (M_bl.contiguous(), qacc_smooth_bl.contiguous(), e["Gt"],
                e["j_aref"], e["j_R"], e["j_floss"], e["j_active"],
                e["j_kind"], e["Jnt"], e["Jt1t"], e["Jt2t"], e["c_aref4"],
                e["c_R"], e["c_mu"], e["c_active"], model.solver_iterations,
                model.ls_iterations)
    efc = constraint.make_efc(model, states.qpos, states.qvel,
                              torch.movedim(S_bl, -1, 0), anchor_bl.T,
                              contacts)
    return solver_batched.newton_args(model, M_bl, qacc_smooth_bl, efc)


def _damping_col(model: Model):
    """dof_damping as a batch-last column (nv, 1), or (nv, B) when
    randomized."""
    damp = batchlast._param_bl(model.dof_damping, 1)
    return damp[:, None] if damp.dim() == 1 else damp


def staged_step(model: Model, states: State,
                kernel_layout: bool = False) -> State:
    """The staged step (JAX ``engine.step_batch`` without the megakernel):
    the Newton system of ``newton_inputs``; its solve through K3 from the
    previous qacc with MuJoCo's two-sided warm-start pick; implicit-damping
    Euler ((M + h D) v' = M v + h D v + h M a) and FK.  Any leaf of
    ``model`` may carry a leading env axis (domain randomization): every
    stage reads each env's own value (``batchlast._param_bl``,
    ``model.env_leaf``); the invweights stay the base model's unless they
    are randomized themselves, as in the JAX package.  ``kernel_layout``
    assembles the rows in K3's layout (``newton_inputs``; unrandomized
    models only)."""
    h = model.timestep
    args = newton_inputs(model, states, kernel_layout)
    a = newton_solve(*args, warmstart=states.qacc_warmstart.T.contiguous(),
                     pre_transposed=kernel_layout)
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


# --------------------------------------------------------------------------
# the per-env step

def actuator_force(model: Model, qpos, qvel, ctrl):
    """Affine actuators of one env: clip(gain ctrl + b0 + b1 q + b2 qdot,
    forcerange), with ctrl clipped to its range, as generalized forces
    (nv,)."""
    out = torch.zeros(model.nv, dtype=qpos.dtype, device=qpos.device)
    if model.nu == 0:
        return out
    dof = list(model.actuator_dof)
    qadr = [constraint.dof_qposadr(model, d) for d in dof]
    cr, fr = model.actuator_ctrlrange, model.actuator_forcerange
    ctrl = torch.clamp(ctrl, cr[:, 0], cr[:, 1])
    bias = model.actuator_bias
    force = (model.actuator_gain * ctrl + bias[:, 0] + bias[:, 1] * qpos[qadr]
             + bias[:, 2] * qvel[dof])
    force = torch.clamp(force, fr[:, 0], fr[:, 1])
    return out.index_add(0, torch.as_tensor(dof, device=out.device), force)


def _unbatch1(tree):
    """A dataclass of (1, ...) leaves as one env's (static leaves kept)."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name)[0] for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def forward(model: Model, state: State):
    """Forward dynamics of one env -> (qacc, aux): M, the frames, the smooth
    forces and acceleration, the contacts, the constraint rows, their
    forces and qfrc_constraint.  The body frames come from ``state`` (make
    _state and step keep them in sync with qpos)."""
    qpos, qvel, ctrl = state.qpos, state.qvel, state.ctrl
    mask = torch.as_tensor(kinematics.ancestor_mask(model), dtype=qpos.dtype,
                           device=qpos.device)
    xpos, xquat = state.xpos, state.xquat
    M, S, anchor = inertia.crba(model, xpos, xquat, mask)
    bias = inertia.bias_force(model, xpos, xquat, qvel, S, mask, anchor)
    qfrc_smooth = (actuator_force(model, qpos, qvel, ctrl)
                   - model.dof_damping * qvel - bias)
    qacc_smooth = linalg_small.solve_spd_small(M, qfrc_smooth)
    contacts = collision.collide(model, xpos[None], xquat[None])
    efc = _unbatch1(constraint.make_efc(model, qpos[None], qvel[None],
                                        S[None], anchor[None], contacts))
    qacc, efc_force = solver.solve(model, M, qacc_smooth, efc,
                                   warmstart=state.qacc_warmstart)
    aux = dict(M=M, xpos=xpos, xquat=xquat, qfrc_smooth=qfrc_smooth,
               qacc_smooth=qacc_smooth, contacts=_unbatch1(contacts),
               efc=efc, efc_force=efc_force,
               qfrc_constraint=solver.constraint_force(efc, efc_force,
                                                       model.nv))
    return qacc, aux


def _integrate_pos(model: Model, qpos, qvel, h):
    out = []
    for j in range(model.njnt):
        adr, dadr = model.jnt_qposadr[j], model.jnt_dofadr[j]
        if model.jnt_type[j] == JNT_FREE:
            out.append(qpos[adr:adr + 3] + h * qvel[dadr:dadr + 3])
            out.append(mu.quat_integrate(qpos[adr + 3:adr + 7],
                                         qvel[dadr + 3:dadr + 6], h))
        else:
            out.append(qpos[adr:adr + 1] + h * qvel[dadr:dadr + 1])
    return torch.cat(out)


def step(model: Model, state: State) -> State:
    """One physics step of one env: ``forward``, then semi-implicit Euler
    with implicit joint damping, (M + h D) v' = M v + h D v + h M qacc."""
    h = model.timestep
    qacc, aux = forward(model, state)
    M = aux["M"]
    rhs = (M @ (state.qvel + h * qacc)
           + h * model.dof_damping * state.qvel)
    MhD = M + h * torch.diag(model.dof_damping)
    qvel_new = linalg_small.solve_spd_small(MhD, rhs)
    qpos_new = _integrate_pos(model, state.qpos, qvel_new, h)
    xpos, xquat = kinematics.fk(model, qpos_new)
    return state.replace(qpos=qpos_new, qvel=qvel_new, time=state.time + h,
                         xpos=xpos, xquat=xquat, qacc_warmstart=qacc)
