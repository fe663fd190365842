"""Batch-last constraint assembly in kernel K3's own layout (the port of the
JAX package's ``physics/constraint_bl.py``).

The same rows and formulas as :mod:`constraint` (``make_efc``), but every
array comes out with the env batch last and the dof axis first: Gt
(nv, nj, B), Jnt / Jt1t / Jt2t (nv, C, B), c_aref4 (4, C, B), as
``ops/newton.py`` ``newton_solve(..., pre_transposed=True)`` takes them,
with no copy between the assembly and the kernel.  ``make_efc`` builds
(B, C, nv, 3) point Jacobians and ``solver_batched.newton_args`` moves them
to (C, nv, B); here the (nv, C, B) rows are built in place.

The contacts come from the batched ``collision.collide`` ((B, C, ...)
leaves); the slot-to-body map is static, so the dof mask has no batch
axis.  Like the JAX function, this reads every model leaf as unbatched:
domain randomization does not reach it, and a model with randomized leaves
is refused (the staged step's ``make_efc`` takes each env's leaves).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mujoco_playground_tpu_torch.physics import kinematics
from mujoco_playground_tpu_torch.physics.collision import Contacts
from mujoco_playground_tpu_torch.physics.constraint import (CONE, EQ,
                                                            FRICTION,
                                                            dof_qposadr,
                                                            impedance, kbi)
from mujoco_playground_tpu_torch.physics.model import Model, env_count


def make_efc_bl(model: Model, qpos_bl, qvel_bl, S_bl, anchor_bl,
                contacts: Contacts) -> Dict:
    """Batch-last efc arrays in kernel K3's layout.

    Args:
      qpos_bl (nq, B); qvel_bl (nv, B); S_bl (nv, 6, B) about anchor_bl
      (3, B); contacts: the batch's Contacts ((B, C, ...) leaves, slot
      statics shared by every env).

    Returns a dict: Gt (nv, nj, B), j_aref / j_R / j_floss / j_active
    (nj, B), j_kind (static), Jnt / Jt1t / Jt2t (nv, C, B), c_aref4
    (4, C, B), c_R / c_mu / c_active (C, B); every tensor contiguous.
    """
    if env_count(model) != 1 or contacts.friction.shape[0] != 1:
        raise ValueError("make_efc_bl reads the model's leaves unbatched: "
                         "a randomized model takes constraint.make_efc")
    dt = dict(dtype=qpos_bl.dtype, device=qpos_bl.device)
    out = _joint_rows_bl(model, qpos_bl, qvel_bl)

    # per dof and slot, whether the dof moves the slot's body: (nv, C, 1)
    mask_vc = torch.as_tensor(
        kinematics.ancestor_mask(model)[np.asarray(contacts.body)].T,
        **dt)[:, :, None]
    # the contacts batch-last, contiguous, so that every row built from
    # them comes out contiguous in the kernel layout
    pos = contacts.pos.permute(1, 2, 0).contiguous()   # (C, 3, B)
    frame = contacts.frame.permute(1, 2, 3, 0).contiguous()  # (C, 3, 3, B)
    dist = contacts.dist.T.contiguous()                # (C, B)
    mu_ = contacts.friction.T                          # (C, 1)
    solref = contacts.solref[0]                        # (C, 2)
    solimp = contacts.solimp[0]                        # (C, 5)
    diag_c = contacts.diag_approx.T                    # (C, 1)

    S_bl = S_bl.contiguous()
    S_ang, S_lin = S_bl[:, :3], S_bl[:, 3:]            # (nv, 3, B)
    arm = pos - anchor_bl[None]                        # (C, 3, B)
    # Jp[v, c, k, b] = S_lin[v, k] + (S_ang[v] x arm[c])_k, masked
    a1, a2, a3 = (S_ang[:, k, None] for k in range(3))   # (nv, 1, B)
    r1, r2, r3 = (arm[None, :, k] for k in range(3))     # (1, C, B)
    Jx = (S_lin[:, 0, None] + (a2 * r3 - a3 * r2)) * mask_vc  # (nv, C, B)
    Jy = (S_lin[:, 1, None] + (a3 * r1 - a1 * r3)) * mask_vc
    Jz = (S_lin[:, 2, None] + (a1 * r2 - a2 * r1)) * mask_vc

    def project(axis):
        n1, n2, n3 = (frame[None, :, axis, k] for k in range(3))
        return Jx * n1 + Jy * n2 + Jz * n3             # (nv, C, B)

    Jn, Jt1, Jt2 = project(0), project(1), project(2)

    act = (dist < 0).to(qpos_bl.dtype)
    d_imp = impedance(solimp[:, None], dist)           # (C, B)
    dmax = solimp[:, 1, None]
    tc, zeta = solref[:, 0, None], solref[:, 1, None]
    bcoef = 2.0 / (dmax * tc)
    kcoef = d_imp / (dmax * dmax * tc * tc * zeta * zeta)
    diag = torch.clamp_min(diag_c * 2.0 * mu_ ** 2 * (1.0 + mu_ ** 2), 1e-12)
    Rrow = torch.clamp_min((1.0 - d_imp) / d_imp * diag, 1e-10)
    vn = (Jn * qvel_bl[:, None]).sum(0)                # (C, B)
    vt1 = (Jt1 * qvel_bl[:, None]).sum(0)
    vt2 = (Jt2 * qvel_bl[:, None]).sum(0)
    vel4 = torch.stack([vn + mu_ * vt1, vn - mu_ * vt1,
                        vn + mu_ * vt2, vn - mu_ * vt2])  # (4, C, B)
    aref4 = -bcoef[None] * vel4 - (kcoef * dist)[None]

    out.update(Jnt=Jn, Jt1t=Jt1, Jt2t=Jt2, c_aref4=aref4, c_R=Rrow,
               c_mu=mu_.expand(dist.shape).contiguous(), c_active=act)
    return out


def _joint_rows_bl(model: Model, qpos_bl, qvel_bl) -> Dict:
    """Joint rows only (equality / dof friction / limits), batch-last, with
    G in the kernel layout (nv, nj, B)."""
    dt = dict(dtype=qpos_bl.dtype, device=qpos_bl.device)
    nv, B = model.nv, qpos_bl.shape[-1]
    iw = model.dof_invweight0
    one, zero = torch.ones(B, **dt), torch.zeros(B, **dt)
    dof1_l, dof2_l, c1_l, c2_l = [], [], [], []
    aref_l, R_l, fl_l, act_l, kind_l = [], [], [], [], []

    for e, (d1, d2) in enumerate(model.eq_dof_pairs):
        q1adr, q2adr = dof_qposadr(model, d1), dof_qposadr(model, d2)
        q1 = qpos_bl[q1adr] - model.qpos0[q1adr]
        q2 = qpos_bl[q2adr] - model.qpos0[q2adr]
        coef = model.eq_polycoef[e]
        poly = (coef[0] + coef[1] * q2 + coef[2] * q2 ** 2
                + coef[3] * q2 ** 3 + coef[4] * q2 ** 4)
        dpoly = (coef[1] + 2 * coef[2] * q2 + 3 * coef[3] * q2 ** 2
                 + 4 * coef[4] * q2 ** 3)
        aref, d = kbi(model.eq_solref[e], model.eq_solimp[e], q1 - poly,
                      qvel_bl[d1] - dpoly * qvel_bl[d2])
        dof1_l.append(d1)
        dof2_l.append(d2)
        c1_l.append(one)
        c2_l.append(-dpoly)
        aref_l.append(aref)
        R_l.append(torch.clamp_min((1.0 - d) / d * (iw[d1] + iw[d2]), 1e-10)
                   * one)
        fl_l.append(zero)
        act_l.append(one)
        kind_l.append(EQ)

    solref0 = torch.tensor([0.02, 1.0], **dt)
    solimp0 = torch.tensor([0.9, 0.95, 0.001, 0.5, 2.0], **dt)
    for d1 in model.friction_dofs:
        aref, d = kbi(solref0, solimp0, torch.zeros((), **dt), qvel_bl[d1])
        dof1_l.append(d1)
        dof2_l.append(0)
        c1_l.append(one)
        c2_l.append(zero)
        aref_l.append(aref)
        R_l.append(torch.clamp_min((1.0 - d) / d * iw[d1], 1e-10) * one)
        fl_l.append(model.dof_frictionloss[d1] * one)
        act_l.append(one)
        kind_l.append(FRICTION)

    for d1 in model.limited_dofs:
        jid = model.dof_jnt[d1]
        qadr = dof_qposadr(model, d1)
        for side in (0, 1):
            if side == 0:
                dist = qpos_bl[qadr] - model.jnt_range[jid, 0]
                coef = one
            else:
                dist = model.jnt_range[jid, 1] - qpos_bl[qadr]
                coef = -one
            aref, d = kbi(model.jnt_solref_limit[jid],
                          model.jnt_solimp_limit[jid],
                          torch.clamp_max(dist, 0.0), coef * qvel_bl[d1])
            dof1_l.append(d1)
            dof2_l.append(0)
            c1_l.append(coef)
            c2_l.append(zero)
            aref_l.append(aref)
            R_l.append(torch.clamp_min((1.0 - d) / d * iw[d1], 1e-10))
            fl_l.append(zero)
            act_l.append((dist < 0).to(qpos_bl.dtype))
            kind_l.append(CONE)

    nj = len(dof1_l)

    def stk(xs):
        # a model without equality/friction/limit rows has no joint rows
        return torch.stack(xs) if xs else torch.zeros((0, B), **dt)

    P1 = torch.zeros((nv, nj, 1), **dt)
    P2 = torch.zeros((nv, nj, 1), **dt)
    P1[dof1_l, range(nj)] = 1.0
    P2[dof2_l, range(nj)] = 1.0
    Gt = P1 * stk(c1_l)[None] + P2 * stk(c2_l)[None]   # (nv, nj, B)
    return dict(Gt=Gt, j_aref=stk(aref_l), j_R=stk(R_l),
                j_floss=stk(fl_l), j_active=stk(act_l),
                j_kind=np.asarray(kind_l, np.int64))
