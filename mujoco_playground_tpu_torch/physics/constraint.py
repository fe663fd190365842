"""Constraint assembly: MuJoCo-compatible efc rows in structured form,
batched over envs (the port of the JAX package's ``physics/constraint.py``).

* Joint rows (equality / dof friction / joint limit) have 1-2 nonzeros:
  J = coef1 * e_dof1 + coef2 * e_dof2.
* Contact rows come in pyramid quadruples sharing one geometry: row =
  Jn +- mu * Jt; only (Jn, Jt1, Jt2) are materialized.

MuJoCo's constants: impedance spline; aref = -b*Jv - K*pos with b =
2/(dmax*tc), K = d(r)/(dmax^2 tc^2 zeta^2); R = (1-d)/d * diagApprox;
pyramidal diagApprox = iw * 2 mu^2 (1+mu^2); pyramid row order [n+mu t1,
n-mu t1, n+mu t2, n-mu t2].  Inactive rows (separated contacts, unviolated
limits) are masked, not removed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_playground_tpu_torch.physics import kinematics
from mujoco_playground_tpu_torch.physics.collision import Contacts
from mujoco_playground_tpu_torch.physics.model import (Model, env_count,
                                                       env_leaf)

# Row kinds (static codes).
EQ = 0        # two-sided quadratic
FRICTION = 1  # box-bounded (dry friction)
CONE = 2      # one-sided (limits; contact rows are implicitly CONE)


@dataclasses.dataclass
class Efc:
    """Structured constraint rows of a batch of envs."""
    j_dof1: np.ndarray       # (nj,) static
    j_dof2: np.ndarray       # (nj,) static
    j_coef1: torch.Tensor    # (B, nj)
    j_coef2: torch.Tensor    # (B, nj), 0 where unused
    j_aref: torch.Tensor     # (B, nj)
    j_R: torch.Tensor        # (B, nj)
    j_floss: torch.Tensor    # (B, nj)
    j_active: torch.Tensor   # (B, nj)
    j_kind: np.ndarray       # (nj,) static kind codes
    c_Jn: torch.Tensor       # (B, C, nv)
    c_Jt1: torch.Tensor      # (B, C, nv)
    c_Jt2: torch.Tensor      # (B, C, nv)
    c_aref: torch.Tensor     # (B, C, 4) per pyramid row
    c_R: torch.Tensor        # (B, C), shared by the 4 rows
    c_mu: torch.Tensor       # (B, C)
    c_active: torch.Tensor   # (B, C)


def impedance(solimp, r):
    """MuJoCo impedance spline d(r): solimp = [d0, dmax, width, mid,
    power] in the last axis."""
    d0, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(torch.abs(r) / torch.clamp_min(width, 1e-12), 0.0, 1.0)
    a = 1.0 / torch.pow(mid, power - 1.0)
    b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
    y = torch.where(x <= mid, a * torch.pow(x, power),
                    1.0 - b * torch.pow(1.0 - x, power))
    return d0 + y * (dmax - d0)


def kbi(solref, solimp, pos, vel):
    """(aref, d) of a row: reference acceleration and impedance."""
    d = impedance(solimp, pos)
    dmax = solimp[..., 1]
    tc, zeta = solref[..., 0], solref[..., 1]
    b = 2.0 / (dmax * tc)
    k = d / (dmax * dmax * tc * tc * zeta * zeta)
    return -b * vel - k * pos, d


def dof_qposadr(model: Model, dof: int) -> int:
    jid = model.dof_jnt[dof]
    return model.jnt_qposadr[jid] + (dof - model.jnt_dofadr[jid])


def make_efc(model: Model, qpos, qvel, S, anchor, contacts: Contacts) -> Efc:
    """Rows of a batch: qpos (B, nq), qvel (B, nv), S (B, nv, 6) about
    anchor (B, 3), and the batch's contacts.  ``model`` may carry a leading
    env axis of B on any leaf (domain randomization): every field is read
    through ``env_leaf``, so each env's rows take its own values."""
    B = qpos.shape[0]
    E = env_count(model)

    def P(name):
        return env_leaf(model, name, E)

    dt = dict(dtype=qpos.dtype, device=qpos.device)
    qpos0, iw = P("qpos0"), P("dof_invweight0")
    one = torch.ones(B, **dt)
    zero = torch.zeros(B, **dt)
    dof1_l, dof2_l, c1_l, c2_l = [], [], [], []
    aref_l, R_l, fl_l, act_l, kind_l = [], [], [], [], []

    # equality: joint couplings q1 = poly(q2)
    for e, (d1, d2) in enumerate(model.eq_dof_pairs):
        q1adr, q2adr = dof_qposadr(model, d1), dof_qposadr(model, d2)
        q2 = qpos[:, q2adr] - qpos0[:, q2adr]
        coef = P("eq_polycoef")[:, e].unbind(-1)
        poly = (coef[0] + coef[1] * q2 + coef[2] * q2 ** 2
                + coef[3] * q2 ** 3 + coef[4] * q2 ** 4)
        dpoly = (coef[1] + 2 * coef[2] * q2 + 3 * coef[3] * q2 ** 2
                 + 4 * coef[4] * q2 ** 3)
        pos = (qpos[:, q1adr] - qpos0[:, q1adr]) - poly
        vel = qvel[:, d1] - dpoly * qvel[:, d2]
        aref, d = kbi(P("eq_solref")[:, e], P("eq_solimp")[:, e], pos, vel)
        diag = iw[:, d1] + iw[:, d2]
        dof1_l.append(d1)
        dof2_l.append(d2)
        c1_l.append(one)
        c2_l.append(-dpoly)
        aref_l.append(aref)
        R_l.append(torch.clamp_min((1.0 - d) / d * diag, 1e-10))
        fl_l.append(zero)
        act_l.append(one)
        kind_l.append(EQ)

    # dof friction loss
    solref0 = torch.tensor([0.02, 1.0], **dt)
    solimp0 = torch.tensor([0.9, 0.95, 0.001, 0.5, 2.0], **dt)
    for d1 in model.friction_dofs:
        aref, d = kbi(solref0, solimp0, zero, qvel[:, d1])
        dof1_l.append(d1)
        dof2_l.append(0)
        c1_l.append(one)
        c2_l.append(zero)
        aref_l.append(aref)
        R_l.append(torch.clamp_min((1.0 - d) / d * iw[:, d1], 1e-10))
        fl_l.append(P("dof_frictionloss")[:, d1].expand(B))
        act_l.append(one)
        kind_l.append(FRICTION)

    # joint limits, lower and upper side per limited dof
    for d1 in model.limited_dofs:
        jid = model.dof_jnt[d1]
        qadr = dof_qposadr(model, d1)
        rng = P("jnt_range")[:, jid]
        for side in (0, 1):
            if side == 0:
                dist = qpos[:, qadr] - rng[:, 0]
                coef = one
            else:
                dist = rng[:, 1] - qpos[:, qadr]
                coef = -one
            aref, d = kbi(P("jnt_solref_limit")[:, jid],
                          P("jnt_solimp_limit")[:, jid],
                          torch.clamp_max(dist, 0.0), coef * qvel[:, d1])
            dof1_l.append(d1)
            dof2_l.append(0)
            c1_l.append(coef)
            c2_l.append(zero)
            aref_l.append(aref)
            R_l.append(torch.clamp_min((1.0 - d) / d * iw[:, d1], 1e-10))
            fl_l.append(zero)
            act_l.append((dist < 0).to(qpos.dtype))
            kind_l.append(CONE)

    # contacts: the translational point Jacobian v(p) = S_lin + S_ang x
    # (p - anchor), masked to the dofs that move the slot's body
    nv = model.nv
    C = contacts.dist.shape[1]
    body_mask = torch.as_tensor(kinematics.ancestor_mask(model), **dt)[
        torch.as_tensor(contacts.body, device=qpos.device)]      # (C, nv)
    arm = contacts.pos[:, :, None, :] - anchor[:, None, None, :]
    Sb = S[:, None].expand(B, C, nv, 6)
    Jp = (Sb[..., 3:] + torch.linalg.cross(Sb[..., :3], arm.expand_as(
        Sb[..., 3:]))) * body_mask[None, :, :, None]           # (B, C, nv, 3)
    Jn = (Jp * contacts.frame[:, :, None, 0]).sum(-1)
    Jt1 = (Jp * contacts.frame[:, :, None, 1]).sum(-1)
    Jt2 = (Jp * contacts.frame[:, :, None, 2]).sum(-1)
    mu_ = contacts.friction
    act = (contacts.dist < 0).to(qpos.dtype)
    d_imp = impedance(contacts.solimp, contacts.dist)
    dmax = contacts.solimp[..., 1]
    tc, zeta = contacts.solref[..., 0], contacts.solref[..., 1]
    bcoef = 2.0 / (dmax * tc)
    kcoef = d_imp / (dmax * dmax * tc * tc * zeta * zeta)
    diag = torch.clamp_min(
        contacts.diag_approx * 2.0 * mu_ ** 2 * (1.0 + mu_ ** 2), 1e-12)
    Rrow = torch.clamp_min((1.0 - d_imp) / d_imp * diag, 1e-10)
    vn = (Jn * qvel[:, None]).sum(-1)
    vt1 = (Jt1 * qvel[:, None]).sum(-1)
    vt2 = (Jt2 * qvel[:, None]).sum(-1)
    vel4 = torch.stack([vn + mu_ * vt1, vn - mu_ * vt1,
                        vn + mu_ * vt2, vn - mu_ * vt2], dim=-1)
    aref4 = -bcoef[..., None] * vel4 - (kcoef * contacts.dist)[..., None]

    def stk(xs):
        # a model without equality/friction/limit rows has no joint rows
        return torch.stack(xs, 1) if xs else torch.zeros((B, 0), **dt)

    return Efc(
        j_dof1=np.asarray(dof1_l, np.int64),
        j_dof2=np.asarray(dof2_l, np.int64),
        j_coef1=stk(c1_l), j_coef2=stk(c2_l), j_aref=stk(aref_l),
        j_R=stk(R_l), j_floss=stk(fl_l), j_active=stk(act_l),
        j_kind=np.asarray(kind_l, np.int64),
        c_Jn=Jn, c_Jt1=Jt1, c_Jt2=Jt2, c_aref=aref4, c_R=Rrow,
        c_mu=mu_.expand(B, C), c_active=act)
