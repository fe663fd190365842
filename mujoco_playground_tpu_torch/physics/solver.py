"""The constraint solve of one env: dense Newton in acceleration space over
structured rows (the port of the JAX package's ``physics/solver.py``).

Minimizes MuJoCo's convex soft-constraint objective

    Phi(a) = 1/2 (a - a_smooth)^T M (a - a_smooth) + sum_i s_i(J_i a - aref_i)

with per-row piecewise-quadratic costs s_i: two-sided quadratic
(equality), Huber (dof friction), one-sided quadratic (limits and the
contact pyramid).  Joint rows (1-2 nonzeros each) are packed into a dense
G (nj, nv); each contact contributes its three Jacobian rows B = [Jn; Jt1;
Jt2] and its pyramid through a 3x3 weight matrix, H += B^T W B.  Fixed
iteration counts.  The per-env step (``engine.forward``) runs it on one
env's rows, in plain PyTorch on the caller's device; the batched steps
solve through kernel K1 (fused) or K3 (staged).  Warm started, it makes
MuJoCo's pick between the previous solution and the smooth acceleration
(``mj_warmstart``), as the staged step does.
"""
from __future__ import annotations

import torch

from mujoco_playground_tpu_torch.physics import linalg_small
from mujoco_playground_tpu_torch.physics.constraint import EQ, FRICTION, Efc


def _joint_G(efc: Efc, nv):
    """(nj, nv) dense joint-row Jacobian from the structured coefficients."""
    nj = efc.j_coef1.shape[-1]
    dt = dict(dtype=efc.j_coef1.dtype, device=efc.j_coef1.device)
    P1 = torch.zeros((nj, nv), **dt)
    P2 = torch.zeros((nj, nv), **dt)
    r = torch.arange(nj, device=P1.device)
    P1[r, torch.as_tensor(efc.j_dof1, device=P1.device)] = 1.0
    P2[r, torch.as_tensor(efc.j_dof2, device=P1.device)] = 1.0
    return efc.j_coef1[:, None] * P1 + efc.j_coef2[:, None] * P2


def _joint_forces(efc: Efc, x, masks):
    is_eq, is_fric = masks
    raw = -x / efc.j_R
    f = torch.where(is_eq, raw, torch.where(
        is_fric, torch.clamp(raw, -efc.j_floss, efc.j_floss),
        torch.clamp_min(raw, 0.0)))
    f = f * efc.j_active
    quad = torch.where(is_eq, 1.0, torch.where(
        is_fric, (torch.abs(raw) < efc.j_floss).to(x.dtype),
        (x < 0).to(x.dtype)))
    return f, quad * efc.j_active


def _contact_forces(efc: Efc, x4):
    """x4 (C, 4) pyramid-row values -> (f4, quad4)."""
    raw = -x4 / efc.c_R[:, None]
    f = torch.clamp_min(raw, 0.0) * efc.c_active[:, None]
    quad = (x4 < 0).to(x4.dtype) * efc.c_active[:, None]
    return f, quad


def _pyr4(efc: Efc, an, at1, at2):
    mu_ = efc.c_mu
    return torch.stack([an + mu_ * at1, an - mu_ * at1,
                        an + mu_ * at2, an - mu_ * at2], dim=-1)


def solve(model, M, qacc_smooth, efc: Efc, iterations=None,
          ls_iterations=None, warmstart=None):
    """Newton solve of one env -> (qacc, (joint_forces, contact_forces4)).

    M (nv, nv), qacc_smooth (nv,), efc with one env's leaves (j_* (nj,),
    c_* (C, ...)).  ``warmstart`` (nv,): the previous step's qacc; Newton
    starts from the cheaper of it and qacc_smooth (MuJoCo's
    ``mj_warmstart``).  The objective stays anchored at qacc_smooth."""
    iterations = iterations or model.solver_iterations
    ls_iterations = ls_iterations or model.ls_iterations
    dtype, dev = qacc_smooth.dtype, qacc_smooth.device
    nv = qacc_smooth.shape[-1]
    kind = torch.as_tensor(efc.j_kind, device=dev)
    masks = (kind == EQ, kind == FRICTION)
    G = _joint_G(efc, nv)
    jRinv = 1.0 / efc.j_R
    cRinv = 1.0 / efc.c_R
    mu_ = efc.c_mu
    Bm = torch.stack([efc.c_Jn, efc.c_Jt1, efc.c_Jt2], dim=1)  # (C, 3, nv)
    C3 = Bm.shape[0] * 3
    Bflat = Bm.reshape(C3, nv)
    eye_reg = 1e-9 * torch.eye(nv, dtype=dtype, device=dev)

    def row_values(a):
        xj = G @ a - efc.j_aref
        av = Bm @ a                                              # (C, 3)
        return xj, _pyr4(efc, av[:, 0], av[:, 1], av[:, 2]) - efc.c_aref

    def jt_f(fj, f4):
        fn = f4.sum(-1)
        ft1 = mu_ * (f4[:, 0] - f4[:, 1])
        ft2 = mu_ * (f4[:, 2] - f4[:, 3])
        fB = torch.stack([fn, ft1, ft2], dim=-1)                 # (C, 3)
        return G.T @ fj + fB.reshape(-1) @ Bflat

    def newton_iter(a):
        xj, x4 = row_values(a)
        fj, quadj = _joint_forces(efc, xj, masks)
        f4, quad4 = _contact_forces(efc, x4)
        grad = M @ (a - qacc_smooth) - jt_f(fj, f4)

        # Hessian: M + G^T diag(wj) G + sum_c B^T W B
        wj = quadj * jRinv
        H = M + eye_reg + (G * wj[:, None]).T @ G
        w4 = quad4 * cRinv[:, None]                              # (C, 4)
        w01 = w4[:, 0] + w4[:, 1]
        w23 = w4[:, 2] + w4[:, 3]
        W00 = w01 + w23
        W01 = mu_ * (w4[:, 0] - w4[:, 1])
        W02 = mu_ * (w4[:, 2] - w4[:, 3])
        W11 = mu_ * mu_ * w01
        W22 = mu_ * mu_ * w23
        zero = torch.zeros_like(W00)
        W = torch.stack([torch.stack([W00, W01, W02], -1),
                         torch.stack([W01, W11, zero], -1),
                         torch.stack([W02, zero, W22], -1)], -2)  # (C, 3, 3)
        H = H + Bflat.T @ (W @ Bm).reshape(C3, nv)

        L = linalg_small.cholesky_small(H)
        delta = -linalg_small.cho_solve_small(L, grad)

        # 1-D Newton line search on the piecewise-quadratic restriction
        jdj = G @ delta
        dv = Bm @ delta
        jd4 = _pyr4(efc, dv[:, 0], dv[:, 1], dv[:, 2])
        dMd = delta @ (M @ delta)
        dM_as = delta @ (M @ (a - qacc_smooth))
        alpha = torch.ones((), dtype=dtype, device=dev)
        for _ in range(ls_iterations):
            fj_a, quadj_a = _joint_forces(efc, xj + alpha * jdj, masks)
            f4_a, quad4_a = _contact_forces(efc, x4 + alpha * jd4)
            dphi = (dM_as + alpha * dMd - (jdj * fj_a).sum()
                    - (jd4 * f4_a).sum())
            ddphi = (dMd + (quadj_a * jRinv * jdj * jdj).sum()
                     + (quad4_a * cRinv[:, None] * jd4 * jd4).sum())
            alpha = torch.clamp(alpha - dphi / torch.clamp_min(ddphi, 1e-12),
                                0.0, 2.0)
        return a + alpha * delta

    def primal_cost(a):
        """MuJoCo's primal objective Phi(a) (module docstring)."""
        xj, x4 = row_values(a)
        is_eq, is_fric = masks
        quad_j = 0.5 * xj * xj * jRinv
        lin_j = (efc.j_floss * torch.abs(xj)
                 - 0.5 * efc.j_floss * efc.j_floss * efc.j_R)
        cost_j = torch.where(is_eq, quad_j, torch.where(
            is_fric, torch.where(torch.abs(xj) * jRinv < efc.j_floss,
                                 quad_j, lin_j),
            torch.where(xj < 0, quad_j, 0.0)))
        cc = torch.where(x4 < 0, 0.5 * x4 * x4 * cRinv[:, None], 0.0)
        da = a - qacc_smooth
        return (0.5 * da @ (M @ da) + (cost_j * efc.j_active).sum()
                + (cc * efc.c_active[:, None]).sum())

    if warmstart is None:
        a = qacc_smooth
    else:
        a = torch.where(primal_cost(warmstart) < primal_cost(qacc_smooth),
                        warmstart, qacc_smooth)
    for _ in range(iterations):
        a = newton_iter(a)
    xj, x4 = row_values(a)
    fj, _ = _joint_forces(efc, xj, masks)
    f4, _ = _contact_forces(efc, x4)
    return a, (fj, f4)


def constraint_force(efc: Efc, forces, nv, dtype=None):
    """qfrc_constraint (nv,) = J^T f of one env's forces (``solve``'s
    second output)."""
    fj, f4 = forces
    G = _joint_G(efc, nv)
    fn = f4.sum(-1)
    ft1 = efc.c_mu * (f4[:, 0] - f4[:, 1])
    ft2 = efc.c_mu * (f4[:, 2] - f4[:, 3])
    Bm = torch.stack([efc.c_Jn, efc.c_Jt1, efc.c_Jt2], dim=1)
    fB = torch.stack([fn, ft1, ft2], dim=-1)
    return G.T @ fj + fB.reshape(-1) @ Bm.reshape(-1, nv)
