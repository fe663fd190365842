"""Batch-last Newton constraint solve of the staged step (the port of the
JAX package's ``physics/solver_batched.py``).

``newton_args`` lays the batch-first ``Efc`` rows out batch-last as kernel
K3 (``ops/newton.py`` ``newton_solve``: the CUDA kernel on CUDA tensors,
its plain twin on CPU tensors) takes them; ``solve_batched`` runs K3 on
them.  ``final_forces`` computes the constraint forces at the solution in
plain PyTorch, as the JAX ``_solve_pallas`` does after its kernel; the step
does not need them, so it is a separate pass.
"""
from __future__ import annotations

import torch

from mujoco_playground_tpu_torch.ops.newton import newton_solve
from mujoco_playground_tpu_torch.physics.constraint import EQ, FRICTION, Efc


def _transpose_efc(efc: Efc, nv: int):
    """Batch-first Efc (leaves (B, ...)) -> contiguous batch-last arrays;
    the joint rows as a dense G (nj, nv, B)."""
    def bl(x):
        return torch.movedim(x, 0, -1).contiguous()

    nj = efc.j_coef1.shape[-1]
    dt = dict(dtype=efc.j_coef1.dtype, device=efc.j_coef1.device)
    P1 = torch.zeros((nj, nv), **dt)
    P2 = torch.zeros((nj, nv), **dt)
    r = torch.arange(nj, device=P1.device)
    P1[r, torch.as_tensor(efc.j_dof1, device=P1.device)] = 1.0
    P2[r, torch.as_tensor(efc.j_dof2, device=P1.device)] = 1.0
    G = (bl(efc.j_coef1)[:, None, :] * P1[:, :, None]
         + bl(efc.j_coef2)[:, None, :] * P2[:, :, None])      # (nj, nv, B)
    return dict(G=G.contiguous(), j_aref=bl(efc.j_aref), j_R=bl(efc.j_R),
                j_floss=bl(efc.j_floss), j_active=bl(efc.j_active),
                Jn=bl(efc.c_Jn), Jt1=bl(efc.c_Jt1), Jt2=bl(efc.c_Jt2),
                c_aref=bl(efc.c_aref), c_R=bl(efc.c_R), c_mu=bl(efc.c_mu),
                c_active=bl(efc.c_active))


def newton_args(model, M_bl, qacc_smooth_bl, efc: Efc, iterations=None,
                ls_iterations=None):
    """K3's positional arguments (``ops/newton.py`` ``newton_solve``) for
    M_bl (nv, nv, B), qacc_smooth_bl (nv, B) and efc with (B, ...) leaves:
    the batch-last arrays, the row kinds and the iteration counts."""
    nv = qacc_smooth_bl.shape[0]
    e = _transpose_efc(efc, nv)
    return (M_bl.contiguous(), qacc_smooth_bl.contiguous(), e["G"],
            e["j_aref"], e["j_R"], e["j_floss"], e["j_active"], efc.j_kind,
            e["Jn"], e["Jt1"], e["Jt2"], e["c_aref"], e["c_R"], e["c_mu"],
            e["c_active"], iterations or model.solver_iterations,
            ls_iterations or model.ls_iterations)


def solve_batched(model, M, qacc_smooth, efc: Efc, iterations=None,
                  ls_iterations=None, warmstart=None):
    """Batched Newton solve: M (B, nv, nv), qacc_smooth (B, nv), efc with
    (B, ...) leaves; ``warmstart`` (B, nv) starts Newton with MuJoCo's
    two-sided pick.  Returns qacc (B, nv)."""
    args = newton_args(model, torch.movedim(M, 0, -1), qacc_smooth.T, efc,
                       iterations, ls_iterations)
    return newton_solve(
        *args, warmstart=None if warmstart is None
        else warmstart.T.contiguous()).T


def final_forces(efc: Efc, qacc):
    """The constraint forces at the solution qacc (B, nv), one plain pass
    (diagnostics; the step needs only qacc): (fj (B, nj), f4 (B, C, 4),
    qfrc_constraint (B, nv))."""
    e = _transpose_efc(efc, qacc.shape[-1])
    a = qacc.T
    is_eq = torch.as_tensor(efc.j_kind == EQ, device=a.device)[:, None]
    is_fric = torch.as_tensor(efc.j_kind == FRICTION, device=a.device)[:, None]
    G, Jn, Jt1, Jt2 = e["G"], e["Jn"], e["Jt1"], e["Jt2"]
    mu_ = e["c_mu"]

    def mv(mat, v):
        return (mat * v[None]).sum(1)

    xj = mv(G, a) - e["j_aref"]
    an, at1, at2 = mv(Jn, a), mv(Jt1, a), mv(Jt2, a)
    x4 = torch.stack([an + mu_ * at1, an - mu_ * at1,
                      an + mu_ * at2, an - mu_ * at2], 1) - e["c_aref"]
    raw = -xj / e["j_R"]
    fj = torch.where(is_eq, raw, torch.where(
        is_fric, torch.clamp(raw, -e["j_floss"], e["j_floss"]),
        torch.clamp_min(raw, 0.0))) * e["j_active"]
    f4 = (torch.clamp_min(-x4 / e["c_R"][:, None], 0.0)
          * e["c_active"][:, None])
    fn = f4.sum(1)
    ft1 = mu_ * (f4[:, 0] - f4[:, 1])
    ft2 = mu_ * (f4[:, 2] - f4[:, 3])
    qfrc = ((G * fj[:, None]).sum(0) + (Jn * fn[:, None]).sum(0)
            + (Jt1 * ft1[:, None]).sum(0) + (Jt2 * ft2[:, None]).sum(0)).T
    return torch.movedim(fj, -1, 0), torch.movedim(f4, -1, 0), qfrc
