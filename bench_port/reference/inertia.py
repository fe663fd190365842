"""Mass matrix (CRBA) of one env and the compile-time invweight0 constants
(frozen from the port's ``physics/inertia.py``).

M = sum_b J_b^T I_b J_b with the static (nbody, nv) ancestor mask; spatial
quantities are anchored at the root body's position.
"""
from __future__ import annotations

import torch

from . import kinematics, mathutil as mu
from .model import Model


def body_spatial_inertia(model: Model, xpos, xquat, anchor):
    """(nbody, 6, 6) spatial inertias about the common anchor."""
    R = mu.quat_to_mat(mu.quat_mul(xquat, model.body_iquat))
    inertia_world = torch.einsum('bij,bj,bkj->bik', R, model.body_inertia, R)
    com = xpos + mu.quat_rotate(xquat, model.body_ipos)
    return mu.spatial_inertia(model.body_mass, inertia_world, com - anchor)


def crba(model: Model, xpos, xquat, mask):
    """Dense joint-space mass matrix M (nv, nv) incl. armature, for one env;
    returns (M, S, anchor)."""
    anchor = xpos[1] if model.nbody > 1 else xpos.new_zeros(3)
    S = kinematics.motion_subspace(model, xpos, xquat, anchor)
    Ibar = body_spatial_inertia(model, xpos, xquat, anchor)
    J = torch.einsum('dk,bd->bkd', S, mask)
    M = torch.einsum('bki,bkl,blj->ij', J, Ibar, J)
    return M + torch.diag(model.dof_armature), S, anchor


def invweight0(model: Model):
    """Twin of MuJoCo's mj_setConst invweight0 at qpos0: per body the mean
    diagonal of J M^-1 J^T over its 3 translational (at the CoM) and 3
    rotational rows, (nbody, 2); per dof diag(M^-1), (nv,)."""
    mask = torch.as_tensor(kinematics.ancestor_mask(model), dtype=model.dtype)
    xpos, xquat = kinematics.fk(model, model.qpos0)
    M, S, anchor = crba(model, xpos, xquat, mask)
    Minv = torch.linalg.inv(M)
    com = xpos + mu.quat_rotate(xquat, model.body_ipos)
    body_iw = [xpos.new_zeros(2)]
    for b in range(1, model.nbody):
        Jt = kinematics.point_jacobian(S, com[b], anchor) * mask[b][:, None]
        Jr = S[:, :3] * mask[b][:, None]
        body_iw.append(torch.stack([
            torch.trace(Jt.T @ Minv @ Jt) / 3,
            torch.trace(Jr.T @ Minv @ Jr) / 3]))
    return torch.stack(body_iw), torch.diagonal(Minv)
