"""Forward kinematics and the motion subspace (MuJoCo ``mj_kinematics``
semantics: a free joint's qpos is the body's world pose, hinge axes live in
the body frame, a free joint's angular velocity is body-local).

These serve the model compiler and ``make_state``; the stepping path has
its own copy inside the step kernel and its plain twin (``ops/step.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from mujoco_playground_tpu_torch.physics import mathutil as mu
from mujoco_playground_tpu_torch.physics.model import (JNT_FREE, JNT_HINGE,
                                                       JNT_SLIDE, Model)


def fk(model: Model, qpos):
    """qpos (..., nq) -> (xpos (..., nbody, 3), xquat (..., nbody, 4))."""
    batch = qpos.shape[:-1]
    xpos = [qpos.new_zeros(batch + (3,))]
    xquat = [qpos.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(batch + (4,))]
    jnts_of = {b: [] for b in range(model.nbody)}
    for j in range(model.njnt):
        jnts_of[model.jnt_body[j]].append(j)
    for b in range(1, model.nbody):
        p = model.body_parent[b]
        pos = xpos[p] + mu.quat_rotate(xquat[p], model.body_pos[b])
        quat = mu.quat_mul(xquat[p], model.body_quat[b].expand(batch + (4,)))
        for j in jnts_of[b]:
            adr = model.jnt_qposadr[j]
            t = model.jnt_type[j]
            if t == JNT_FREE:
                pos = qpos[..., adr:adr + 3]
                q = qpos[..., adr + 3:adr + 7]
                quat = q / torch.linalg.norm(q, dim=-1, keepdim=True)
            elif t == JNT_HINGE:
                theta = qpos[..., adr] - model.qpos0[adr]
                anchor = pos + mu.quat_rotate(quat, model.jnt_pos[j])
                quat = mu.quat_mul(
                    quat, mu.quat_from_axis_angle(model.jnt_axis[j], theta))
                pos = anchor - mu.quat_rotate(quat, model.jnt_pos[j])
            elif t == JNT_SLIDE:
                pos = pos + mu.quat_rotate(quat, model.jnt_axis[j]) * (
                    qpos[..., adr] - model.qpos0[adr])[..., None]
        xpos.append(pos)
        xquat.append(quat)
    return torch.stack(xpos, dim=-2), torch.stack(xquat, dim=-2)


def ancestor_mask(model: Model) -> np.ndarray:
    """(nbody, nv) static 0/1 mask: mask[b, d] = dof d moves body b."""
    mask = np.zeros((model.nbody, model.nv))
    for b in range(model.nbody):
        anc = set()
        cur = b
        while cur != 0:
            anc.add(cur)
            cur = model.body_parent[cur]
        for d in range(model.nv):
            if model.dof_body[d] in anc:
                mask[b, d] = 1.0
    return mask


def motion_subspace(model: Model, xpos, xquat, anchor):
    """Per-dof spatial motion vectors S (nv, 6) = [ang; lin] about
    ``anchor`` for one env's frames."""
    S = []
    zeros = xpos.new_zeros(3)
    for j in range(model.njnt):
        b = model.jnt_body[j]
        t = model.jnt_type[j]
        if t == JNT_FREE:
            eye = torch.eye(3, dtype=xpos.dtype, device=xpos.device)
            for k in range(3):
                S.append(torch.cat([zeros, eye[k]]))
            R = mu.quat_to_mat(xquat[b])
            for k in range(3):
                w = R[:, k]
                S.append(torch.cat([w, torch.linalg.cross(w,
                                                          anchor - xpos[b])]))
        else:
            axis_w = mu.quat_rotate(xquat[b], model.jnt_axis[j])
            anch = xpos[b] + mu.quat_rotate(xquat[b], model.jnt_pos[j])
            if t == JNT_HINGE:
                S.append(torch.cat([axis_w,
                                    torch.linalg.cross(axis_w,
                                                       anchor - anch)]))
            else:
                S.append(torch.cat([zeros, axis_w]))
    return torch.stack(S)


def point_jacobian(S, point, anchor):
    """Translational Jacobian rows (nv, 3) of a world point:
    v(point) = S_lin + S_ang x (point - anchor)."""
    return S[:, 3:] + torch.linalg.cross(S[:, :3],
                                         (point - anchor).expand_as(S[:, :3]))
