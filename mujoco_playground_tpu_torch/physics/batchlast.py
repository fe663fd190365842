"""Batch-last smooth-dynamics stages of the staged step (the port of the JAX
package's ``physics/batchlast.py``).

Every array carries the env batch in its last axis: quaternions (4, B),
positions (3, B), the mass matrix (nv, nv, B).  Model parameters may carry
a leading env axis (domain randomization); ``_param_bl`` moves it last so
it broadcasts against the batch.
"""
from __future__ import annotations

import numpy as np
import torch

from mujoco_playground_tpu_torch.physics import kinematics
from mujoco_playground_tpu_torch.physics.constraint import dof_qposadr
from mujoco_playground_tpu_torch.physics.model import (JNT_FREE, JNT_HINGE,
                                                       Model)


def _cross_bl(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def quat_mul_bl(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_rotate_bl(q, v):
    uv = _cross_bl(q[1:], v)
    return v + 2.0 * (q[0] * uv + _cross_bl(q[1:], uv))


def quat_to_mat_bl(q):
    """(4, B) -> (3, 3, B)."""
    w, x, y, z = q
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def quat_integrate_bl(q, omega, dt):
    """q (4, B) by the body-frame omega (3, B) over dt, normalized."""
    angle = torch.sqrt(omega[0] ** 2 + omega[1] ** 2 + omega[2] ** 2)
    safe = torch.where(angle > 1e-14, angle, torch.ones_like(angle))
    half = angle * dt * 0.5
    s = torch.where(angle > 1e-14, torch.sin(half) / safe,
                    torch.zeros_like(angle))
    dq = torch.stack([torch.cos(half), omega[0] * s, omega[1] * s,
                      omega[2] * s])
    out = quat_mul_bl(q, dq)
    return out / torch.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2
                            + out[3] ** 2)


def _col(v, like):
    """A static vector as a (k, 1) column on like's device and dtype."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)[:, None]


def fk_bl(model: Model, qpos_bl):
    """qpos (nq, B) -> (xpos [nbody of (3, B)], xquat [nbody of (4, B)])."""
    B = qpos_bl.shape[-1]
    ident = torch.zeros((4, B), dtype=qpos_bl.dtype, device=qpos_bl.device)
    ident[0] = 1.0
    xpos, xquat = [torch.zeros_like(ident[:3])], [ident]
    jnts_of = {b: [] for b in range(model.nbody)}
    for j in range(model.njnt):
        jnts_of[model.jnt_body[j]].append(j)
    qpos0 = model.qpos0
    for b in range(1, model.nbody):
        p = model.body_parent[b]
        pos = xpos[p] + quat_rotate_bl(xquat[p], model.body_pos[b][:, None])
        quat = quat_mul_bl(xquat[p], model.body_quat[b][:, None])
        for j in jnts_of[b]:
            adr = model.jnt_qposadr[j]
            t = model.jnt_type[j]
            if t == JNT_FREE:
                pos = qpos_bl[adr:adr + 3]
                q = qpos_bl[adr + 3:adr + 7]
                quat = q / torch.sqrt(q[0] ** 2 + q[1] ** 2 + q[2] ** 2
                                      + q[3] ** 2)
            elif t == JNT_HINGE:
                theta = qpos_bl[adr] - qpos0[adr]
                jp = model.jnt_pos[j][:, None]
                anchor = pos + quat_rotate_bl(quat, jp)
                half = theta * 0.5
                s = torch.sin(half)
                ax = model.jnt_axis[j]
                quat = quat_mul_bl(quat, torch.stack(
                    [torch.cos(half), ax[0] * s, ax[1] * s, ax[2] * s]))
                if bool((model.jnt_pos[j] != 0).any()):
                    pos = anchor - quat_rotate_bl(quat, jp)
            else:  # slide
                pos = pos + quat_rotate_bl(quat, model.jnt_axis[j][:, None]) \
                    * (qpos_bl[adr] - qpos0[adr])
        xpos.append(pos)
        xquat.append(quat)
    return xpos, xquat


def motion_subspace_bl(model: Model, xpos, xquat, anchor):
    """Per-dof spatial vectors about ``anchor``: a list of nv (6, B)."""
    B = anchor.shape[-1]
    S = []
    for j in range(model.njnt):
        b = model.jnt_body[j]
        t = model.jnt_type[j]
        if t == JNT_FREE:
            zero = torch.zeros_like(anchor)
            eye = np.eye(3)
            for k in range(3):
                S.append(torch.cat([zero, _col(eye[k], anchor).expand(3, B)]))
            R = quat_to_mat_bl(xquat[b])
            for k in range(3):
                w = R[:, k]
                S.append(torch.cat([w, _cross_bl(w, anchor - xpos[b])]))
        else:
            axis_w = quat_rotate_bl(xquat[b], model.jnt_axis[j][:, None])
            anch = xpos[b]
            if bool((model.jnt_pos[j] != 0).any()):
                anch = anch + quat_rotate_bl(xquat[b],
                                             model.jnt_pos[j][:, None])
            if t == JNT_HINGE:
                S.append(torch.cat([axis_w, _cross_bl(axis_w,
                                                      anchor - anch)]))
            else:
                S.append(torch.cat([torch.zeros_like(axis_w), axis_w]))
    return S


def _param_bl(x, base_ndim):
    """A model parameter in batch-last form: a leaf with an extra leading
    env axis (domain randomization) moves it last; an unbatched leaf
    passes through and broadcasts."""
    if x.dim() == base_ndim + 1:
        return torch.movedim(x, 0, -1)
    return x


def _col_or_bl(x):
    """(k,) -> (k, 1) to broadcast over B; (k, B) passes through."""
    return x[:, None] if x.dim() == 1 else x


def _spatial_inertia_bl(model: Model, b, xpos_b, xquat_b, anchor):
    """(6, 6, B) spatial inertia of body b about anchor."""
    B = anchor.shape[-1]
    iquat = quat_mul_bl(xquat_b, _col_or_bl(_param_bl(model.body_iquat,
                                                       2)[b]))
    R = quat_to_mat_bl(iquat)                                  # (3, 3, B)
    diag = _col_or_bl(_param_bl(model.body_inertia, 2)[b])    # (3, 1|B)
    Iw = torch.einsum('ikB,jkB->ijB', R * diag[None, :, :], R)
    com = xpos_b + quat_rotate_bl(xquat_b,
                                  _col_or_bl(_param_bl(model.body_ipos, 2)[b]))
    c = com - anchor
    m = _param_bl(model.body_mass, 1)[b]                       # () or (B,)
    zero = torch.zeros(B, dtype=anchor.dtype, device=anchor.device)
    cx = torch.stack([torch.stack([zero, -c[2], c[1]]),
                      torch.stack([c[2], zero, -c[0]]),
                      torch.stack([-c[1], c[0], zero])])
    top_left = Iw + m * torch.einsum('ikB,jkB->ijB', cx, cx)
    top_right = m * cx
    bot_left = m * cx.transpose(0, 1)
    eye = torch.eye(3, dtype=anchor.dtype,
                    device=anchor.device)[:, :, None].expand(cx.shape)
    bot_right = m * eye
    return torch.cat([torch.cat([top_left, top_right], 1),
                      torch.cat([bot_left, bot_right], 1)], 0)


def _motion_cross_bl(v, s):
    return torch.cat([_cross_bl(v[:3], s[:3]),
                      _cross_bl(v[3:], s[:3]) + _cross_bl(v[:3], s[3:])])


def _force_cross_bl(v, f):
    return torch.cat([_cross_bl(v[:3], f[:3]) + _cross_bl(v[3:], f[3:]),
                      _cross_bl(v[:3], f[3:])])


def crba_bias_bl(model: Model, xpos, xquat, qvel_bl, gravity):
    """Batch-last CRBA + RNEA: (M (nv, nv, B), qfrc_bias (nv, B), S (nv, 6,
    B), anchor (3, B))."""
    B = qvel_bl.shape[-1]
    dt = dict(dtype=qvel_bl.dtype, device=qvel_bl.device)
    nv = model.nv
    anchor = xpos[1] if model.nbody > 1 else torch.zeros((3, B), **dt)
    S = motion_subspace_bl(model, xpos, xquat, anchor)
    Sarr = torch.stack(S)                                      # (nv, 6, B)
    mask = kinematics.ancestor_mask(model)
    # bodies with inertia (with randomized masses: in any env)
    mass = model.body_mass.detach().abs().cpu().numpy()
    inert = model.body_inertia.detach().abs().cpu().numpy()
    if mass.ndim == 2:
        mass, inert = mass.max(0), inert.max(0)
    bodies = [b for b in range(model.nbody)
              if mass[b] != 0.0 or np.any(inert[b])]
    Ibar = torch.stack([_spatial_inertia_bl(model, b, xpos[b], xquat[b],
                                            anchor) for b in bodies])
    mask_c = torch.as_tensor(mask[np.asarray(bodies)], **dt)   # (nb, nv)
    Jfull = torch.einsum('vkB,bv->bkvB', Sarr, mask_c)
    IJ = torch.einsum('bklB,blvB->bkvB', Ibar, Jfull)
    M = torch.einsum('bkvB,bkwB->vwB', Jfull, IJ)
    arma = _col_or_bl(_param_bl(model.dof_armature, 1))        # (nv, 1|B)
    M = M + torch.eye(nv, **dt)[:, :, None] * arma[:, None, :]

    vbody = torch.einsum('bkvB,vB->bkB', Jfull, qvel_bl)       # (nb, 6, B)
    carried = np.ones(nv, bool)
    for j in range(model.njnt):
        if model.jnt_type[j] == JNT_FREE:
            adr = model.jnt_dofadr[j]
            carried[adr:adr + 3] = False
    body_of = {b: i for i, b in enumerate(bodies)}
    cdot = torch.stack([
        _motion_cross_bl(vbody[body_of[model.dof_body[d]]], S[d])
        * qvel_bl[d] if carried[d] else torch.zeros((6, B), **dt)
        for d in range(nv)])                                   # (nv, 6, B)
    g = torch.as_tensor(gravity, **dt)
    a0 = torch.cat([torch.zeros((3, B), **dt), (-g)[:, None].expand(3, B)])
    abody = a0[None] + torch.einsum('bv,vkB->bkB', mask_c, cdot)
    Iv = torch.einsum('bklB,blB->bkB', Ibar, vbody)
    Ia = torch.einsum('bklB,blB->bkB', Ibar, abody)
    fbody = Ia + torch.stack([_force_cross_bl(vbody[i], Iv[i])
                              for i in range(len(bodies))])
    fbias = torch.einsum('bkvB,bkB->vB', Jfull, fbody)
    return M, fbias, Sarr, anchor


def actuator_force_bl(model: Model, qpos_bl, qvel_bl, ctrl_bl):
    """(nu, B) ctrl -> (nv, B) generalized force; gain and bias may carry
    a per-env axis, the ranges are static."""
    gain = _param_bl(model.actuator_gain, 1)
    bias = _param_bl(model.actuator_bias, 2)
    out = torch.zeros((model.nv, qpos_bl.shape[-1]), dtype=qpos_bl.dtype,
                      device=qpos_bl.device)
    for u in range(model.nu):
        d = model.actuator_dof[u]
        cr = model.actuator_ctrlrange[u]
        fr = model.actuator_forcerange[u]
        c = torch.clamp(ctrl_bl[u], cr[0], cr[1])
        force = (gain[u] * c + bias[u, 0]
                 + bias[u, 1] * qpos_bl[dof_qposadr(model, d)]
                 + bias[u, 2] * qvel_bl[d])
        out[d] = out[d] + torch.clamp(force, fr[0], fr[1])
    return out


def integrate_pos_bl(model: Model, qpos_bl, qvel_bl, h):
    out = []
    for j in range(model.njnt):
        adr, dadr = model.jnt_qposadr[j], model.jnt_dofadr[j]
        if model.jnt_type[j] == JNT_FREE:
            out.append(qpos_bl[adr:adr + 3] + h * qvel_bl[dadr:dadr + 3])
            out.append(quat_integrate_bl(qpos_bl[adr + 3:adr + 7],
                                         qvel_bl[dadr + 3:dadr + 6], h))
        else:
            out.append(qpos_bl[adr:adr + 1] + h * qvel_bl[dadr:dadr + 1])
    return torch.cat(out)
