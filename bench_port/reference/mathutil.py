"""Quaternion and spatial-algebra helpers on torch tensors.

Conventions match MuJoCo: quaternions are ``[w, x, y, z]``; spatial motion
vectors are ``[angular(3); linear(3)]`` about an explicit world point.  All
functions broadcast over leading batch dimensions.
"""
from __future__ import annotations

import torch


def quat_mul(a, b):
    """Hamilton product a*b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_to_mat(q):
    """Quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis, angle):
    """Unit axis + angle -> quaternion."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    s = torch.sin(angle / 2.0)[..., None]
    w = torch.cos(angle / 2.0)[..., None]
    w, s = torch.broadcast_tensors(w, s)
    return torch.cat([w, axis * s], dim=-1)


def quat_to_yaw(q):
    """Yaw (rotation about world Z) of a quaternion."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def skew(v):
    """3-vector -> skew-symmetric cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass, inertia_world, com_rel):
    """(..., 6, 6) spatial inertia about an anchor, mapping motion
    [ang; lin] to force [trq; frc]; ``com_rel`` is the CoM minus the
    anchor."""
    c = skew(com_rel)
    m = mass[..., None, None]
    top_left = inertia_world + m * (c @ c.transpose(-1, -2))
    top_right = m * c
    bot_left = m * c.transpose(-1, -2)
    eye = torch.eye(3, dtype=c.dtype, device=c.device).expand(c.shape)
    bot_right = m * eye
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, bot_right], dim=-1)
    return torch.cat([top, bot], dim=-2)
