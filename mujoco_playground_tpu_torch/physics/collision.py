"""Narrowphase collision against the static scene (plane + AABB obstacles),
batched over envs: the port of the JAX package's ``physics/collision.py``.

The JAX module collides one env and is vmapped; here every function takes
``(B, ...)`` tensors and runs all envs at once.  Fixed-size contact slots:
every candidate contact always exists; inactive ones are gated by
``dist >= 0`` downstream.  Slot layout (C slots per env):

  [4 wheels x 4 cylinder-plane candidates]                     -> 16
  [4 wheels x TOPK_W boxes x 2 (5 with the wheel patch) points] (if boxes)
  [2 chassis hulls x 4 vertices (one per quadrant) vs plane]   -> 8
  [2 chassis hulls x 4 vertices vs the nearest box]            (if boxes)

Both parity-compat manifolds (PARITY.md approximations 1-2) are here:
``model.compat_flat_manifold`` emits the support vertex's deepest incident
hull face against the plane, ``model.compat_wheel_patch`` adds 3 mid-tread
points to each wheel-box pair.  The picks keep the JAX order: ``top_k``
puts the lower index first on ties (a stable sort here) and every
``argmin``/``argmax`` returns the first extremum.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mujoco_playground_tpu_torch.physics import mathutil as mu
from mujoco_playground_tpu_torch.physics.model import Model

TOPK_W = 2  # scene boxes tested per wheel


@dataclasses.dataclass
class Contacts:
    """Contact slots of a batch of envs (C slots each)."""
    pos: torch.Tensor          # (B, C, 3) contact position (world)
    frame: torch.Tensor        # (B, C, 3, 3) rows [n, t1, t2]
    dist: torch.Tensor         # (B, C) signed distance (< 0: penetrating)
    friction: torch.Tensor     # (C,) isotropic tangential mu
    solref: torch.Tensor       # (C, 2)
    solimp: torch.Tensor       # (C, 5)
    diag_approx: torch.Tensor  # (C,) trn invweight of the robot body
    body: np.ndarray           # (C,) static robot body of each slot


def _vec(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _make_frame(n):
    """Tangent frames [n, t1, t2] (..., 3, 3) matching mju_makeFrame:
    t1 = normalize(n x a), t2 = n x t1, with a = x-hat unless n is near
    x-hat."""
    a = torch.where(torch.abs(n[..., :1]) < 0.5, _vec([1.0, 0.0, 0.0], n),
                    _vec([0.0, 1.0, 0.0], n))
    t1 = torch.linalg.cross(n, a)
    t1 = t1 / torch.clamp_min(torch.linalg.norm(t1, dim=-1, keepdim=True),
                              1e-12)
    t2 = torch.linalg.cross(n, t1)
    return torch.stack([n, t1, t2], dim=-2)


def _point_box(p, bp, bs):
    """Point vs AABB over leading dims: (dist, normal box -> point, contact
    midpoint)."""
    rel = p - bp
    q = torch.abs(rel) - bs
    inside = (q < 0).all(-1)
    dist_out = torch.linalg.norm(torch.clamp_min(q, 0.0), dim=-1)
    ax = torch.argmax(q, dim=-1, keepdim=True)
    n_in = torch.zeros_like(rel).scatter(
        -1, ax, torch.sign(torch.gather(rel, -1, ax)))
    delta = rel - torch.clamp(rel, -bs, bs)
    dn = torch.linalg.norm(delta, dim=-1, keepdim=True)
    n_out = delta / torch.clamp_min(dn, 1e-9)
    n = torch.where(inside[..., None], n_in, n_out)
    dist = torch.where(inside, torch.gather(q, -1, ax)[..., 0], dist_out)
    pos = p - 0.5 * dist[..., None] * n
    return dist, n, pos


def _cylinder_box(c, a, r, h, bp, bs, patch=False):
    """Cylinder (center c, unit axis a, radius r, half-height h; (B, 3))
    vs AABBs bp/bs (B, 3): per disc end, the rim-ring point closest to the
    box (two fixed-point iterations), collided as a point; ``patch`` adds
    the axis midpoint's ring point and its +-2e-3 rad clip pair (MuJoCo
    3.10's 5-point tread patch).  Returns [(dist, normal, midpoint)]."""
    fx = _vec([1.0, 0.0, 0.0], a) - a[:, :1] * a
    fy = _vec([0.0, 1.0, 0.0], a) - a[:, 1:2] * a
    use_x = torch.linalg.norm(fx, dim=-1, keepdim=True) > 0.1
    fall = torch.where(use_x, fx, fy)
    fall = fall / torch.clamp_min(
        torch.linalg.norm(fall, dim=-1, keepdim=True), 1e-12)

    def ring_point(ce):
        q, u = ce, fall
        for _ in range(2):
            cp = bp + torch.clamp(q - bp, -bs, bs)
            d = cp - ce
            dperp = d - _dot(d, a) * a
            dn = torch.linalg.norm(dperp, dim=-1, keepdim=True)
            u = torch.where(dn > 1e-9, dperp / torch.clamp_min(dn, 1e-9),
                            fall)
            q = ce + r * u
        return q, u

    out = []
    for e in (-1.0, 1.0):
        q, _ = ring_point(c + e * h * a)
        out.append(_point_box(q, bp, bs))
    if patch:
        _, u = ring_point(c)
        w = torch.linalg.cross(a, u)
        for phi in (0.0, 2e-3, -2e-3):
            qm = c + r * (math.cos(phi) * u + math.sin(phi) * w)
            out.append(_point_box(qm, bp, bs))
    return out


def collide(model: Model, xpos, xquat) -> Contacts:
    """All contact slots of a batch: xpos (B, nbody, 3), xquat (B, nbody,
    4)."""
    B = xpos.shape[0]
    nw = len(model.wheel_body)
    zhat = _vec([0.0, 0.0, 1.0], xpos)
    rows = torch.arange(B, device=xpos.device)
    pos_l, frame_l, dist_l, fric_l, solref_l, solimp_l, diag_l, body_l = (
        [], [], [], [], [], [], [], [])
    iw = model.body_invweight0[:, 0]

    def emit(p, frame, dist, fric, solref, solimp, diag, b):
        pos_l.append(p)
        frame_l.append(frame)
        dist_l.append(dist)
        fric_l.append(fric)
        solref_l.append(solref)
        solimp_l.append(solimp)
        diag_l.append(diag)
        body_l.append(b)

    def combine(w):
        # MuJoCo's default mixing: friction max, solref/solimp mean
        return (torch.maximum(model.wheel_friction[w, 0],
                              model.plane_friction[0]),
                0.5 * (model.wheel_solref[w] + model.plane_solref),
                0.5 * (model.wheel_solimp[w] + model.plane_solimp))

    def wheel_frame(w):
        b = model.wheel_body[w]
        c = xpos[:, b] + mu.quat_rotate(xquat[:, b],
                                        model.wheel_pos[w].expand(B, 3))
        a = mu.quat_rotate(xquat[:, b], model.wheel_axis[w].expand(B, 3))
        return b, c, a, model.wheel_size[w, 0], model.wheel_size[w, 1]

    plane_frame = _make_frame(zhat).expand(B, 3, 3)

    # wheels vs plane: two rim points + the deep-face +-120 degree pair
    for w in range(nw):
        b, c, a, r, h = wheel_frame(w)
        fric, solref, solimp = combine(w)
        proj = zhat - a[:, 2:3] * a
        pn = torch.linalg.norm(proj, dim=-1, keepdim=True)
        # degenerate fallback -x: the deepest candidate lands at +x
        raddir = torch.where(pn > 1e-9, proj / torch.clamp_min(pn, 1e-9),
                             _vec([-1.0, 0.0, 0.0], proj))

        def emit_plane(p):
            dist = p[:, 2] - model.plane_z
            emit(p - 0.5 * dist[:, None] * zhat, plane_frame, dist, fric,
                 solref, solimp, iw[b], b)

        for sgn in (-1.0, 1.0):
            emit_plane(c + sgn * h * a - r * raddir)
        deep_sgn = torch.where(a[:, 2:3] > 0, -1.0, 1.0).to(a.dtype)
        deep_center = c + deep_sgn * h * a
        t = torch.linalg.cross(a, raddir)
        for s in (-1.0, 1.0):
            emit_plane(deep_center
                       + r * (0.5 * raddir + s * (math.sqrt(3) / 2) * t))

    # wheels vs the TOPK_W boxes nearest by squared surface distance
    K = model.num_scene_boxes
    if K > 0:
        box_pos, box_size = model.scene_box_pos, model.scene_box_size
        for w in range(nw):
            b, c, a, r, h = wheel_frame(w)
            fric, solref, solimp = combine(w)
            d2 = (torch.clamp_min(torch.abs(box_pos[None] - c[:, None])
                                  - box_size[None], 0.0) ** 2).sum(-1)
            idx = torch.sort(d2, dim=-1, stable=True).indices
            for k in range(min(TOPK_W, K)):
                bp, bs = box_pos[idx[:, k]], box_size[idx[:, k]]
                for dist, n, p in _cylinder_box(
                        c, a, r, h, bp, bs, patch=model.compat_wheel_patch):
                    emit(p, _make_frame(n), dist, fric, solref, solimp,
                         iw[b], b)

    # chassis convex hulls: one vertex per body-frame-xy quadrant (or the
    # compat support face) vs the plane, and vs the nearest box
    for i, b in enumerate(model.chassis_box_body):
        Rb = mu.quat_to_mat(xquat[:, b])
        verts = xpos[:, b, None, :] + model.chassis_hull_verts[i] @ \
            Rb.transpose(-1, -2)                               # (B, V, 3)
        bias = torch.as_tensor(model.chassis_hull_bias[i], dtype=xpos.dtype,
                               device=xpos.device)
        quads = [torch.as_tensor(q, device=xpos.device)
                 for q in model.chassis_hull_quadrants[i]]
        fric = torch.clamp_min(model.plane_friction[0], 1.0)
        solref, solimp = model.plane_solref, model.plane_solimp
        dists = verts[..., 2] - model.plane_z
        score = dists - bias

        def emit_plane(p, dist):
            emit(p - 0.5 * dist[:, None] * zhat, plane_frame, dist, fric,
                 solref, solimp, iw[b], b)

        if model.compat_flat_manifold:
            faces = np.asarray(model.chassis_hull_faces[i], np.int64)
            if faces.size == 0:
                raise ValueError(
                    "compat_flat_manifold needs hull_faces for every "
                    f"chassis geom (geom {i} has none)")
            fj = torch.as_tensor(faces, device=xpos.device)      # (F, 3)
            covered = torch.zeros(dists.shape[1], dtype=torch.bool,
                                  device=xpos.device)
            covered[torch.unique(fj)] = True
            inf = torch.full_like(dists, math.inf)
            support = torch.argmin(torch.where(covered, dists, inf), dim=-1)
            contains = (fj[None] == support[:, None, None]).any(-1)
            fsum = dists[:, fj].sum(-1)                          # (B, F)
            fsel = torch.argmin(torch.where(
                contains, fsum, torch.full_like(fsum, math.inf)), dim=-1)
            tri = fj[fsel]                                       # (B, 3)
            for k in range(3):
                emit_plane(verts[rows, tri[:, k]], dists[rows, tri[:, k]])
            # the 4th slot of the static layout, parked inactive
            emit_plane(verts[rows, support], torch.ones_like(dists[:, 0]))
        else:
            for q in quads:
                k = q[torch.argmin(score[:, q], dim=-1)]
                emit_plane(verts[rows, k], dists[rows, k])
        if K > 0:
            center = xpos[:, b] + mu.quat_rotate(
                xquat[:, b], model.chassis_box_pos[i].expand(B, 3))
            d2 = (torch.clamp_min(torch.abs(model.scene_box_pos[None]
                                            - center[:, None])
                                  - model.scene_box_size[None], 0.0)
                  ** 2).sum(-1)
            j = torch.argmin(d2, dim=-1)
            bdist, bn, bpos = _point_box(
                verts, model.scene_box_pos[j][:, None],
                model.scene_box_size[j][:, None])
            bscore = bdist - bias
            for q in quads:
                k = q[torch.argmin(bscore[:, q], dim=-1)]
                emit(bpos[rows, k], _make_frame(bn[rows, k]),
                     bdist[rows, k], fric, solref, solimp, iw[b], b)

    return Contacts(
        pos=torch.stack(pos_l, 1), frame=torch.stack(frame_l, 1),
        dist=torch.stack(dist_l, 1), friction=torch.stack(fric_l),
        solref=torch.stack(solref_l), solimp=torch.stack(solimp_l),
        diag_approx=torch.stack(diag_l), body=np.asarray(body_l, np.int64))
