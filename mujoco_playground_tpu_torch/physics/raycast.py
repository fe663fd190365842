"""The lidar raycast in plain PyTorch: rays against the floor plane and the
scene's boxes, and against the robot's own geoms (the port of the JAX
package's ``physics/raycast.py``).

MuJoCo rangefinder semantics: the distance to the nearest surface along
each site's +Z, -1.0 where nothing is hit, positive readings clamped to the
sensor cutoff.  A plane with positive sizes is a finite rectangle (MuJoCo's
``ray_plane``); a ray parallel to a box face hits it only from strictly
inside the slab.  ``raycast_robot`` adds the robot's chassis boxes and wheel
cylinders (MuJoCo's ``mj_ray`` excludes only the site's body, which carries
no geoms); ``lidar`` folds them in with ``include_robot_geoms=True``.  Every
robot geom is rigid to the chassis, so the beams never meet them in any
pose, and the default skips them.

Every function takes one env's frames, as the JAX functions do, or a batch
with a leading env axis; the model's leaves may then carry a leading env
axis too (domain randomization), read through ``env_leaf``.  This is the
per-env observation of ``AckermannEnv.step`` and, batched over each env's
own leaves, the observation under a randomized scan field other than the
floor height (the batched env observes through kernel K2 otherwise).
"""
from __future__ import annotations

import torch

from mujoco_playground_tpu_torch.physics import kinematics
from mujoco_playground_tpu_torch.physics import mathutil as mu
from mujoco_playground_tpu_torch.physics.model import (Model, env_count,
                                                       env_leaf)

BIG = 1e10
# the model fields a scan reads (beside the body frames)
SCAN_FIELDS = ("site_pos", "site_quat", "scene_box_pos", "scene_box_size",
               "plane_z", "plane_half_size", "sensor_cutoff")


def _lead(*ts):
    """Whether the rays (R, 3) come without an env axis, and the tensors
    with one."""
    one = ts[0].dim() == 2
    return one, [t[None] if one else t for t in ts]


def _scene(model: Model, origins, dirs):
    """raycast_scene on (N, R, 3) rays, each env's leaves (E in {1, N})."""
    E = env_count(model)
    dtype = origins.dtype
    dz = dirs[..., 2]
    t_plane = ((env_leaf(model, "plane_z", E)[:, None] - origins[..., 2])
               / torch.where(torch.abs(dz) > 1e-12, dz,
                             torch.full_like(dz, 1e-12)))
    half = env_leaf(model, "plane_half_size", E)[:, None, :]    # (E, 1, 2)
    hit_xy = origins[..., :2] + t_plane[..., None] * dirs[..., :2]
    on_plane = ((half <= 0) | (torch.abs(hit_xy) <= half)).all(-1)
    big = torch.full_like(t_plane, BIG)
    t_plane = torch.where((torch.abs(dz) > 1e-12) & (t_plane > 0)
                          & on_plane, t_plane, big)
    if model.num_scene_boxes > 0:
        bpos = env_leaf(model, "scene_box_pos", E)
        bsize = env_leaf(model, "scene_box_size", E)
        lo = (bpos - bsize)[:, None]                             # (E,1,K,3)
        hi = (bpos + bsize)[:, None]
        o = origins[..., None, :]                                # (N,R,1,3)
        eps = 1e-9
        parallel = (torch.abs(dirs) <= eps)[..., None, :]
        inv = (1.0 / torch.where(torch.abs(dirs) > eps, dirs,
                                 torch.full_like(dirs, eps)))[..., None, :]
        t1 = (lo - o) * inv
        t2 = (hi - o) * inv
        tmin = torch.where(parallel, -BIG,
                           torch.minimum(t1, t2)).amax(-1)       # (N,R,K)
        tmax = torch.where(parallel, BIG, torch.maximum(t1, t2)).amin(-1)
        inside_par = ((~parallel) | ((o > lo) & (o < hi))).all(-1)
        hit = (tmax >= tmin) & (tmax > 0) & inside_par
        t_box = torch.where(hit, torch.where(tmin > 0, tmin, tmax),
                            torch.full_like(tmin, BIG))
        t_boxes = t_box.amin(-1)
    else:
        t_boxes = torch.full(origins.shape[:-1], BIG, dtype=dtype,
                             device=origins.device)
    t = torch.minimum(t_plane, t_boxes)
    return torch.where(t >= BIG, torch.full_like(t, -1.0), t)


def raycast_scene(model: Model, origins, dirs):
    """Nearest-hit distances of rays against the floor plane and the scene
    boxes: origins, dirs (R, 3) (or (B, R, 3)) -> (R,) (or (B, R)); -1.0
    where nothing is hit."""
    one, (origins, dirs) = _lead(origins, dirs)
    out = _scene(model, origins, dirs)
    return out[0] if one else out


def _ray_obb(origins, dirs, center, quat, half):
    """Rays (N, R, 3) against one oriented box per env (center (N, 3), quat
    (N, 4), half (E, 3)): distances (N, R), BIG on a miss.  The slab test
    and tangential rejection of raycast_scene, in the box frame."""
    q = quat[:, None].expand(origins.shape[:-1] + (4,))
    o = mu.quat_rotate_inv(q, origins - center[:, None])
    d = mu.quat_rotate_inv(q, dirs)
    half = half[:, None]
    eps = 1e-9
    parallel = torch.abs(d) <= eps
    inv = 1.0 / torch.where(torch.abs(d) > eps, d, torch.full_like(d, eps))
    t1 = (-half - o) * inv
    t2 = (half - o) * inv
    tmin = torch.where(parallel, -BIG, torch.minimum(t1, t2)).amax(-1)
    tmax = torch.where(parallel, BIG, torch.maximum(t1, t2)).amin(-1)
    inside_par = ((~parallel) | ((o > -half) & (o < half))).all(-1)
    hit = (tmax >= tmin) & (tmax > 0) & inside_par
    return torch.where(hit, torch.where(tmin > 0, tmin, tmax),
                       torch.full_like(tmin, BIG))


def _ray_cylinder(origins, dirs, center, axis, radius, half_h):
    """Rays (N, R, 3) against one finite cylinder per env (center, axis
    (N, 3); radius, half_h (E, 1)), mj_ray semantics: the smallest t > 0
    among valid side and cap hits, BIG on a miss."""
    rel = origins - center[:, None]
    ax = axis[:, None]
    ad = (dirs * ax).sum(-1)                                      # (N, R)
    ao = (rel * ax).sum(-1)
    big = torch.full_like(ad, BIG)
    t_caps = big
    for s in (-1.0, 1.0):
        ok = torch.abs(ad) > 1e-12
        t = (s * half_h - ao) / torch.where(ok, ad, torch.full_like(ad,
                                                                    1e-12))
        p = rel + t[..., None] * dirs
        rad2 = ((p - (p * ax).sum(-1, keepdim=True) * ax) ** 2).sum(-1)
        valid = ok & (t > 0) & (rad2 <= radius * radius)
        t_caps = torch.minimum(t_caps, torch.where(valid, t, big))
    d_perp = dirs - ad[..., None] * ax
    o_perp = rel - ao[..., None] * ax
    a = (d_perp * d_perp).sum(-1)
    b = 2.0 * (o_perp * d_perp).sum(-1)
    c = (o_perp * o_perp).sum(-1) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
    t_side = big
    for sgn in (-1.0, 1.0):
        t = (-b + sgn * sq) / torch.where(ok, 2.0 * a, torch.ones_like(a))
        h = ao + t * ad
        valid = ok & (t > 0) & (torch.abs(h) <= half_h)
        t_side = torch.minimum(t_side, torch.where(valid, t, big))
    return torch.minimum(t_caps, t_side)


def _robot(model: Model, xpos, xquat, origins, dirs):
    """raycast_robot on a batch: frames (N, nbody, ...), rays (N, R, 3)."""
    E = env_count(model)
    N = xpos.shape[0]
    t_best = torch.full(origins.shape[:-1], BIG, dtype=origins.dtype,
                        device=origins.device)
    box_pos = env_leaf(model, "chassis_box_pos", E)
    box_quat = env_leaf(model, "chassis_box_quat", E)
    box_size = env_leaf(model, "chassis_box_size", E)
    for i, b in enumerate(model.chassis_box_body):
        center = xpos[:, b] + mu.quat_rotate(xquat[:, b],
                                             box_pos[:, i].expand(N, 3))
        quat = mu.quat_mul(xquat[:, b], box_quat[:, i].expand(N, 4))
        t_best = torch.minimum(t_best, _ray_obb(origins, dirs, center, quat,
                                                box_size[:, i]))
    wheel_pos = env_leaf(model, "wheel_pos", E)
    wheel_axis = env_leaf(model, "wheel_axis", E)
    wheel_size = env_leaf(model, "wheel_size", E)
    for j, b in enumerate(model.wheel_body):
        center = xpos[:, b] + mu.quat_rotate(xquat[:, b],
                                             wheel_pos[:, j].expand(N, 3))
        axis = mu.quat_rotate(xquat[:, b], wheel_axis[:, j].expand(N, 3))
        t_best = torch.minimum(t_best, _ray_cylinder(
            origins, dirs, center, axis, wheel_size[:, j, 0:1],
            wheel_size[:, j, 1:2]))
    return t_best


def raycast_robot(model: Model, xpos, xquat, origins, dirs):
    """Nearest-hit distances of rays against the robot's own geoms (the
    chassis boxes and the wheel cylinders) at body frames xpos (nbody, 3),
    xquat (nbody, 4): origins, dirs (R, 3) -> (R,), BIG where no robot geom
    is hit.  A leading env axis on every input is kept."""
    one, (xpos, xquat, origins, dirs) = _lead(xpos, xquat, origins, dirs)
    out = _robot(model, xpos, xquat, origins, dirs)
    return out[0] if one else out


def lidar(model: Model, xpos, xquat, site_slice=None,
          include_robot_geoms: bool = False):
    """The rangefinder scan from the model's sites at body frames xpos
    (nbody, 3), xquat (nbody, 4) -> (nsite,) distances, clamped to the
    cutoff, -1.0 on no hit; with a leading env axis on the frames (and,
    under domain randomization, on the model's leaves) -> (B, nsite).
    ``site_slice`` scans a slice of the sites; ``include_robot_geoms``
    folds in the ray-vs-own-geom hits (exact ``mj_ray`` semantics, the
    same readings for this robot in every pose)."""
    one, (xpos, xquat) = _lead(xpos, xquat)
    pos, zaxis = kinematics.site_frames(model, xpos, xquat)
    cutoff = env_leaf(model, "sensor_cutoff", env_count(model))
    if site_slice is not None:
        pos, zaxis = pos[:, site_slice], zaxis[:, site_slice]
        cutoff = cutoff[:, site_slice]
    dist = _scene(model, pos, zaxis)
    if include_robot_geoms:
        t = torch.where(dist >= 0, dist, torch.full_like(dist, BIG))
        t = torch.minimum(t, _robot(model, xpos, xquat, pos, zaxis))
        dist = torch.where(t >= BIG, torch.full_like(t, -1.0), t)
    out = torch.where(dist >= 0, torch.minimum(dist, cutoff), dist)
    return out[0] if one else out
