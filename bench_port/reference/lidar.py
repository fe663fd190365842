"""The 72-beam lidar scan, frozen from the port's plain twin of kernel K2
(``ops/lidar.py``: ``lidar_statics``, ``lidar_rows``, ``lidar_plain``).
Semantics of MuJoCo rangefinders: distance along each site's +Z to the
floor plane (finite extents) or the nearest scene AABB, -1.0 on no hit,
positive readings clamped to the cutoff.  Layout is batch-last: xpos
(nbody*3, B), xquat (nbody*4, B) -> (nsite, B).
"""
from __future__ import annotations

import numpy as np
import torch

from .lanes import qmul, qrot

BIG = 1e10
_EPS = 1e-9
_PEPS = 1e-12


def lidar_statics(model):
    """Static raycast inputs (site frames, box bounds, plane, cutoffs) as
    Python values, shared by K2 and the step kernel's fused scans."""
    site_body = tuple(int(b) for b in model.site_body)
    site_pos = model.site_pos.detach().cpu().double().numpy()
    site_quat = model.site_quat.detach().cpu().double().numpy()
    bpos = model.scene_box_pos.detach().cpu().double().numpy().reshape(-1, 3)
    bsize = model.scene_box_size.detach().cpu().double().numpy().reshape(-1, 3)
    boxes_lo = [tuple(float(v) for v in r) for r in (bpos - bsize)]
    boxes_hi = [tuple(float(v) for v in r) for r in (bpos + bsize)]
    plane_z = float(model.plane_z)
    ph = model.plane_half_size.detach().cpu().double().numpy()
    plane_half = tuple(float(v) if v > 0 else float(BIG) for v in ph)
    cut = model.sensor_cutoff.detach().cpu().double().numpy()
    cutoff = tuple(float(c) for c in np.broadcast_to(cut, (len(site_body),)))
    return (site_body, site_pos, site_quat, boxes_lo, boxes_hi, plane_z,
            plane_half, cutoff)


def lidar_rows(site_body, site_pos, site_quat, boxes_lo, boxes_hi,
               plane_z, plane_half, cutoff, bp, bq):
    """Per-site readings as (B,) rows given body frames as lanes:
    ``bp``/``bq`` map body index -> [3]/[4] lane lists."""
    rows = []
    for i, b in enumerate(site_body):
        sp = [float(v) for v in site_pos[i]]
        sq = [float(v) for v in site_quat[i]]
        o = [bp[b][k] + v for k, v in zip(range(3), qrot(bq[b], sp))]
        # beam direction = third column of R(body_quat * site_quat)
        w, x, y, z = qmul(bq[b], sq)
        d = [2.0 * (x * z + w * y),
             2.0 * (y * z - w * x),
             1.0 - 2.0 * (x * x + y * y)]
        # a static body orientation (the fresh-spawn template) gives static
        # directions: evaluate them as lanes like the kernel does
        d = [v if isinstance(v, torch.Tensor) else torch.full_like(o[0], v)
             for v in d]

        # floor plane, finite extents (MuJoCo ray_plane)
        dz_ok = torch.abs(d[2]) > _PEPS
        t_plane = (plane_z - o[2]) / torch.where(
            dz_ok, d[2], torch.full_like(d[2], _PEPS))
        on_plane = ((torch.abs(o[0] + t_plane * d[0]) <= plane_half[0])
                    & (torch.abs(o[1] + t_plane * d[1]) <= plane_half[1]))
        big = torch.full_like(o[0], BIG)
        t_plane = torch.where(dz_ok & (t_plane > 0) & on_plane, t_plane, big)

        # AABB slab tests with a running min over boxes
        par = [torch.abs(d[c]) <= _EPS for c in range(3)]
        inv = [1.0 / torch.where(torch.abs(d[c]) > _EPS, d[c],
                                 torch.full_like(d[c], _EPS))
               for c in range(3)]
        t_best = big
        for lo, hi in zip(boxes_lo, boxes_hi):
            tmin = torch.full_like(o[0], -BIG)
            tmax = big
            inside_par = None
            for c in range(3):
                t1 = (lo[c] - o[c]) * inv[c]
                t2 = (hi[c] - o[c]) * inv[c]
                tmin = torch.maximum(tmin, torch.where(
                    par[c], -big, torch.minimum(t1, t2)))
                tmax = torch.minimum(tmax, torch.where(
                    par[c], big, torch.maximum(t1, t2)))
                ins = (~par[c]) | ((o[c] > lo[c]) & (o[c] < hi[c]))
                inside_par = ins if inside_par is None else (inside_par & ins)
            hit = (tmax >= tmin) & (tmax > 0) & inside_par
            t_box = torch.where(hit, torch.where(tmin > 0, tmin, tmax), big)
            t_best = torch.minimum(t_best, t_box)

        t = torch.minimum(t_plane, t_best)
        rows.append(torch.where(t >= BIG, torch.full_like(t, -1.0),
                                torch.clamp_max(t, float(cutoff[i]))))
    return rows


def lidar_plain(model, xpos, xquat, plane_z=None):
    """Plain twin of K2: xpos (nbody*3, B), xquat (nbody*4, B) ->
    (nsite, B); ``plane_z`` (B,): each env's floor height in place of the
    model's."""
    statics = lidar_statics(model)
    if plane_z is not None:
        statics = statics[:5] + (plane_z,) + statics[6:]
    bodies = sorted(set(statics[0]))
    bp = {b: [xpos[3 * b + k] for k in range(3)] for b in bodies}
    bq = {b: [xquat[4 * b + k] for k in range(4)] for b in bodies}
    return torch.stack(lidar_rows(*statics, bp, bq))
