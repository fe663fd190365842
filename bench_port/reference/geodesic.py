"""Geodesic (maze-aware) potential fields for progress shaping (frozen from
the port's ``envs/geodesic.py``).

Once per scene, at env construction, a Dijkstra pass over a fine occupancy
grid rasterized from the scene's wall boxes gives the geodesic
distance-to-goal field of every free cell (numpy, the same arithmetic as
the JAX package's, so the fields are bitwise equal).  Shaping uses
``phi(pos) = field[goal_cell](pos)`` as its potential:
``r += scale * (phi(prev) - phi(new))`` telescopes over an episode and
decreases along every corridor toward the goal.  The goal compass reads
the field's gradient.

Sampling (``sample``, ``sample_vec``) runs in torch on the env's device:
four gathers and a bilinear blend per env, plain PyTorch ops beside the
step kernel, as the JAX package runs them in XLA beside its kernel.
"""
from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
import torch

# Cost multiplier for stepping through a wall-occupied grid cell.  Walls are
# not hard-blocked: the potential keeps a defined, outward-pointing gradient
# even if the chassis center overlaps a wall footprint, and unreachable
# pockets still get finite values.
WALL_COST = 6.0


def rasterize_walls(scene, resolution: float,
                    margin: float = 0.6) -> Tuple[np.ndarray, np.ndarray]:
    """Scene wall boxes -> (occupancy (H, W) bool, origin (2,)).

    Grid node (i, j) sits at world ``origin + (j, i) * resolution``; a node
    is occupied when it falls inside any box's xy footprint.  ``margin``
    pads the grid beyond the wall extents so sampling never clamps inside
    the playable area.
    """
    pos = np.asarray(scene.box_pos, np.float64)
    size = np.asarray(scene.box_size, np.float64)
    if len(pos) == 0:                       # open floor: tiny empty grid
        origin = np.array([-margin, -margin])
        shape = (int(2 * margin / resolution) + 1,) * 2
        return np.zeros(shape, bool), origin
    lo = (pos[:, :2] - size[:, :2]).min(axis=0) - margin
    hi = (pos[:, :2] + size[:, :2]).max(axis=0) + margin
    origin = lo
    W = int(np.ceil((hi[0] - lo[0]) / resolution)) + 1
    H = int(np.ceil((hi[1] - lo[1]) / resolution)) + 1
    xs = origin[0] + np.arange(W) * resolution
    ys = origin[1] + np.arange(H) * resolution
    gx, gy = np.meshgrid(xs, ys)            # (H, W)
    occ = np.zeros((H, W), bool)
    for p, s in zip(pos, size):
        occ |= ((np.abs(gx - p[0]) <= s[0]) & (np.abs(gy - p[1]) <= s[1]))
    return occ, origin


def _dijkstra(occ: np.ndarray, start: Tuple[int, int],
              resolution: float) -> np.ndarray:
    """8-connected Dijkstra distance field (meters) from ``start`` (i, j).

    Edge cost = Euclidean step length x the mean of the endpoint cell costs
    (1 for free, WALL_COST inside walls), so the field is defined
    everywhere and grows steeply into walls.
    """
    H, W = occ.shape
    cost = np.where(occ, WALL_COST, 1.0)
    dist = np.full((H, W), np.inf)
    si, sj = start
    dist[si, sj] = 0.0
    pq = [(0.0, si, sj)]
    steps = [(di, dj, resolution * np.hypot(di, dj))
             for di in (-1, 0, 1) for dj in (-1, 0, 1)
             if (di, dj) != (0, 0)]
    while pq:
        d, i, j = heapq.heappop(pq)
        if d > dist[i, j]:
            continue
        ci = cost[i, j]
        for di, dj, ln in steps:
            ni, nj = i + di, j + dj
            if 0 <= ni < H and 0 <= nj < W:
                nd = d + ln * 0.5 * (ci + cost[ni, nj])
                if nd < dist[ni, nj]:
                    dist[ni, nj] = nd
                    heapq.heappush(pq, (nd, ni, nj))
    return dist


def build_fields(scene, resolution: float = 0.05):
    """Per-goal-cell geodesic fields for a maze scene.

    Returns ``(fields (K, H, W) float32, origin (2,) float32)`` where K =
    ``len(scene.free_cells)``: goal sampling draws exactly these cells, so
    ``fields[goal_cell]`` is the episode's potential.  8-connectivity
    overestimates true geodesics by at most ~8% (the octile metric).
    """
    occ, origin = rasterize_walls(scene, resolution)
    fields = []
    for cx, cy in np.asarray(scene.free_cells, np.float64):
        j = int(round((cx - origin[0]) / resolution))
        i = int(round((cy - origin[1]) / resolution))
        i = min(max(i, 0), occ.shape[0] - 1)
        j = min(max(j, 0), occ.shape[1] - 1)
        fields.append(_dijkstra(occ, (i, j), resolution))
    f = np.stack(fields).astype(np.float32)
    # any remaining inf (fully enclosed pockets) -> large finite value
    f[~np.isfinite(f)] = 1e4
    return f, origin.astype(np.float32)


def build_grad_fields(fields: np.ndarray, resolution: float) -> np.ndarray:
    """Per-node central-difference gradient of each field, (K, H, W, 2);
    borders use one-sided differences (outside the wall margin,
    unreachable in play)."""
    f = np.asarray(fields, np.float32)
    gy, gx = np.gradient(f, resolution, axis=(1, 2))
    return np.stack([gx, gy], axis=-1).astype(np.float32)


def _corners(fields, origin, resolution: float, cell_idx, xy):
    """The four grid values around each position and the blend weights:
    float32 clip to the grid (``W - 1.001``), floor, four gathers."""
    H, W = fields.shape[1], fields.shape[2]
    u = (xy[..., 0] - origin[0]) / resolution
    v = (xy[..., 1] - origin[1]) / resolution
    u = torch.clamp(u, 0.0, W - 1.001)
    v = torch.clamp(v, 0.0, H - 1.001)
    j0f, i0f = torch.floor(u), torch.floor(v)
    j0, i0 = j0f.long(), i0f.long()
    c = cell_idx.long()
    return ((fields[c, i0, j0], fields[c, i0, j0 + 1],
             fields[c, i0 + 1, j0], fields[c, i0 + 1, j0 + 1]),
            u - j0f, v - i0f)


def sample(fields, origin, resolution: float, cell_idx, xy):
    """Bilinear potential lookup, batched.

    fields: (K, H, W) tensor; origin: (2,) tensor; cell_idx: int (...,);
    xy: (..., 2) world coordinates.  Returns phi (...,) in meters.
    Positions outside the grid clamp to the border.
    """
    (f00, f01, f10, f11), fu, fv = _corners(fields, origin, resolution,
                                            cell_idx, xy)
    return ((1 - fv) * ((1 - fu) * f00 + fu * f01)
            + fv * ((1 - fu) * f10 + fu * f11))


def sample_vec(fields, origin, resolution: float, cell_idx, xy):
    """Bilinear lookup in a vector-valued field (K, H, W, C) -> (..., C)."""
    (f00, f01, f10, f11), fu, fv = _corners(fields, origin, resolution,
                                            cell_idx, xy)
    fu, fv = fu[..., None], fv[..., None]
    return ((1 - fv) * ((1 - fu) * f00 + fu * f01)
            + fv * ((1 - fu) * f10 + fu * f11))
