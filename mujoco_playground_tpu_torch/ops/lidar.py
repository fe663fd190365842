"""The 72-beam lidar scan: kernel K2 and its plain PyTorch twin.

Port of the JAX package's ``ops/lidar_pallas.py`` (``lidar_statics``,
``lidar_rows``, ``build_lidar_fn``).  Semantics of MuJoCo rangefinders:
distance along each site's +Z to the floor plane (finite extents) or the
nearest scene AABB, -1.0 on no hit, positive readings clamped to the
cutoff.  Layout is batch-last: xpos (nbody*3, B), xquat (nbody*4, B) ->
(nsite, B).

``lidar()`` dispatches on the tensors' device: CPU tensors take the plain
twin ``lidar_plain``; CUDA tensors launch ``csrc/lidar_kernel.cu`` or
raise.  Both take an optional ``(B,)`` ``plane_z``, each env's floor height
under domain randomization, in place of the model's.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_playground_tpu_torch.ops import build
from mujoco_playground_tpu_torch.ops.lanes import qmul, qrot

BIG = 1e10
_EPS = 1e-9
_PEPS = 1e-12

_DIMS = build.header_dims()
NSITE = _DIMS["NSITE"]
MAX_BOXES = _DIMS["MAX_BOXES"]


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


class LidarConst(ctypes.Structure):
    """Mirror of ``struct LidarConst`` in ``csrc/lidar.cuh``."""
    _fields_ = [
        ("nbox", ctypes.c_int),
        ("site_body", ctypes.c_int * NSITE),
        ("site_pos", ctypes.c_float * 3 * NSITE),
        ("site_quat", ctypes.c_float * 4 * NSITE),
        ("cutoff", ctypes.c_float * NSITE),
        ("box_lo", ctypes.c_float * 3 * MAX_BOXES),
        ("box_hi", ctypes.c_float * 3 * MAX_BOXES),
        ("plane_z", ctypes.c_float),
        ("plane_half", ctypes.c_float * 2),
    ]


def fill(dst, values):
    """Copy a (nested) numpy-able value into a ctypes array, f32 or i32."""
    arr = np.asarray(values)
    flat = np.ctypeslib.as_array(dst).reshape(-1)
    flat[:arr.size] = arr.reshape(-1)


def lidar_constants(model) -> LidarConst:
    """K2's constant block for ``model`` (raises if the model does not fit
    the compiled dimensions)."""
    (site_body, site_pos, site_quat, boxes_lo, boxes_hi, plane_z,
     plane_half, cutoff) = lidar_statics(model)
    if len(site_body) != NSITE:
        raise ValueError(f"lidar kernel is compiled for {NSITE} sites, the "
                         f"model has {len(site_body)}")
    if len(boxes_lo) > MAX_BOXES:
        raise ValueError(f"scene has {len(boxes_lo)} boxes; the kernels hold "
                         f"at most {MAX_BOXES}")
    c = LidarConst()
    c.nbox = len(boxes_lo)
    fill(c.site_body, site_body)
    fill(c.site_pos, site_pos)
    fill(c.site_quat, site_quat)
    fill(c.cutoff, cutoff)
    if boxes_lo:
        fill(c.box_lo, boxes_lo)
        fill(c.box_hi, boxes_hi)
    c.plane_z = plane_z
    fill(c.plane_half, plane_half)
    return c


def check_rows(name, t, rows, B, device):
    """Raise unless ``t`` is a contiguous f32 (rows, B) tensor on device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != (rows, B):
        raise ValueError(f"{name}: expected shape {(rows, B)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_k2(lib, model, xpos, xquat, stream, plane_z=None):
    """Run K2 from the loaded library ``lib`` on ``stream``: checks the
    inputs, allocates the output, uploads the model's constants and raises
    if the launch fails.  ``plane_z`` (B,): each env's floor height in
    place of the model's.  The CUDA build takes device pointers and a CUDA
    stream; the host build of the same source (tests) CPU pointers."""
    B = xpos.shape[-1]
    check_rows("xpos", xpos, model.nbody * 3, B, xpos.device)
    check_rows("xquat", xquat, model.nbody * 4, B, xpos.device)
    if plane_z is not None:
        check_rows("plane_z", plane_z[None], 1, B, xpos.device)
    if model.nbody != _DIMS["NBODY"]:
        raise ValueError(f"lidar kernel is compiled for {_DIMS['NBODY']} "
                         f"bodies, the model has {model.nbody}")
    blob = model.cache.get("k2_const")
    if blob is None:
        blob = model.cache["k2_const"] = lidar_constants(model)
    out = torch.empty((NSITE, B), dtype=torch.float32, device=xpos.device)
    build.upload_constants(lib, "k2", blob)
    fn = lib.k2_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(xpos.data_ptr(), xquat.data_ptr(),
             None if plane_z is None else plane_z.data_ptr(), out.data_ptr(),
             B, stream)
    if err != 0:
        raise RuntimeError(f"lidar kernel launch failed: CUDA error {err}")
    return out


def lidar(model, xpos, xquat, plane_z=None):
    """K2: the standalone scan, xpos (nbody*3, B), xquat (nbody*4, B) ->
    (nsite, B); ``plane_z`` (B,): each env's floor height in place of the
    model's.  CPU tensors take the plain twin; CUDA tensors launch
    ``csrc/lidar_kernel.cu``.  ``launches`` counts the launches with the
    model's floor, ``launches_floor`` those with a per-env floor."""
    if xpos.device.type == "cpu":
        return lidar_plain(model, xpos, xquat, plane_z)
    if xpos.device.type != "cuda":
        raise ValueError(f"lidar: unsupported device {xpos.device}")
    with torch.cuda.device(xpos.device):
        out = launch_k2(build.load("lidar_kernel.cu"), model, xpos, xquat,
                        torch.cuda.current_stream(xpos.device).cuda_stream,
                        plane_z)
    if plane_z is None:
        lidar.launches += 1
    else:
        lidar.launches_floor += 1
    return out


lidar.launches = 0
lidar.launches_floor = 0
