"""The fused physics step: kernel K1 and its plain PyTorch twin.

Port of the JAX package's ``ops/step_pallas.py`` (``build_step_fn`` /
``_step_kernel`` and its lane stages).  One call is one full 0.002 s step
for a batch of envs: FK -> CRBA mass matrix and RNEA bias -> actuators ->
smooth solve (leaves-first Cholesky) -> collision (48 contact slots for the
umaze robot) -> joint and contact constraint rows -> Newton solve (warm
started from the previous step's qacc) -> implicit-damping Euler -> FK of
the new frames.  With ``env_statics`` it also scans the lidar on the new
frames and assembles the observation, reward and termination rows; with
``fresh`` it scans the lidar at each env's auto-reset spawn pose.  With
``dr_params`` (kernel K1e) the nine ``DR_LAYOUT`` scalars come per env from
a packed ``(DR_ROWS, B)`` input instead of the model.

Layout is batch-last: every input and output is a ``(rows, B)`` float32
tensor, one column per env.

``step_plain`` is the plain twin: the lane program of the JAX kernel on
``(B,)`` tensors, with the model's static zeros pruned while the program is
built (``ops/newton.py``).  The kernel computes every value from the same
IEEE float32 operations in the same order (sin and cos by ``sincos``, a
correctly rounded ``sqrt``, true divisions by constants, the static
entries of M as the twin folds them, the contact rows summed run by run),
so its physics outputs are the twin's bits on the CPU and on the card, and
every discrete decision (contact activity, the rim point of a wheel
against a box, a pyramid edge or friction row in the solve) is the
twin's.  ``step_fused`` dispatches on the device: CPU tensors take the
twin, CUDA tensors launch ``csrc/step_kernel.cu`` (K1e:
``csrc/step_kernel_dr.cu``) or raise.
"""
from __future__ import annotations

import collections
import ctypes
import itertools
import math

import numpy as np
import torch

from mujoco_playground_tpu_torch.ops import build
from mujoco_playground_tpu_torch.ops.lanes import (cross3, dot3, lane, qmat,
                                                   qmul, qrot, sincos, sqrt,
                                                   v3add, v3scale, v3sub)
from mujoco_playground_tpu_torch.ops.lidar import (LidarConst, check_rows,
                                                   fill, lidar_constants,
                                                   lidar_rows, lidar_statics)
from mujoco_playground_tpu_torch.ops.newton import (_is0, cholesky_solve_lanes,
                                                    newton_body, sadd, smax,
                                                    smul, ssub)
from mujoco_playground_tpu_torch.physics.collision import TOPK_W
from mujoco_playground_tpu_torch.physics.constraint import CONE, EQ, FRICTION
from mujoco_playground_tpu_torch.physics.model import JNT_FREE, JNT_HINGE
from mujoco_playground_tpu_torch.utils import profiler

INF = 1e30   # running-min sentinel of the nearest-box and deepest-vertex picks

_DIMS = build.header_dims()
ENV_ROWS = 12   # x, y, heading, dx, dy, dist, angle, reward, gd, min, coll, term


# --------------------------------------------------------------------------
# the static model, as Python values

class StaticModel:
    """The model's env-invariant data as numpy / Python values, read once
    (the twin of the JAX kernel's ``_StaticModel``)."""

    def __init__(self, model):
        from mujoco_playground_tpu_torch.physics import kinematics
        for name in ("nq", "nv", "nu", "nbody", "njnt", "nsite",
                     "body_parent", "jnt_type", "jnt_body", "jnt_qposadr",
                     "jnt_dofadr", "dof_body", "dof_jnt", "actuator_dof",
                     "eq_dof_pairs", "limited_dofs", "friction_dofs",
                     "wheel_body", "chassis_box_body",
                     "chassis_hull_quadrants", "chassis_hull_bias",
                     "num_scene_boxes"):
            setattr(self, name, getattr(model, name))
        for name in ("body_pos", "body_quat", "body_mass", "body_ipos",
                     "body_iquat", "body_inertia", "body_invweight0",
                     "jnt_axis", "jnt_pos", "jnt_range", "jnt_solref_limit",
                     "jnt_solimp_limit", "dof_damping", "dof_armature",
                     "dof_frictionloss", "dof_invweight0", "qpos0",
                     "actuator_gain", "actuator_bias", "actuator_ctrlrange",
                     "actuator_forcerange", "eq_polycoef", "eq_solref",
                     "eq_solimp", "wheel_pos", "wheel_axis", "wheel_size",
                     "wheel_friction", "wheel_solref", "wheel_solimp",
                     "chassis_box_pos", "chassis_hull_verts",
                     "plane_friction", "plane_solref", "plane_solimp",
                     "scene_box_pos", "scene_box_size", "gravity"):
            setattr(self, name, getattr(model, name).detach().cpu().numpy())
        self.plane_z = float(model.plane_z)
        self.timestep = float(model.timestep)
        self.iterations = model.solver_iterations
        self.ls_iterations = model.ls_iterations
        self.ancestor_mask = kinematics.ancestor_mask(model)
        self.dof_qposadr = [
            self.jnt_qposadr[self.dof_jnt[d]]
            + (d - self.jnt_dofadr[self.dof_jnt[d]]) for d in range(self.nv)]
        free = set()
        for j in range(self.njnt):
            if self.jnt_type[j] == JNT_FREE:
                free.update(range(self.jnt_dofadr[j], self.jnt_dofadr[j] + 6))
        # leaves-first Cholesky elimination order: wheel-chain dofs before
        # the free joint's 6, so the tree-sparse matrices factor without
        # fill-in
        self.order = (tuple(v for v in range(self.nv) if v not in free)
                      + tuple(v for v in range(self.nv) if v in free))
        self.carried = [True] * self.nv
        for j in range(self.njnt):
            if self.jnt_type[j] == JNT_FREE:
                adr = self.jnt_dofadr[j]
                self.carried[adr:adr + 3] = [False] * 3
        # bodies that carry inertia (the world and massless bodies drop out)
        self.bodies = [b for b in range(self.nbody)
                       if self.body_mass[b] != 0.0
                       or np.any(self.body_inertia[b])]

    def f(self, name, *idx):
        """One model scalar as a Python float."""
        v = getattr(self, name)
        for k in idx:
            v = v[k]
        return float(v)

    def vec(self, name, *idx):
        v = getattr(self, name)
        for k in idx:
            v = v[k]
        return [float(x) for x in v]


def static_model(model) -> StaticModel:
    sm = model.cache.get("static")
    if sm is None:
        sm = model.cache["static"] = StaticModel(model)
    return sm


# --------------------------------------------------------------------------
# domain-randomized scalars (kernel K1e)

# The per-env scalar model parameters K1e takes as lane inputs: the set
# envs.domain_randomization.randomize_model perturbs (a copy of the JAX
# package's step_pallas.DR_LAYOUT).  name -> shape of its indices given the
# static model; the packed input carries one (B,) row per scalar, in this
# field order, indices row-major.  Geometry, solref/solimp and the
# invweights are not randomizable here (the invweights stay the base
# model's, as in the JAX kernel).
DR_LAYOUT = (
    ("body_mass", lambda sm: (sm.nbody,)),
    ("body_inertia", lambda sm: (sm.nbody, 3)),
    ("dof_damping", lambda sm: (sm.nv,)),
    ("dof_armature", lambda sm: (sm.nv,)),
    ("dof_frictionloss", lambda sm: (sm.nv,)),
    ("actuator_gain", lambda sm: (sm.nu,)),
    ("actuator_bias", lambda sm: (sm.nu, 3)),
    ("wheel_friction", lambda sm: (len(sm.wheel_body),)),   # [w, 0] scalar
    ("plane_z", lambda sm: ()),
)
DR_SUPPORTED = tuple(name for name, _ in DR_LAYOUT)


def dr_param_rows(sm, dr_fields):
    """Packed (row offset, shape) per randomized field, and the row count."""
    offs, p = {}, 0
    for name, shape_fn in DR_LAYOUT:
        if name not in dr_fields:
            continue
        shape = shape_fn(sm)
        offs[name] = (p, shape)
        p += int(np.prod(shape)) if shape else 1
    return offs, p


def pack_dr_params(models, dr_fields):
    """Randomized ``Model`` leaves (leading env axis) -> the ``(P, B)`` rows
    K1e reads: ``DR_LAYOUT`` order, row-major, wheel friction's tangential
    column only."""
    rows = []
    for name, _ in DR_LAYOUT:
        if name not in dr_fields:
            continue
        leaf = getattr(models, name)
        if name == "wheel_friction":
            leaf = leaf[..., 0]
        rows.append(leaf.reshape(leaf.shape[0], -1).T)
    return torch.cat(rows, dim=0).contiguous()


class DRView:
    """Static-or-lane access to the ``DR_LAYOUT`` scalars (the JAX kernel's
    ``_DRView``): ``val(name, *idx)`` is the env's ``(B,)`` lane of the
    packed ``dr_params`` (every ``DR_SUPPORTED`` field, as K1e takes them),
    or without them the model's value as a Python float, so the twin keeps
    pruning static zeros."""

    def __init__(self, sm: StaticModel, dr_params=None):
        self.sm = sm
        self.lanes = dr_params
        self.offs = {}
        if dr_params is not None:
            self.offs, rows = dr_param_rows(sm, DR_SUPPORTED)
            if dr_params.shape[0] != rows:
                raise ValueError(f"dr_params: expected {rows} rows (every "
                                 f"DR_SUPPORTED field), got "
                                 f"{dr_params.shape[0]}")

    def val(self, name, *idx):
        if name in self.offs:
            off, shape = self.offs[name]
            flat = 0
            for k, n in zip(idx, shape):
                flat = flat * n + k
            return self.lanes[off + flat]
        v = np.asarray(getattr(self.sm, name))
        for k in idx:
            v = v[k]
        # wheel_friction stores (nw, 3) coefficients; the scalar is the
        # tangential mu in column 0
        return float(v.flat[0]) if v.ndim else float(v)


# --------------------------------------------------------------------------
# lane helpers

class _Lanes:
    """Batch size, dtype and device of the lanes of one call."""

    def __init__(self, B, dtype, device):
        self.B, self.dtype, self.device = B, dtype, device

    def __call__(self, x):
        return lane(x, self.B, self.dtype, self.device)

    def full(self, v):
        return torch.full((self.B,), float(v), dtype=self.dtype,
                          device=self.device)


def qaxisangle(axis, theta):
    """Static unit axis + lane angle -> quat."""
    s, c = sincos(theta * 0.5)
    return [c, smul(axis[0], s), smul(axis[1], s), smul(axis[2], s)]


def qintegrate(q, omega, dt):
    """Integrate a quaternion by a local angular velocity, normalized."""
    w2 = sadd(smul(omega[0], omega[0]), smul(omega[1], omega[1]),
              smul(omega[2], omega[2]))
    angle = sqrt(w2)
    safe = torch.where(angle > 1e-14, angle, 1.0)
    sh, ch = sincos(angle * dt * 0.5)
    s = torch.where(angle > 1e-14, sh / safe, 0.0)
    dq = [ch, smul(omega[0], s), smul(omega[1], s),
          smul(omega[2], s)]
    out = qmul(q, dq)
    norm = sqrt(sadd(*[smul(out[k], out[k]) for k in range(4)]))
    return [out[k] / norm for k in range(4)]


# --------------------------------------------------------------------------
# MuJoCo's impedance spline and reference acceleration

def imp_params(solimp):
    """Host constants of the impedance spline of one static solimp:
    (d0, dmax - d0, width, mid, a, b, power)."""
    d0, dmax, width, mid, power = [float(s) for s in solimp]
    return (d0, dmax - d0, max(width, 1e-12), mid,
            1.0 / mid ** (power - 1.0), 1.0 / (1.0 - mid) ** (power - 1.0),
            power)


def _pow(x, p):
    """x**p with small integer powers unrolled (no exp(log) NaN at 0)."""
    if float(p) == int(p) and 0 < int(p) <= 4:
        out = x
        for _ in range(int(p) - 1):
            out = out * x
        return out
    return x ** p


def divide(x, c):
    """Lane x over static c by a true float32 division on either device,
    as the kernels divide: PyTorch's CUDA kernels multiply by the rounded
    reciprocal of a Python-number divisor, which can miss by an ulp."""
    return x / torch.full_like(x, c)


def impedance(solimp, r):
    """Impedance d(r) for static ``solimp``; ``r`` a lane or a float."""
    d0, dmm, width, mid, a, b, power = imp_params(solimp)
    if isinstance(r, float):
        x = min(max(abs(r) / width, 0.0), 1.0)
        y = a * _pow(x, power) if x <= mid else 1.0 - b * _pow(1.0 - x, power)
        return d0 + y * dmm
    x = torch.clamp(divide(torch.abs(r), width), 0.0, 1.0)
    y = torch.where(x <= mid, a * _pow(x, power),
                    1.0 - b * _pow(1.0 - x, power))
    return d0 + y * dmm


def ref_params(solref, solimp):
    """(b, k denominator) of the reference acceleration aref = -b vel -
    (d / kden) pos, for static solref/solimp."""
    dmax = float(solimp[1])
    tc, zeta = float(solref[0]), float(solref[1])
    return 2.0 / (dmax * tc), dmax * dmax * tc * tc * zeta * zeta


def kbi(solref, solimp, pos, vel):
    """(aref, d) for static solref/solimp; pos/vel lanes or static 0."""
    d = impedance(solimp, pos if not _is0(pos) else 0.0)
    b, kden = ref_params(solref, solimp)
    k = d / kden if isinstance(d, float) else divide(d, kden)
    return ssub(smul(-b, vel), smul(k, pos)), d


# --------------------------------------------------------------------------
# kinematics and smooth dynamics

def fk_lanes(sm: StaticModel, qvec):
    """qvec: nq lanes -> (xpos, xquat) as per-body [3]/[4] lists."""
    xpos = [[0.0, 0.0, 0.0]]
    xquat = [[1.0, 0.0, 0.0, 0.0]]
    for b in range(1, sm.nbody):
        p = sm.body_parent[b]
        pos = v3add(xpos[p], qrot(xquat[p], sm.vec("body_pos", b)))
        quat = qmul(xquat[p], sm.vec("body_quat", b))
        for j in range(sm.njnt):
            if sm.jnt_body[j] != b:
                continue
            adr = sm.jnt_qposadr[j]
            t = sm.jnt_type[j]
            if t == JNT_FREE:
                pos = [qvec[adr], qvec[adr + 1], qvec[adr + 2]]
                q = [qvec[adr + 3 + k] for k in range(4)]
                norm = sqrt(sadd(*[smul(q[k], q[k]) for k in range(4)]))
                quat = [q[k] / norm for k in range(4)]
            elif t == JNT_HINGE:
                theta = qvec[adr] - sm.f("qpos0", adr)
                jp = sm.vec("jnt_pos", j)
                anchor = v3add(pos, qrot(quat, jp))
                quat = qmul(quat, qaxisangle(sm.vec("jnt_axis", j), theta))
                if any(jp):
                    pos = v3sub(anchor, qrot(quat, jp))
            else:  # slide
                pos = v3add(pos, v3scale(qvec[adr] - sm.f("qpos0", adr),
                                         qrot(quat, sm.vec("jnt_axis", j))))
        xpos.append(pos)
        xquat.append(quat)
    return xpos, xquat


def motion_subspace_lanes(sm: StaticModel, xpos, xquat, anchor):
    """S: nv spatial [6] (ang, lin) lists about ``anchor``."""
    S = []
    for j in range(sm.njnt):
        b = sm.jnt_body[j]
        t = sm.jnt_type[j]
        if t == JNT_FREE:
            for k in range(3):
                e = [0.0] * 3
                e[k] = 1.0
                S.append([0.0, 0.0, 0.0] + e)
            R = qmat(xquat[b])
            for k in range(3):
                w = [R[0][k], R[1][k], R[2][k]]
                S.append(w + cross3(w, v3sub(anchor, xpos[b])))
        else:
            axis_w = qrot(xquat[b], sm.vec("jnt_axis", j))
            anch = xpos[b]
            if any(sm.vec("jnt_pos", j)):
                anch = v3add(anch, qrot(xquat[b], sm.vec("jnt_pos", j)))
            if t == JNT_HINGE:
                S.append(axis_w + cross3(axis_w, v3sub(anchor, anch)))
            else:
                S.append([0.0, 0.0, 0.0] + axis_w)
    return S


def spatial_inertia_lanes(sm: StaticModel, b, xpos_b, xquat_b, anchor, dr):
    """6x6 spatial inertia (list of rows) of body b about anchor."""
    R = qmat(qmul(xquat_b, sm.vec("body_iquat", b)))
    diag = [dr.val("body_inertia", b, k) for k in range(3)]
    Iw = [[sadd(*[smul(smul(R[i][k], diag[k]), R[j][k]) for k in range(3)])
           for j in range(3)] for i in range(3)]
    com = v3add(xpos_b, qrot(xquat_b, sm.vec("body_ipos", b)))
    c = v3sub(com, anchor)
    m = dr.val("body_mass", b)
    cx = [[0.0, ssub(0.0, c[2]), c[1]],
          [c[2], 0.0, ssub(0.0, c[0])],
          [ssub(0.0, c[1]), c[0], 0.0]]
    I6 = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            I6[i][j] = sadd(Iw[i][j], smul(m, sadd(
                *[smul(cx[i][k], cx[j][k]) for k in range(3)])))
            I6[i][3 + j] = smul(m, cx[i][j])
            I6[3 + i][j] = smul(m, cx[j][i])
            I6[3 + i][3 + j] = m if i == j else 0.0
    return I6


def _motion_cross(v, s):
    return (cross3(v[:3], s[:3])
            + v3add(cross3(v[3:], s[:3]), cross3(v[:3], s[3:])))


def _force_cross(v, f):
    return (v3add(cross3(v[:3], f[:3]), cross3(v[3:], f[3:]))
            + cross3(v[:3], f[3:]))


def crba_bias_lanes(sm: StaticModel, xpos, xquat, vvec, dr):
    """(M nv x nv lists, fbias nv list, S, anchor): mass matrix by CRBA as
    sum_b J_b^T I_b J_b and bias forces by RNEA."""
    nv = sm.nv
    anchor = xpos[1] if sm.nbody > 1 else [0.0, 0.0, 0.0]
    S = motion_subspace_lanes(sm, xpos, xquat, anchor)
    mask = sm.ancestor_mask
    J, IJ, Ibar = {}, {}, {}
    for b in sm.bodies:
        Jb = [[S[v][k] if mask[b, v] else 0.0 for v in range(nv)]
              for k in range(6)]
        I6 = spatial_inertia_lanes(sm, b, xpos[b], xquat[b], anchor, dr)
        IJ[b] = [[sadd(*[smul(I6[k][l], Jb[l][v]) for l in range(6)])
                  for v in range(nv)] for k in range(6)]
        J[b], Ibar[b] = Jb, I6

    M = [[0.0] * nv for _ in range(nv)]
    for v in range(nv):
        for w in range(v, nv):
            M[v][w] = sadd(*[smul(J[b][k][v], IJ[b][k][w])
                             for b in sm.bodies for k in range(6)])
            M[w][v] = M[v][w]
    for v in range(nv):
        M[v][v] = sadd(M[v][v], dr.val("dof_armature", v))

    vbody = {b: [sadd(*[smul(J[b][k][v], vvec[v]) for v in range(nv)])
                 for k in range(6)] for b in sm.bodies}
    cdot = []
    for d in range(nv):
        if sm.carried[d] and sm.dof_body[d] in vbody:
            mc = _motion_cross(vbody[sm.dof_body[d]], S[d])
            cdot.append([smul(mc[k], vvec[d]) for k in range(6)])
        else:
            cdot.append([0.0] * 6)

    a0 = [0.0, 0.0, 0.0] + [-float(g) for g in sm.gravity]
    fbias = [0.0] * nv
    for b in sm.bodies:
        abody = [sadd(a0[k], *[cdot[v][k] for v in range(nv) if mask[b, v]])
                 for k in range(6)]
        Iv = [sadd(*[smul(Ibar[b][k][l], vbody[b][l]) for l in range(6)])
              for k in range(6)]
        Ia = [sadd(*[smul(Ibar[b][k][l], abody[l]) for l in range(6)])
              for k in range(6)]
        fc = _force_cross(vbody[b], Iv)
        fb = [sadd(Ia[k], fc[k]) for k in range(6)]
        for v in range(nv):
            fbias[v] = sadd(fbias[v],
                            *[smul(J[b][k][v], fb[k]) for k in range(6)])
    return M, fbias, S, anchor


def actuator_lanes(sm: StaticModel, qvec, vvec, cvec, dr):
    """ctrl -> generalized force per dof (nv lanes / static zeros)."""
    out = [0.0] * sm.nv
    for u in range(sm.nu):
        d = sm.actuator_dof[u]
        cr = sm.vec("actuator_ctrlrange", u)
        fr = sm.vec("actuator_forcerange", u)
        c = torch.clamp(cvec[u], cr[0], cr[1])
        bias = [dr.val("actuator_bias", u, k) for k in range(3)]
        force = sadd(smul(dr.val("actuator_gain", u), c), bias[0],
                     smul(bias[1], qvec[sm.dof_qposadr[d]]),
                     smul(bias[2], vvec[d]))
        if all(math.isfinite(x) for x in fr):
            force = torch.clamp(force, fr[0], fr[1])
        out[d] = sadd(out[d], force)
    return out


# --------------------------------------------------------------------------
# collision narrowphase

def make_frame(n, L):
    """Tangent frame rows [n, t1, t2] of a contact normal."""
    if all(isinstance(x, float) for x in n):
        a = [1.0, 0.0, 0.0] if abs(n[0]) < 0.5 else [0.0, 1.0, 0.0]
        t1 = np.cross(n, a)
        t1 = (t1 / max(np.linalg.norm(t1), 1e-12)).tolist()
        return [list(n), t1, np.cross(n, t1).tolist()]
    cond = torch.abs(L(n[0])) < 0.5
    a = [torch.where(cond, 1.0, 0.0), torch.where(cond, 0.0, 1.0), 0.0]
    t1 = cross3(n, a)
    t1n = torch.clamp_min(sqrt(sadd(*[smul(t1[k], t1[k])
                                      for k in range(3)])), 1e-12)
    t1 = [t1[k] / t1n for k in range(3)]
    return [list(n), t1, cross3(n, t1)]


def point_box(p, bp, bs):
    """Point vs AABB: (dist, normal, contact point)."""
    rel = v3sub(p, bp)
    q = [torch.abs(rel[k]) - bs[k] for k in range(3)]
    inside = (q[0] < 0) & (q[1] < 0) & (q[2] < 0)
    qpos_part = [torch.clamp_min(q[k], 0.0) for k in range(3)]
    dist_out = sqrt(sadd(*[smul(qpos_part[k], qpos_part[k])
                           for k in range(3)]))
    is0 = (q[0] >= q[1]) & (q[0] >= q[2])
    is1 = (~is0) & (q[1] >= q[2])
    is2 = (~is0) & (~is1)
    axsel = [is0, is1, is2]
    qmax = torch.where(is0, q[0], torch.where(is1, q[1], q[2]))
    n_in = [torch.where(axsel[k], torch.sign(rel[k]), 0.0) for k in range(3)]
    delta = [rel[k] - torch.clamp(rel[k], -bs[k], bs[k]) for k in range(3)]
    dn = sqrt(sadd(*[smul(delta[k], delta[k]) for k in range(3)]))
    dsafe = torch.clamp_min(dn, 1e-9)
    n_out = [delta[k] / dsafe for k in range(3)]
    n = [torch.where(inside, n_in[k], n_out[k]) for k in range(3)]
    dist = torch.where(inside, qmax, dist_out)
    pos = [p[k] - 0.5 * dist * n[k] for k in range(3)]
    return dist, n, pos


def cylinder_box(c, a, r, h, bp, bs, L):
    """Cylinder vs AABB: one candidate per disc end, the rim point nearest
    the box (two fixed-point iterations), collided as a point."""
    ax = [L(a[k]) for k in range(3)]
    fx = [ssub(1.0, ax[0] * ax[0]), ssub(0.0, ax[0] * ax[1]),
          ssub(0.0, ax[0] * ax[2])]
    fy = [ssub(0.0, ax[1] * ax[0]), ssub(1.0, ax[1] * ax[1]),
          ssub(0.0, ax[1] * ax[2])]
    fxn = sqrt(sadd(*[smul(fx[k], fx[k]) for k in range(3)]))
    use_x = fxn > 0.1
    fall = [torch.where(use_x, fx[k], fy[k]) for k in range(3)]
    fn = torch.clamp_min(sqrt(sadd(*[smul(fall[k], fall[k])
                                     for k in range(3)])), 1e-12)
    fall = [fall[k] / fn for k in range(3)]
    out = []
    for e in (-1.0, 1.0):
        ce = v3add(c, v3scale(e * h, a))
        q = ce
        for _ in range(2):
            cp = [bp[k] + torch.clamp(L(ssub(q[k], bp[k])), -bs[k], bs[k])
                  for k in range(3)]
            d = v3sub(cp, ce)
            da = sadd(*[smul(d[k], ax[k]) for k in range(3)])
            dperp = [ssub(d[k], smul(da, ax[k])) for k in range(3)]
            dn = sqrt(L(sadd(*[smul(dperp[k], dperp[k])
                               for k in range(3)])))
            dsafe = torch.clamp_min(dn, 1e-9)
            u = [torch.where(dn > 1e-9, dperp[k] / dsafe, fall[k])
                 for k in range(3)]
            q = v3add(ce, v3scale(r, u))
        out.append(point_box(q, bp, bs))
    return out


def keep_deepest(cands, L):
    """The candidate with the smallest ``score`` (ties keep the earlier
    one), as a running where-chain; payload = every key."""
    def sel(cond, a_, b_):
        if isinstance(a_, list):
            return [torch.where(cond, a_[j], b_[j]) for j in range(len(a_))]
        return torch.where(cond, a_, b_)

    kept = {k: (L.full(INF) if k in ("dist", "score")
                else [L.full(0.0)] * len(cands[0][k])) for k in cands[0]}
    for c in cands:
        better = c["score"] < kept["score"]
        kept = {k: sel(better, c[k], kept[k]) for k in c}
    return kept


def _pick(cond, a, b):
    """Where ``cond``, box ``a`` (d2, bp, bs), else box ``b``."""
    return dict(d2=torch.where(cond, a["d2"], b["d2"]),
                bp=[torch.where(cond, a["bp"][k], b["bp"][k])
                    for k in range(3)],
                bs=[torch.where(cond, a["bs"][k], b["bs"][k])
                    for k in range(3)])


def nearest_boxes(sm: StaticModel, c, count, L):
    """The ``count`` (1 or 2) scene boxes nearest to point c by squared
    surface distance, as dicts of (d2, bp, bs) lanes: a strictly closer box
    replaces the best and the old best moves to second; ties keep the
    earlier box (the order of ``top_k(-d2)``)."""
    blank = dict(d2=L.full(INF), bp=[L.full(0.0)] * 3, bs=[L.full(0.0)] * 3)
    best, second = blank, blank
    for kbox in range(sm.num_scene_boxes):
        bp = sm.vec("scene_box_pos", kbox)
        bs = sm.vec("scene_box_size", kbox)
        q = [torch.clamp_min(torch.abs(L(ssub(c[k], bp[k]))) - bs[k], 0.0)
             for k in range(3)]
        cand = dict(d2=sadd(*[smul(q[k], q[k]) for k in range(3)]),
                    bp=[L(x) for x in bp], bs=[L(x) for x in bs])
        isb = cand["d2"] < best["d2"]
        if count > 1:
            iss = (~isb) & (cand["d2"] < second["d2"])
            second = _pick(isb, best, _pick(iss, cand, second))
        best = _pick(isb, cand, best)
    return [best, second][:count]


def slot_statics(sm: StaticModel, dr=None):
    """Per contact slot, in slot order: (body, friction, solref, solimp,
    invweight, wheel index or -1) — the static half of ``collide_lanes``.
    Under ``dr`` a wheel slot's friction is the env's lane."""
    dr = dr or DRView(sm)

    def combine(w):
        fric = smax(dr.val("wheel_friction", w), float(sm.plane_friction[0]))
        solref = [0.5 * (float(sm.wheel_solref[w, k])
                         + float(sm.plane_solref[k])) for k in range(2)]
        solimp = [0.5 * (float(sm.wheel_solimp[w, k])
                         + float(sm.plane_solimp[k])) for k in range(5)]
        return fric, solref, solimp

    out = []
    nw = len(sm.wheel_body)
    for w in range(nw):
        b = sm.wheel_body[w]
        out += [(b, *combine(w), float(sm.body_invweight0[b, 0]), w)] * 4
    if sm.num_scene_boxes > 0:
        for w in range(nw):
            b = sm.wheel_body[w]
            n = 2 * min(TOPK_W, sm.num_scene_boxes)
            out += [(b, *combine(w), float(sm.body_invweight0[b, 0]), w)] * n
    for i, b in enumerate(sm.chassis_box_body):
        hull = (b, max(float(sm.plane_friction[0]), 1.0),
                [float(v) for v in sm.plane_solref],
                [float(v) for v in sm.plane_solimp],
                float(sm.body_invweight0[b, 0]), -1)
        out += [hull] * (8 if sm.num_scene_boxes > 0 else 4)
    return out


def collide_lanes(sm: StaticModel, xpos, xquat, L, dr):
    """Contact slots in the order of the JAX package's ``collide``: per
    slot a dict of pos [3], frame [3][3] and dist."""
    slots = []
    nw = len(sm.wheel_body)
    plane_z = dr.val("plane_z")
    plane_frame = make_frame([0.0, 0.0, 1.0], L)

    def emit_plane(p):
        dist = ssub(p[2], plane_z)
        slots.append(dict(pos=[p[0], p[1], ssub(p[2], smul(0.5, dist))],
                          frame=plane_frame, dist=dist))

    # wheels vs plane: two rim candidates + the deep-face +-120 degree pair
    for w in range(nw):
        b = sm.wheel_body[w]
        c = v3add(xpos[b], qrot(xquat[b], sm.vec("wheel_pos", w)))
        a = qrot(xquat[b], sm.vec("wheel_axis", w))
        r, h = sm.f("wheel_size", w, 0), sm.f("wheel_size", w, 1)
        az = L(a[2])
        proj = [ssub(0.0, smul(az, a[0])), ssub(0.0, smul(az, a[1])),
                ssub(1.0, smul(az, a[2]))]
        pn = sqrt(L(sadd(*[smul(proj[k], proj[k]) for k in range(3)])))
        pns = torch.clamp_min(pn, 1e-9)
        # degenerate fallback -x: deepest candidate at +x (MuJoCo's pick)
        raddir = [torch.where(pn > 1e-9, proj[0] / pns, -1.0),
                  torch.where(pn > 1e-9, proj[1] / pns, 0.0),
                  torch.where(pn > 1e-9, proj[2] / pns, 0.0)]
        for sgn in (-1.0, 1.0):
            emit_plane(v3sub(v3add(c, v3scale(sgn * h, a)),
                             v3scale(r, raddir)))
        deep_sgn = torch.where(az > 0, -1.0, 1.0)
        deep_center = [sadd(c[k], smul(h * deep_sgn, a[k])) for k in range(3)]
        t = cross3(a, raddir)
        for s in (-1.0, 1.0):
            dirv = [sadd(smul(0.5, raddir[k]),
                         smul(s * math.sqrt(3) / 2, t[k])) for k in range(3)]
            emit_plane(v3add(deep_center, v3scale(r, dirv)))

    # wheels vs the nearest TOPK_W boxes
    if sm.num_scene_boxes > 0:
        topk = min(TOPK_W, sm.num_scene_boxes)
        for w in range(nw):
            b = sm.wheel_body[w]
            c = v3add(xpos[b], qrot(xquat[b], sm.vec("wheel_pos", w)))
            a = qrot(xquat[b], sm.vec("wheel_axis", w))
            r, h = sm.f("wheel_size", w, 0), sm.f("wheel_size", w, 1)
            for cand in nearest_boxes(sm, c, TOPK_W, L)[:topk]:
                for dist, n, p in cylinder_box(c, a, r, h, cand["bp"],
                                               cand["bs"], L):
                    slots.append(dict(pos=p, frame=make_frame(n, L),
                                      dist=dist))

    # chassis hulls vs plane (deepest vertex per xy quadrant) and vs the
    # nearest box
    for i, b in enumerate(sm.chassis_box_body):
        Rb = qmat(xquat[b])
        verts = []
        for v in sm.chassis_hull_verts[i]:
            local = [float(v[0]), float(v[1]), float(v[2])]
            verts.append(v3add(xpos[b], [
                sadd(*[smul(Rb[r][k], local[k]) for k in range(3)])
                for r in range(3)]))
        bias = [float(x) for x in sm.chassis_hull_bias[i]]
        cands = []
        for kv, p in enumerate(verts):
            dist = ssub(p[2], plane_z)
            cands.append(dict(score=ssub(dist, bias[kv]), dist=dist,
                              pos=[p[0], p[1], ssub(p[2], smul(0.5, dist))]))
        for q in sm.chassis_hull_quadrants[i]:
            kept = keep_deepest([cands[k] for k in q], L)
            slots.append(dict(pos=kept["pos"], frame=plane_frame,
                              dist=kept["dist"]))
        if sm.num_scene_boxes > 0:
            center = v3add(xpos[b], qrot(xquat[b],
                                         sm.vec("chassis_box_pos", i)))
            nb = nearest_boxes(sm, center, 1, L)[0]
            cands = []
            for kv, p in enumerate(verts):
                dist, n, cp = point_box(p, nb["bp"], nb["bs"])
                cands.append(dict(score=ssub(dist, bias[kv]), dist=dist,
                                  pos=cp, n=n))
            for q in sm.chassis_hull_quadrants[i]:
                kept = keep_deepest([cands[k] for k in q], L)
                slots.append(dict(pos=kept["pos"],
                                  frame=make_frame(kept["n"], L),
                                  dist=kept["dist"]))
    return slots


# --------------------------------------------------------------------------
# constraint rows

def joint_rows_lanes(sm: StaticModel, qvec, vvec, dr):
    """Joint rows (equality, dry friction, limits), as dicts."""
    rows = []
    for e, (d1, d2) in enumerate(sm.eq_dof_pairs):
        q1adr, q2adr = sm.dof_qposadr[d1], sm.dof_qposadr[d2]
        q2 = qvec[q2adr] - sm.f("qpos0", q2adr)
        coef = sm.vec("eq_polycoef", e)
        poly = sadd(coef[0], smul(coef[1], q2), smul(coef[2], q2 * q2),
                    smul(coef[3], q2 * q2 * q2),
                    smul(coef[4], (q2 * q2) * (q2 * q2)))
        dpoly = sadd(coef[1], smul(2 * coef[2], q2),
                     smul(3 * coef[3], q2 * q2),
                     smul(4 * coef[4], q2 * q2 * q2))
        pos = ssub(qvec[q1adr] - sm.f("qpos0", q1adr), poly)
        vel = ssub(vvec[d1], smul(dpoly, vvec[d2]))
        aref, d = kbi(sm.eq_solref[e], sm.eq_solimp[e], pos, vel)
        diag = float(sm.dof_invweight0[d1] + sm.dof_invweight0[d2])
        rows.append(dict(dof1=d1, dof2=d2, coef1=1.0, coef2=ssub(0.0, dpoly),
                         aref=aref,
                         R=torch.clamp_min((1.0 - d) / d * diag, 1e-10),
                         floss=0.0, active=1.0, kind=EQ))
    for d1 in sm.friction_dofs:
        aref, d = kbi([0.02, 1.0], [0.9, 0.95, 0.001, 0.5, 2.0], 0.0,
                      vvec[d1])
        rows.append(dict(
            dof1=d1, dof2=0, coef1=1.0, coef2=0.0, aref=aref,
            R=max((1.0 - d) / d * float(sm.dof_invweight0[d1]), 1e-10),
            floss=dr.val("dof_frictionloss", d1), active=1.0,
            kind=FRICTION))
    for d1 in sm.limited_dofs:
        jid = sm.dof_jnt[d1]
        qadr = sm.dof_qposadr[d1]
        for side in (0, 1):
            if side == 0:
                dist = qvec[qadr] - sm.f("jnt_range", jid, 0)
                coef = 1.0
            else:
                dist = sm.f("jnt_range", jid, 1) - qvec[qadr]
                coef = -1.0
            aref, d = kbi(sm.jnt_solref_limit[jid], sm.jnt_solimp_limit[jid],
                          torch.clamp_max(dist, 0.0), smul(coef, vvec[d1]))
            rows.append(dict(
                dof1=d1, dof2=0, coef1=coef, coef2=0.0, aref=aref,
                R=torch.clamp_min(
                    (1.0 - d) / d * float(sm.dof_invweight0[d1]), 1e-10),
                floss=0.0, active=(dist < 0).to(aref.dtype), kind=CONE))
    return rows


def contact_rows_lanes(sm: StaticModel, slots, statics, S, anchor, vvec):
    """Per slot: the pyramid rows' Jacobians Jn/Jt1/Jt2 (nv lists), aref4,
    R, mu and the active flag."""
    nv = sm.nv
    out = []
    for s, (body, mu_, solref, solimp, iw, _) in zip(slots, statics):
        bmask = sm.ancestor_mask[body]
        arm = v3sub(s["pos"], anchor)
        Jn, Jt1, Jt2 = [0.0] * nv, [0.0] * nv, [0.0] * nv
        fr = s["frame"]
        for v in range(nv):
            if not bmask[v]:
                continue
            Jp = v3add(S[v][3:], cross3(S[v][:3], arm))
            Jn[v] = dot3(Jp, fr[0])
            Jt1[v] = dot3(Jp, fr[1])
            Jt2[v] = dot3(Jp, fr[2])
        dist = s["dist"]
        d_imp = impedance(solimp, dist)
        bcoef, kden = ref_params(solref, solimp)
        kcoef = divide(d_imp, kden)
        diag = smax(iw * 2.0 * mu_ ** 2 * (1.0 + mu_ ** 2), 1e-12)
        vn = sadd(*[smul(Jn[v], vvec[v]) for v in range(nv)])
        vt1 = sadd(*[smul(Jt1[v], vvec[v]) for v in range(nv)])
        vt2 = sadd(*[smul(Jt2[v], vvec[v]) for v in range(nv)])
        vel4 = [sadd(vn, smul(mu_, vt1)), ssub(vn, smul(mu_, vt1)),
                sadd(vn, smul(mu_, vt2)), ssub(vn, smul(mu_, vt2))]
        out.append(dict(
            Jn=Jn, Jt1=Jt1, Jt2=Jt2,
            aref4=[ssub(smul(-bcoef, vel4[k]), kcoef * dist)
                   for k in range(4)],
            R=torch.clamp_min((1.0 - d_imp) / d_imp * diag, 1e-10),
            mu=mu_, active=(dist < 0).to(dist.dtype)))
    return out


# --------------------------------------------------------------------------
# the plain twin

def physics_plain(model, qpos, qvel, ctrl, warmstart, ws_compare=False,
                  dr_params=None):
    """One physics step on (rows, B) tensors.  Returns (qpos', qvel',
    xpos (nbody*3, B), xquat (nbody*4, B), qacc (nv, B)).  ``dr_params``
    (``DR_ROWS``, B): each env's randomized scalars (K1e)."""
    sm = static_model(model)
    dr = DRView(sm, dr_params)
    nq, nv, nu = sm.nq, sm.nv, sm.nu
    B = qpos.shape[-1]
    L = _Lanes(B, qpos.dtype, qpos.device)
    h = sm.timestep

    qvec = [qpos[i] for i in range(nq)]
    vvec = [qvel[i] for i in range(nv)]
    cvec = [ctrl[i] for i in range(nu)]

    # FK + smooth dynamics
    xpos, xquat = fk_lanes(sm, qvec)
    M, fbias, S, anchor = crba_bias_lanes(sm, xpos, xquat, vvec, dr)
    qfrc_act = actuator_lanes(sm, qvec, vvec, cvec, dr)
    qfrc_smooth = [ssub(ssub(qfrc_act[v],
                             smul(dr.val("dof_damping", v), vvec[v])),
                        fbias[v]) for v in range(nv)]
    qacc_smooth = cholesky_solve_lanes(M, [L(f) for f in qfrc_smooth], nv,
                                       order=sm.order)

    # collision + constraint rows
    slots = collide_lanes(sm, xpos, xquat, L, dr)
    jrows = joint_rows_lanes(sm, qvec, vvec, dr)
    statics = slot_statics(sm, dr)
    crows = contact_rows_lanes(sm, slots, statics, S, anchor, vvec)

    njrows = []
    for r in jrows:
        G = [0.0] * nv
        G[r["dof1"]] = sadd(G[r["dof1"]], r["coef1"])
        if not _is0(r["coef2"]):
            G[r["dof2"]] = sadd(G[r["dof2"]], r["coef2"])
        njrows.append(dict(G=G, aref=r["aref"], Rinv=1.0 / r["R"],
                           floss=r["floss"], active=r["active"],
                           is_eq=r["kind"] == EQ,
                           is_fric=r["kind"] == FRICTION))
    # contact rows in runs of consecutive slots of one body, over the dofs
    # that move it: kernel K1 sums each run's rows in order into a partial
    # (csrc/step_newton.cuh ROW_RUN), as newton_body sums a group's stack
    cgroups = []
    for body, run in itertools.groupby(zip(statics, crows),
                                       key=lambda x: x[0][0]):
        rows = [c for _, c in run]
        dofs = tuple(v for v in range(nv) if sm.ancestor_mask[body, v])

        def stk(vals):
            return torch.stack([L(x) for x in vals])
        cgroups.append(dict(
            dofs=dofs,
            Jn=[stk([c["Jn"][v] for c in rows]) for v in dofs],
            Jt1=[stk([c["Jt1"][v] for c in rows]) for v in dofs],
            Jt2=[stk([c["Jt2"][v] for c in rows]) for v in dofs],
            aref4=[stk([c["aref4"][k] for c in rows]) for k in range(4)],
            Rinv=stk([1.0 / c["R"] for c in rows]),
            mu=stk([c["mu"] for c in rows]),
            active=stk([c["active"] for c in rows])))
    a_s = [L(a) for a in qacc_smooth]
    a0 = [warmstart[v] for v in range(nv)]
    qacc = newton_body(nv, sm.iterations, sm.ls_iterations, M, a_s, njrows,
                       cgroups, order=sm.order, a0=a0, ws_compare=ws_compare)

    # implicit-damping Euler: (M + h D) v' = M (v + h a) + h D v
    MhD = [[M[v][w] for w in range(nv)] for v in range(nv)]
    rhs = [0.0] * nv
    for v in range(nv):
        hd = smul(h, dr.val("dof_damping", v))
        MhD[v][v] = sadd(MhD[v][v], hd)
        rhs[v] = sadd(
            sadd(*[smul(M[v][w], sadd(vvec[w], smul(h, qacc[w])))
                   for w in range(nv)]),
            smul(hd, vvec[v]))
    vnew = cholesky_solve_lanes(MhD, [L(r) for r in rhs], nv, order=sm.order)

    qnew = [None] * nq
    for j in range(sm.njnt):
        adr, dadr = sm.jnt_qposadr[j], sm.jnt_dofadr[j]
        if sm.jnt_type[j] == JNT_FREE:
            for k in range(3):
                qnew[adr + k] = qvec[adr + k] + h * vnew[dadr + k]
            quat = qintegrate([qvec[adr + 3 + k] for k in range(4)],
                              [vnew[dadr + 3 + k] for k in range(3)], h)
            qnew[adr + 3:adr + 7] = quat
        else:
            qnew[adr] = qvec[adr] + h * vnew[dadr]
    xpos_new, xquat_new = fk_lanes(sm, qnew)
    return (torch.stack(qnew), torch.stack([L(v) for v in vnew]),
            torch.stack([L(xpos_new[b][k]) for b in range(sm.nbody)
                         for k in range(3)]),
            torch.stack([L(xquat_new[b][k]) for b in range(sm.nbody)
                         for k in range(4)]),
            torch.stack([L(q) for q in qacc]))


def contact_activity(model, qpos, dr_params=None):
    """(nslot, B) bool: which contact slots are in contact (dist < 0) at the
    frames of qpos (nq, B), in ``slot_statics`` order: the rows the Newton
    solve iterates over."""
    sm = static_model(model)
    L = _Lanes(qpos.shape[-1], qpos.dtype, qpos.device)
    xpos, xquat = fk_lanes(sm, [qpos[i] for i in range(sm.nq)])
    slots = collide_lanes(sm, xpos, xquat, L, DRView(sm, dr_params))
    return torch.stack([L(s["dist"]) < 0 for s in slots])


def env_plain(model, xpos, xquat, env_in, env_statics, fresh_statics=None,
              dr_params=None):
    """The fused env rows on post-step frames xpos (nbody*3, B), xquat
    (nbody*4, B): [lidar (nsite), x, y, heading, dx, dy, dist, angle,
    reward, goal distance, min lidar, collision, terminated] and, with
    ``fresh_statics``, the lidar at each env's fresh spawn pose (nsite).
    With ``dr_params`` both scans see each env's floor height.

    ``env_in`` (5 or 7, B) = [ref_x, ref_y, goal_x, goal_y, prev goal
    distance(, fresh_x, fresh_y)]; ``env_statics`` = (collision threshold,
    goal threshold, progress scale, lidar aliasing, collision ignores
    no-hit, collision penalty)."""
    B = xpos.shape[-1]
    L = _Lanes(B, xpos.dtype, xpos.device)
    lstat = lidar_statics(model)
    if dr_params is not None:
        plane_z = DRView(static_model(model), dr_params).val("plane_z")
        lstat = lstat[:5] + (plane_z,) + lstat[6:]
    bodies = sorted(set(lstat[0]))
    bp = {b: [xpos[3 * b + k] for k in range(3)] for b in bodies}
    bq = {b: [xquat[4 * b + k] for k in range(4)] for b in bodies}
    rows = lidar_rows(*lstat, bp, bq)
    coll_th, goal_th, prog_scale, aliasing, ignores_nohit, coll_pen = \
        env_statics
    if aliasing:
        rows = [rows[71]] * 10 + rows[10:]
    ref_x, ref_y, goal_x, goal_y, prev_gd = (env_in[k] for k in range(5))
    px = xpos[3] - ref_x
    py = xpos[4] - ref_y
    qw, qx, qy, qz = (xquat[4 + k] for k in range(4))
    heading = torch.atan2(2.0 * (qw * qz + qx * qy),
                          1.0 - 2.0 * (qy * qy + qz * qz))
    gx = goal_x - px
    gy = goal_y - py
    gd = sqrt(gx * gx + gy * gy)
    ga = torch.atan2(gy, gx) - heading
    # wrap to [-pi, pi)
    ga = ga - 2.0 * math.pi * torch.floor((ga + math.pi) / (2.0 * math.pi))
    mrows = ([torch.where(r < 0.0, math.inf, r) for r in rows]
             if ignores_nohit else rows)
    min_lidar = mrows[0]
    for r in mrows[1:]:
        min_lidar = torch.minimum(min_lidar, r)
    collision = min_lidar < coll_th
    terminated = gd < goal_th
    reward = (-gd * 0.1 + torch.where(terminated, 100.0, 0.0)
              + torch.where(collision, coll_pen, 0.0) - 0.01
              + prog_scale * (prev_gd - gd))
    out = rows + [px, py, heading, gx, gy, gd, ga, reward, gd, min_lidar,
                  collision.to(xpos.dtype), terminated.to(xpos.dtype)]
    if fresh_statics is not None:
        # the lidar at the fresh spawn pose: template frames shifted in xy
        t_xpos, t_xquat, t_xy = fresh_statics
        offx = env_in[5] - t_xy[0]
        offy = env_in[6] - t_xy[1]
        fbp = {b: [L(t_xpos[b][0]) + offx, L(t_xpos[b][1]) + offy,
                   L(t_xpos[b][2])] for b in bodies}
        fbq = {b: [L(v) for v in t_xquat[b]] for b in bodies}
        frows = lidar_rows(*lstat, fbp, fbq)
        if aliasing:
            frows = [frows[71]] * 10 + frows[10:]
        out = out + frows
    return torch.stack(out)


def step_plain(model, qpos, qvel, ctrl, warmstart, env_in=None,
               env_statics=None, fresh_statics=None, ws_compare=False,
               dr_params=None):
    """Plain twin of K1 (K1e with ``dr_params``) on (rows, B) tensors.
    Returns (qpos', qvel', xpos, xquat, qacc) and, with ``env_statics``,
    the env slab as a sixth."""
    outs = physics_plain(model, qpos, qvel, ctrl, warmstart, ws_compare,
                         dr_params)
    if env_statics is None:
        return outs
    return outs + (env_plain(model, outs[2], outs[3], env_in, env_statics,
                             fresh_statics, dr_params),)


# --------------------------------------------------------------------------
# kernel K1

NQ, NV, NU, NBODY = _DIMS["NQ"], _DIMS["NV"], _DIMS["NU"], _DIMS["NBODY"]
NJNT, NWHEEL, NHULL = _DIMS["NJNT"], _DIMS["NWHEEL"], _DIMS["NHULL"]
NHULLV, NJROW, NSLOT = _DIMS["NHULLV"], _DIMS["NJROW"], _DIMS["NSLOT"]
MAX_BOXES, DOF_JROWS = _DIMS["MAX_BOXES"], _DIMS["DOF_JROWS"]
NBDOF = _DIMS["NBDOF"]
_F, _I = ctypes.c_float, ctypes.c_int


class Imp(ctypes.Structure):
    """Mirror of ``struct Imp`` in ``csrc/step_kernel.cu``: one impedance
    spline and reference-acceleration parameter set."""
    _fields_ = [("d0", _F), ("dmm", _F), ("width", _F), ("mid", _F),
                ("a", _F), ("b", _F), ("power", _F), ("ipower", _I),
                ("bref", _F), ("kden", _F)]


class K1Const(ctypes.Structure):
    """Mirror of ``struct K1Const`` in ``csrc/step_kernel.cu``."""
    _fields_ = [
        ("body_parent", _I * NBODY),
        ("body_inert", _I * NBODY),
        ("body_pos", _F * 3 * NBODY), ("body_quat", _F * 4 * NBODY),
        ("body_mass", _F * NBODY), ("body_ipos", _F * 3 * NBODY),
        ("body_iquat", _F * 4 * NBODY), ("body_inertia", _F * 3 * NBODY),
        ("jnt_type", _I * NJNT), ("jnt_body", _I * NJNT),
        ("jnt_qposadr", _I * NJNT), ("jnt_dofadr", _I * NJNT),
        ("jnt_axis", _F * 3 * NJNT), ("jnt_pos", _F * 3 * NJNT),
        ("qpos0", _F * NQ),
        ("dof_body", _I * NV), ("dof_qposadr", _I * NV),
        ("dof_carried", _I * NV), ("order", _I * NV),
        ("dof_damping", _F * NV), ("dof_armature", _F * NV),
        ("h_damping", _F * NV),
        ("act_dof", _I * NU), ("act_qadr", _I * NU),
        ("act_gain", _F * NU), ("act_bias", _F * 3 * NU),
        ("act_ctrlrange", _F * 2 * NU), ("act_forcerange", _F * 2 * NU),
        # joint rows
        ("jr_kind", _I * NJROW), ("jr_dof1", _I * NJROW),
        ("jr_dof2", _I * NJROW), ("jr_qadr1", _I * NJROW),
        ("jr_qadr2", _I * NJROW),
        ("jr_q01", _F * NJROW), ("jr_q02", _F * NJROW),
        ("jr_coef", _F * 5 * NJROW), ("jr_side", _F * NJROW),
        ("jr_limit", _F * NJROW), ("jr_diag", _F * NJROW),
        ("jr_rinv", _F * NJROW), ("jr_floss", _F * NJROW),
        ("jr_imp", Imp * NJROW),
        # contact slots
        ("slot_body", _I * NSLOT), ("slot_mu", _F * NSLOT),
        ("slot_diag", _F * NSLOT), ("slot_imp", Imp * NSLOT),
        # geometry
        ("wheel_body", _I * NWHEEL), ("wheel_pos", _F * 3 * NWHEEL),
        ("wheel_axis", _F * 3 * NWHEEL), ("wheel_size", _F * 2 * NWHEEL),
        ("hull_body", _I * NHULL),
        ("hull_quad", ctypes.c_uint64 * 4 * NHULL),
        ("hull_verts", _F * 3 * NHULLV * NHULL),
        ("hull_bias", _F * NHULLV * NHULL),
        ("hull_center", _F * 3 * NHULL),
        ("plane_frame", _F * 9),
        ("box_pos", _F * 3 * MAX_BOXES), ("box_size", _F * 3 * MAX_BOXES),
        ("nbox", _I), ("iterations", _I), ("ls_iterations", _I),
        ("timestep", _F), ("gravity", _F * 3),
        ("lidar", LidarConst),
        ("t_xpos", _F * 3 * NBODY), ("t_xquat", _F * 4 * NBODY),
        ("t_xy", _F * 2),
        # K1e: per slot its wheel (-1: a hull slot) and invweight
        ("slot_wheel", _I * NSLOT), ("slot_iw", _F * NSLOT),
        ("plane_mu", _F),
        # position of each dof in the elimination order (order's inverse)
        ("order_inv", _I * NV),
        # per body its ancestor dofs as bits, and its depth in the tree
        ("body_dofs", ctypes.c_uint32 * NBODY), ("body_depth", _I * NBODY),
        ("max_depth", _I),
        # the (v, w), v < w, of each entry above an NV x NV diagonal, row by
        # row; per dof the joint rows that touch it (ascending, -1 padded)
        ("off_v", _I * (NV * (NV - 1) // 2)),
        ("off_w", _I * (NV * (NV - 1) // 2)),
        ("dof_jrows", _I * DOF_JROWS * NV),
        # per slot its run of consecutive slots of one body (-1: a slot the
        # scene cannot fill)
        ("slot_run", _I * NSLOT),
        # the state-independent entries of M and of M + h D's diagonal
        # (static_mass_entries)
        ("m_static", ctypes.c_uint32 * NV), ("m_value", _F * NV * NV),
        ("mh_static", ctypes.c_uint32), ("mh_value", _F * NV),
    ]


def _imp(solref, solimp) -> Imp:
    d0, dmm, width, mid, a, b, power = imp_params(solimp)
    bref, kden = ref_params(solref, solimp)
    ip = int(power) if float(power) == int(power) and 0 < power <= 4 else 0
    return Imp(d0, dmm, width, mid, a, b, power, ip, bref, kden)


def static_mass_entries(sm: StaticModel):
    """The entries of M (nv x nv) and of the diagonal of M + h D (nv)
    that the twin computes as Python floats while it builds its program
    (sums of the model's masses and armatures, independent of the state),
    each None where it is a lane; K1 takes them from its constant block,
    so it rounds them as the twin does."""
    L = _Lanes(1, torch.float32, "cpu")
    xpos, xquat = fk_lanes(sm, [L(float(x)) for x in sm.qpos0])
    M = crba_bias_lanes(sm, xpos, xquat, [L(0.0)] * sm.nv, DRView(sm))[0]

    def static(x):
        return None if isinstance(x, torch.Tensor) else float(x)
    m = [[static(M[v][w]) for w in range(sm.nv)] for v in range(sm.nv)]
    mh = [static(sadd(M[v][v], smul(sm.timestep, sm.f("dof_damping", v))))
          for v in range(sm.nv)]
    return m, mh


def _check_dims(sm: StaticModel):
    have = dict(NQ=sm.nq, NV=sm.nv, NU=sm.nu, NBODY=sm.nbody, NJNT=sm.njnt,
                NSITE=sm.nsite, NWHEEL=len(sm.wheel_body),
                NHULL=len(sm.chassis_box_body),
                NJROW=(len(sm.eq_dof_pairs) + len(sm.friction_dofs)
                       + 2 * len(sm.limited_dofs)))
    for k, v in have.items():
        if _DIMS[k] != v:
            raise ValueError(f"the step kernel is compiled for {k}={_DIMS[k]}"
                             f", the model has {v}")
    # a hull of fewer vertices (a box proxy's 8 corners) is padded with
    # vertices that no quadrant lists, so the kernel never picks them
    if sm.chassis_hull_verts.shape[1] > _DIMS["NHULLV"]:
        raise ValueError(f"the step kernel holds at most NHULLV="
                         f"{_DIMS['NHULLV']} vertices per hull, the model "
                         f"has {sm.chassis_hull_verts.shape[1]}")
    if len(sm.eq_dof_pairs) != _DIMS["NEQ"] or \
            len(sm.friction_dofs) != _DIMS["NFRIC"]:
        raise ValueError("the step kernel is compiled for another joint "
                         "row layout")
    if sm.num_scene_boxes > MAX_BOXES:
        raise ValueError(f"scene has {sm.num_scene_boxes} boxes; the kernels "
                         f"hold at most {MAX_BOXES}")


def step_constants(model, fresh_statics=None) -> K1Const:
    """K1's constant block for ``model`` (and the fresh-spawn template)."""
    sm = static_model(model)
    _check_dims(sm)
    c = K1Const()
    fill(c.body_parent, sm.body_parent)
    fill(c.body_inert, [int(b in sm.bodies) for b in range(sm.nbody)])
    for name in ("body_pos", "body_quat", "body_mass", "body_ipos",
                 "body_iquat", "body_inertia", "jnt_axis", "jnt_pos",
                 "qpos0", "dof_damping", "dof_armature"):
        fill(getattr(c, name), getattr(sm, name))
    for name in ("jnt_type", "jnt_body", "jnt_qposadr", "jnt_dofadr",
                 "dof_body", "dof_qposadr", "order"):
        fill(getattr(c, name), getattr(sm, name))
    fill(c.dof_carried, [int(x) for x in sm.carried])
    fill(c.h_damping, [sm.timestep * sm.f("dof_damping", v)
                       for v in range(sm.nv)])
    fill(c.act_dof, sm.actuator_dof)
    fill(c.act_qadr, [sm.dof_qposadr[d] for d in sm.actuator_dof])
    fill(c.act_gain, sm.actuator_gain)
    fill(c.act_bias, sm.actuator_bias)
    fill(c.act_ctrlrange, sm.actuator_ctrlrange)
    fill(c.act_forcerange, sm.actuator_forcerange)

    r = 0
    for e, (d1, d2) in enumerate(sm.eq_dof_pairs):
        c.jr_kind[r], c.jr_dof1[r], c.jr_dof2[r] = EQ, d1, d2
        c.jr_qadr1[r], c.jr_qadr2[r] = sm.dof_qposadr[d1], sm.dof_qposadr[d2]
        c.jr_q01[r] = sm.f("qpos0", sm.dof_qposadr[d1])
        c.jr_q02[r] = sm.f("qpos0", sm.dof_qposadr[d2])
        fill(c.jr_coef[r], sm.eq_polycoef[e])
        c.jr_diag[r] = float(sm.dof_invweight0[d1] + sm.dof_invweight0[d2])
        c.jr_imp[r] = _imp(sm.eq_solref[e], sm.eq_solimp[e])
        r += 1
    for d1 in sm.friction_dofs:
        c.jr_kind[r], c.jr_dof1[r] = FRICTION, d1
        solref, solimp = [0.02, 1.0], [0.9, 0.95, 0.001, 0.5, 2.0]
        d = impedance(solimp, 0.0)
        c.jr_rinv[r] = 1.0 / max((1.0 - d) / d * float(
            sm.dof_invweight0[d1]), 1e-10)
        c.jr_floss[r] = sm.f("dof_frictionloss", d1)
        c.jr_imp[r] = _imp(solref, solimp)
        r += 1
    for d1 in sm.limited_dofs:
        jid = sm.dof_jnt[d1]
        for side in (0, 1):
            c.jr_kind[r], c.jr_dof1[r] = CONE, d1
            c.jr_qadr1[r] = sm.dof_qposadr[d1]
            c.jr_side[r] = 1.0 if side == 0 else -1.0
            c.jr_limit[r] = sm.f("jnt_range", jid, side)
            c.jr_diag[r] = float(sm.dof_invweight0[d1])
            c.jr_imp[r] = _imp(sm.jnt_solref_limit[jid],
                               sm.jnt_solimp_limit[jid])
            r += 1

    # the kernel keeps a fixed slot layout (wheel-plane, wheel-box,
    # per hull: plane then box); slots a scene cannot fill stay inactive
    statics = slot_statics(sm)
    layout = _slot_layout(sm)
    fill(c.slot_wheel, [-1] * NSLOT)
    fill(c.slot_run, [-1] * NSLOT)
    for run, (_, slots) in enumerate(itertools.groupby(
            zip(layout, statics), key=lambda x: x[1][0])):
        for s, _ in slots:
            c.slot_run[s] = run
    for s, st_ in zip(layout, statics):
        body, mu_, solref, solimp, iw, wheel = st_
        c.slot_body[s] = body
        c.slot_mu[s] = mu_
        c.slot_diag[s] = max(iw * 2.0 * mu_ ** 2 * (1.0 + mu_ ** 2), 1e-12)
        c.slot_imp[s] = _imp(solref, solimp)
        c.slot_wheel[s] = wheel
        c.slot_iw[s] = iw
    c.plane_mu = float(sm.plane_friction[0])
    fill(c.order_inv, [sm.order.index(v) for v in range(sm.nv)])
    depth = [0] * sm.nbody
    for b in range(1, sm.nbody):
        depth[b] = depth[sm.body_parent[b]] + 1
        c.body_dofs[b] = sum(1 << v for v in range(sm.nv)
                             if sm.ancestor_mask[b][v] != 0)
    fill(c.body_depth, depth)
    c.max_depth = max(depth)
    most = max(bin(d).count("1") for d in c.body_dofs)
    if most > NBDOF:
        raise ValueError(f"a body has {most} dofs; the step kernel holds at "
                         f"most {NBDOF}")
    off = [(v, w) for v in range(sm.nv) for w in range(v + 1, sm.nv)]
    m, mh = static_mass_entries(sm)
    for v in range(sm.nv):
        c.m_static[v] = sum(1 << w for w in range(sm.nv)
                            if m[v][w] is not None)
        fill(c.m_value[v], [x or 0.0 for x in m[v]])
    c.mh_static = sum(1 << v for v in range(sm.nv) if mh[v] is not None)
    fill(c.mh_value, [x or 0.0 for x in mh])
    fill(c.off_v, [v for v, _ in off])
    fill(c.off_w, [w for _, w in off])
    for v in range(sm.nv):
        rows = [r for r in range(NJROW) if c.jr_dof1[r] == v
                or (c.jr_kind[r] == EQ and c.jr_dof2[r] == v)]
        if len(rows) > DOF_JROWS:
            raise ValueError(f"dof {v} has {len(rows)} joint rows; the step "
                             f"kernel holds at most {DOF_JROWS}")
        fill(c.dof_jrows[v], rows + [-1] * (DOF_JROWS - len(rows)))

    fill(c.wheel_body, sm.wheel_body)
    fill(c.wheel_pos, sm.wheel_pos)
    fill(c.wheel_axis, sm.wheel_axis)
    fill(c.wheel_size, sm.wheel_size)
    fill(c.hull_body, sm.chassis_box_body)
    for i, quads in enumerate(sm.chassis_hull_quadrants):
        for k, q in enumerate(quads):
            c.hull_quad[i][k] = sum(1 << int(v) for v in q)
    for i in range(len(sm.chassis_box_body)):
        fill(c.hull_verts[i], sm.chassis_hull_verts[i])
        fill(c.hull_bias[i], sm.chassis_hull_bias[i])
    fill(c.hull_center, sm.chassis_box_pos)
    fill(c.plane_frame, make_frame([0.0, 0.0, 1.0], None))
    if sm.num_scene_boxes:
        fill(c.box_pos, sm.scene_box_pos)
        fill(c.box_size, sm.scene_box_size)
    c.nbox = sm.num_scene_boxes
    c.iterations, c.ls_iterations = sm.iterations, sm.ls_iterations
    c.timestep = sm.timestep
    fill(c.gravity, sm.gravity)
    c.lidar = lidar_constants(model)
    if fresh_statics is not None:
        t_xpos, t_xquat, t_xy = fresh_statics
        fill(c.t_xpos, t_xpos)
        fill(c.t_xquat, t_xquat)
        fill(c.t_xy, t_xy)
    return c


def _slot_layout(sm: StaticModel):
    """Kernel slot index of each slot of ``collide_lanes``, in order."""
    nw, nh = len(sm.wheel_body), len(sm.chassis_box_body)
    out = list(range(4 * nw))
    if sm.num_scene_boxes:
        n = 2 * min(TOPK_W, sm.num_scene_boxes)
        for w in range(nw):
            out += [4 * nw + 4 * w + k for k in range(n)]
    base = 8 * nw
    for i in range(nh):
        out += [base + 8 * i + k for k in range(4)]
        if sm.num_scene_boxes:
            out += [base + 8 * i + 4 + k for k in range(4)]
    return out


def _env_rows(model, fresh):
    return model.nsite + ENV_ROWS + (model.nsite if fresh else 0)


# The (with_env, with_fresh, ws_compare, dr) flag sets compiled into K1
# (dr: K1e, csrc/step_kernel_dr.cu), and their callers; K1 launches no
# other.
K1_VARIANTS = {(True, True, False, False): "step_autoreset_batch",
               (True, False, False, False): "AckermannEnv.step_batch",
               (False, False, True, False): "the settle template",
               (False, False, False, False):
                   "engine.step_batch without the env: every physics "
                   "substep but the last, and the step under delayed obs",
               (True, True, False, True):
                   "DomainRandomizedEnv.step_autoreset_batch",
               (True, False, False, True):
                   "DomainRandomizedEnv.step_batch, and its auto-reset "
                   "under spawn_heading_noise",
               (False, False, False, True):
                   "DomainRandomizedEnv under physics substeps or delayed "
                   "obs"}


def check_variant(env_statics, fresh_statics, ws_compare, dr_params=None):
    """The ``K1_VARIANTS`` key of a call's flags; raises if it is not
    compiled."""
    key = (env_statics is not None, fresh_statics is not None,
           bool(ws_compare), dr_params is not None)
    if key not in K1_VARIANTS:
        raise ValueError(
            f"step kernel: no variant with_env={key[0]}, with_fresh={key[1]}"
            f", ws_compare={key[2]}, dr={key[3]}; compiled: "
            f"{sorted(K1_VARIANTS)}")
    return key


def step_fused(model, qpos, qvel, ctrl, warmstart, env_in=None,
               env_statics=None, fresh_statics=None, ws_compare=False,
               dr_params=None):
    """K1: one step of a batch, (rows, B) float32 in and out; K1e with
    ``dr_params`` (``DR_ROWS``, B), each env's randomized scalars.

    Returns (qpos', qvel', xpos (nbody*3, B), xquat (nbody*4, B), qacc
    (nv, B)) and, with ``env_statics``, the env slab (nsite + 12 [+ nsite
    with ``fresh_statics``], B).  CPU tensors take ``step_plain``; CUDA
    tensors launch ``csrc/step_kernel.cu`` (K1e: ``step_kernel_dr.cu``).
    Only the flag sets of ``K1_VARIANTS`` are accepted, on either device.
    ``launches`` counts K1 launches, ``launches_dr`` K1e launches, and
    ``by_variant`` both by their ``K1_VARIANTS`` key.  The span ``ops.k1``
    times the card's launch path (``launch_k1``)."""
    key = check_variant(env_statics, fresh_statics, ws_compare, dr_params)
    if qpos.device.type == "cpu":
        return step_plain(model, qpos, qvel, ctrl, warmstart, env_in,
                          env_statics, fresh_statics, ws_compare, dr_params)
    if qpos.device.type != "cuda":
        raise ValueError(f"step_fused: unsupported device {qpos.device}")
    src = "step_kernel.cu" if dr_params is None else "step_kernel_dr.cu"
    with profiler.span("ops.k1"), torch.cuda.device(qpos.device):
        out = launch_k1(build.load(src), model, qpos, qvel, ctrl, warmstart,
                        env_in, env_statics, fresh_statics, ws_compare,
                        torch.cuda.current_stream(qpos.device).cuda_stream,
                        dr_params)
    if dr_params is None:
        step_fused.launches += 1
    else:
        step_fused.launches_dr += 1
    step_fused.by_variant[key] += 1
    return out


step_fused.launches = 0
step_fused.launches_dr = 0
step_fused.by_variant = collections.Counter()


def launch_k1(lib, model, qpos, qvel, ctrl, warmstart, env_in, env_statics,
              fresh_statics, ws_compare, stream, dr_params=None):
    """Run K1 (K1e with ``dr_params``, from the library of
    ``step_kernel_dr.cu``) from the loaded library ``lib`` on ``stream``:
    checks the inputs, allocates the outputs, uploads the model's constants
    and raises if the launch fails.  The CUDA build takes device pointers
    and a CUDA stream; the host build of the same source (tests) CPU
    pointers."""
    check_variant(env_statics, fresh_statics, ws_compare, dr_params)
    dev = qpos.device
    B = qpos.shape[-1]
    for name, t, rows in (("qpos", qpos, model.nq), ("qvel", qvel, model.nv),
                          ("ctrl", ctrl, model.nu),
                          ("warmstart", warmstart, model.nv)):
        check_rows(name, t, rows, B, dev)
    with_env = env_statics is not None
    with_fresh = fresh_statics is not None
    if with_env:
        check_rows("env_in", env_in, 7 if with_fresh else 5, B, dev)
    prefix = "k1" if dr_params is None else "k1e"
    if dr_params is not None:
        rows_fn = lib.k1e_dr_rows
        rows_fn.restype = ctypes.c_int
        check_rows("dr_params", dr_params, rows_fn(), B, dev)
    key = ("k1_const", fresh_statics)
    blob = model.cache.get(key)
    if blob is None:
        blob = model.cache[key] = step_constants(model, fresh_statics)
    out = [torch.empty((rows, B), dtype=torch.float32, device=dev)
           for rows in (model.nq, model.nv, model.nbody * 3,
                        model.nbody * 4, model.nv)]
    if with_env:
        out.append(torch.empty((_env_rows(model, with_fresh), B),
                               dtype=torch.float32, device=dev))
        (coll_th, goal_th, prog_scale, aliasing, ignores_nohit,
         coll_pen) = env_statics
    else:
        coll_th = goal_th = prog_scale = coll_pen = 0.0
        aliasing = ignores_nohit = False
    build.upload_constants(lib, prefix, blob)
    fn = getattr(lib, f"{prefix}_launch")
    nptr = 11 if dr_params is None else 12
    fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptr = [t.data_ptr() for t in (qpos, qvel, ctrl, warmstart)]
    ptr.append(env_in.data_ptr() if with_env else None)
    if dr_params is not None:
        ptr.append(dr_params.data_ptr())
    ptr += [t.data_ptr() for t in out[:5]]
    ptr.append(out[5].data_ptr() if with_env else None)
    err = fn(*ptr, B, int(with_env), int(with_fresh), int(ws_compare),
             int(bool(aliasing)) | (int(bool(ignores_nohit)) << 1),
             float(coll_th), float(goal_th), float(prog_scale),
             float(coll_pen), stream)
    if err != 0:
        raise RuntimeError(f"step kernel launch failed: CUDA error {err}")
    return tuple(out)
