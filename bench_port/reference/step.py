"""The physics step of a batch, frozen from the port's plain twin of kernel
K1 (``ops/step.py``: ``step_plain`` and its lane stages, the JAX package's
``ops/step_pallas.py`` lane program).  One call is one full 0.002 s step
for a batch of envs: FK -> CRBA mass matrix and RNEA bias -> actuators ->
smooth solve (leaves-first Cholesky) -> collision (the contact slots) ->
joint and contact constraint rows -> Newton solve (warm started from the
previous step's qacc) -> implicit-damping Euler -> FK of the new frames.
With ``env_statics`` it also scans the lidar on the new frames and
assembles the observation, reward and termination rows; with
``fresh_statics`` it scans the lidar at each env's auto-reset spawn pose.

Layout is batch-last: every input and output is a ``(rows, B)`` tensor,
one column per env.  Every value comes from plain IEEE operations in a
fixed order (sin and cos by ``sincos``, a correctly rounded ``sqrt``, true
divisions by constants, the contact rows summed run by run).
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .lanes import (cross3, dot3, lane, qmat, qmul, qrot, sincos, sqrt,
                    v3add, v3scale, v3sub)
from .lidar import lidar_rows, lidar_statics
from .model import JNT_FREE, JNT_HINGE
from .newton import (_is0, cholesky_solve_lanes, newton_body, sadd, smax,
                     smul, ssub)

EQ, FRICTION, CONE = 0, 1, 2   # joint row kinds: equality, friction, limit
TOPK_W = 2   # scene boxes tested per wheel

INF = 1e30   # running-min sentinel of the nearest-box and deepest-vertex picks


# --------------------------------------------------------------------------
# the static model, as Python values

class StaticModel:
    """The model's env-invariant data as numpy / Python values, read once
    (the twin of the JAX kernel's ``_StaticModel``)."""

    def __init__(self, model):
        from . import kinematics
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
