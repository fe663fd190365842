"""Spec -> static model compiler (frozen from the port's
``physics/model.py``).

Compilation runs once on the host in numpy and yields a :class:`Model`: a
dataclass of tensors on the chosen device plus the static topology as
Python ints and tuples.  Welded (jointless) bodies are fused into their
parent (the robot's ``base``/``ceiling``/``lidar_360`` fold into
``chassis``), so the kinematic tree has 8 bodies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import spec_types as st
from .scene import SceneSpec, open_floor_scene

# Joint type codes (static).
JNT_FREE = 0
JNT_HINGE = 1
JNT_SLIDE = 2

_JNT_CODE = {st.FREE: JNT_FREE, st.HINGE: JNT_HINGE, st.SLIDE: JNT_SLIDE}

# Static (host) fields, in declaration order.

# Tensor fields, in declaration order (the JAX Model's pytree leaves).

# The rank of each array field in one env's model.  Under domain
# randomization a field may carry one more, leading, axis: a value per env.


@dataclasses.dataclass(eq=False)
class Model:
    """Static physics model: topology as Python values, data as tensors.

    Shapes of the tensors: ``body_*`` (nbody, k), ``jnt_*`` (njnt, k),
    ``dof_*`` (nv,), ``wheel_*`` (nwheel, k), ``chassis_hull_verts``
    (nhull, V, 3) in the body frame, ``scene_box_*`` (K, 3), scalars for
    ``plane_z`` and ``timestep``.
    """

    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    nsite: int
    body_parent: Tuple[int, ...]
    body_names: Tuple[str, ...]
    jnt_type: Tuple[int, ...]
    jnt_body: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    jnt_names: Tuple[str, ...]
    dof_body: Tuple[int, ...]
    dof_jnt: Tuple[int, ...]
    site_body: Tuple[int, ...]
    site_names: Tuple[str, ...]
    actuator_dof: Tuple[int, ...]
    actuator_names: Tuple[str, ...]
    eq_dof_pairs: Tuple[Tuple[int, int], ...]
    limited_dofs: Tuple[int, ...]
    friction_dofs: Tuple[int, ...]
    sensor_kinds: Tuple[str, ...]
    sensor_obj: Tuple[int, ...]
    sensor_names: Tuple[str, ...]
    wheel_body: Tuple[int, ...]
    chassis_box_body: Tuple[int, ...]
    # per chassis hull: 4 body-frame-xy quadrants of vertex indices; the
    # narrowphase keeps the deepest vertex per quadrant
    chassis_hull_quadrants: Tuple[Tuple[Tuple[int, ...], ...], ...]
    # per-vertex depth bias toward xy-extreme vertices (breaks flat ties)
    chassis_hull_bias: Tuple[Tuple[float, ...], ...]
    # hull triangles (index triples into chassis_hull_verts' unpadded
    # leading rows) in MuJoCo's mesh-graph face order; the
    # compat_flat_manifold support-face manifold reads them
    chassis_hull_faces: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    num_scene_boxes: int
    # parity-compat manifolds (PARITY.md approximations 1-2): the support
    # vertex's deepest incident hull face against the plane, and MuJoCo's
    # 3 mid-tread points per wheel-box pair; both take the staged step
    compat_flat_manifold: bool
    compat_wheel_patch: bool
    solver_iterations: int
    ls_iterations: int

    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_mass: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_inertia: torch.Tensor       # (nbody, 3) principal moments
    body_invweight0: torch.Tensor    # (nbody, 2) [trn, rot]
    jnt_axis: torch.Tensor
    jnt_pos: torch.Tensor
    jnt_range: torch.Tensor
    jnt_solref_limit: torch.Tensor
    jnt_solimp_limit: torch.Tensor
    dof_damping: torch.Tensor
    dof_armature: torch.Tensor
    dof_frictionloss: torch.Tensor
    dof_invweight0: torch.Tensor
    qpos0: torch.Tensor
    site_pos: torch.Tensor
    site_quat: torch.Tensor
    actuator_gain: torch.Tensor
    actuator_bias: torch.Tensor
    actuator_ctrlrange: torch.Tensor
    actuator_forcerange: torch.Tensor  # +-inf when unbounded
    eq_polycoef: torch.Tensor
    eq_solref: torch.Tensor
    eq_solimp: torch.Tensor
    wheel_pos: torch.Tensor
    wheel_axis: torch.Tensor
    wheel_size: torch.Tensor           # (nwheel, 2) radius, half-width
    wheel_friction: torch.Tensor
    wheel_solref: torch.Tensor
    wheel_solimp: torch.Tensor
    chassis_box_pos: torch.Tensor
    chassis_box_quat: torch.Tensor
    chassis_box_size: torch.Tensor
    chassis_hull_verts: torch.Tensor
    plane_z: torch.Tensor
    plane_half_size: torch.Tensor      # <= 0 means infinite
    plane_friction: torch.Tensor
    plane_solref: torch.Tensor
    plane_solimp: torch.Tensor
    scene_box_pos: torch.Tensor
    scene_box_size: torch.Tensor
    gravity: torch.Tensor
    timestep: torch.Tensor
    sensor_cutoff: torch.Tensor
    # host-side caches derived from the fields above (numpy copies for the
    # plain kernels, constant blocks for the CUDA kernels)
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)

    @property
    def dtype(self):
        return self.body_pos.dtype

    @property
    def device(self):
        return self.body_pos.device


def _rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _fuse_welded(spec: st.ModelSpec):
    """Fold jointless bodies into their parents; returns (order, fused),
    the jointed bodies in topological order and, per body, its combined
    inertials, geoms and sites re-expressed in its frame."""
    hosts = {}  # body name -> (host name, pos offset, quat offset)
    fused = {}  # host name -> dict(inertials=[], geoms=[], sites=[])
    order = []
    for b in spec.bodies:
        if b.joints or b.parent == "world":
            hosts[b.name] = (b.name, np.zeros(3), np.array([1.0, 0, 0, 0]))
            fused[b.name] = dict(body=b, inertials=[], geoms=[], sites=[])
            order.append(b.name)
        else:
            hname, hpos, hquat = hosts[b.parent]
            pos = hpos + _rot(hquat) @ np.asarray(b.pos)
            quat = np.asarray(st.quat_mul_np(tuple(hquat), tuple(b.quat)))
            hosts[b.name] = (hname, pos, quat)
        hname, hpos, hquat = hosts[b.name]
        entry = fused[hname]
        R = _rot(hquat)
        if b.inertial is not None:
            ip = hpos + R @ np.asarray(b.inertial.pos)
            iq = np.asarray(st.quat_mul_np(tuple(hquat),
                                           tuple(b.inertial.quat)))
            entry["inertials"].append((b.inertial.mass, ip, iq,
                                       np.asarray(b.inertial.diaginertia)))
        else:
            # no explicit inertial: derive it from the primitive geoms that
            # carry a mass (MuJoCo's inertiafromgeom)
            for g in b.geoms:
                gi = _geom_inertial(g)
                if gi is None:
                    continue
                gm, gpos, gquat, gdiag = gi
                ip = hpos + R @ gpos
                iq = np.asarray(st.quat_mul_np(tuple(hquat), tuple(gquat)))
                entry["inertials"].append((gm, ip, iq, gdiag))
        for g in b.geoms:
            gp = hpos + R @ np.asarray(g.pos)
            gq = np.asarray(st.quat_mul_np(tuple(hquat), tuple(g.quat)))
            entry["geoms"].append(dataclasses.replace(
                g, pos=tuple(gp), quat=tuple(gq)))
        for s_ in b.sites:
            sp = hpos + R @ np.asarray(s_.pos)
            sq = np.asarray(st.quat_mul_np(tuple(hquat), tuple(s_.quat)))
            entry["sites"].append(dataclasses.replace(
                s_, pos=tuple(sp), quat=tuple(sq)))
    for name in order:
        b = fused[name]["body"]
        fused[name]["parent"] = (hosts[b.parent][0] if b.parent != "world"
                                 else "world")
    return order, fused


def _geom_inertial(g: st.GeomSpec):
    """Analytic inertia of a primitive geom with explicit mass, in the geom
    frame: (mass, pos, quat, diaginertia) or None."""
    if g.mass is None:
        return None
    m = float(g.mass)
    s = g.size
    if g.type == st.SPHERE:
        r = s[0]
        diag = np.full(3, 0.4 * m * r * r)
    elif g.type == st.BOX:
        hx, hy, hz = s[:3]
        diag = m / 3.0 * np.array([hy * hy + hz * hz, hx * hx + hz * hz,
                                   hx * hx + hy * hy])
    elif g.type in (st.CYLINDER, st.CAPSULE):
        # capsules are approximated as cylinders (mass bookkeeping only)
        r, h = s[0], s[1]
        ixx = m * (3 * r * r + 4 * h * h) / 12.0
        diag = np.array([ixx, ixx, 0.5 * m * r * r])
    else:
        return None
    return m, np.asarray(g.pos), np.asarray(g.quat), diag


def _combine_inertials(inertials):
    """Combine (mass, ipos, iquat, diaginertia) tuples into one inertial,
    re-diagonalized to its principal frame (descending moments)."""
    if not inertials:
        return 0.0, np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(3)
    total_mass = sum(m for m, *_ in inertials)
    com = sum(m * p for m, p, *_ in inertials) / max(total_mass, 1e-30)
    inertia = np.zeros((3, 3))
    for m, p, q, diag in inertials:
        R = _rot(q)
        d = p - com
        inertia += (R @ np.diag(diag) @ R.T
                    + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d)))
    evals, evecs = np.linalg.eigh(inertia)
    idx = np.argsort(evals)[::-1]
    evals = evals[idx]
    evecs = evecs[:, idx]
    if np.linalg.det(evecs) < 0:
        evecs[:, 2] *= -1
    t = np.trace(evecs)
    if t > 0:
        r = np.sqrt(1 + t)
        w = 0.5 * r
        x = (evecs[2, 1] - evecs[1, 2]) / (2 * r)
        y = (evecs[0, 2] - evecs[2, 0]) / (2 * r)
        z = (evecs[1, 0] - evecs[0, 1]) / (2 * r)
    else:
        i = np.argmax(np.diag(evecs))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1 + evecs[i, i] - evecs[j, j] - evecs[k, k])
        q_ = np.zeros(4)
        q_[i + 1] = 0.5 * r
        q_[0] = (evecs[k, j] - evecs[j, k]) / (2 * r)
        q_[j + 1] = (evecs[j, i] + evecs[i, j]) / (2 * r)
        q_[k + 1] = (evecs[k, i] + evecs[i, k]) / (2 * r)
        w, x, y, z = q_
    quat = np.array([w, x, y, z])
    quat /= np.linalg.norm(quat)
    return total_mass, com, quat, evals


# the 12 triangles of a box's 8 corners (the vertex cloud of a box geom
# without a hull: corner k has signs (x, y, z) from bits (4, 2, 1) of k)
_BOX_TRIS = (
    (0, 2, 6), (0, 6, 4),   # z = -1
    (1, 7, 3), (1, 5, 7),   # z = +1
    (0, 1, 5), (0, 5, 4),   # y = -1
    (2, 3, 7), (2, 7, 6),   # y = +1
    (0, 1, 3), (0, 3, 2),   # x = -1
    (4, 5, 7), (4, 7, 6),   # x = +1
)

_HULL_SPREAD_EPS = 1e-3  # m of depth preference per m of xy extremity


def _hull_quadrants(hull):
    """Vertex indices in 4 body-frame-xy quadrants around the centroid; an
    empty quadrant falls back to the full index set."""
    c = hull[:, :2].mean(axis=0)
    quads = [[], [], [], []]
    for k, v in enumerate(hull):
        quads[(0 if v[0] >= c[0] else 2) + (0 if v[1] >= c[1] else 1)].append(k)
    return tuple(tuple(q) if q else tuple(range(len(hull))) for q in quads)


def _hull_spread_bias(hull):
    """Per-vertex depth bias (~0.1 mm at this chassis scale) preferring
    xy-extreme vertices among near-tied depths."""
    c = hull[:, :2].mean(axis=0)
    r = np.linalg.norm(hull[:, :2] - c, axis=-1)
    return tuple(float(x) for x in (_HULL_SPREAD_EPS * r))


def _pad_hulls(hulls):
    """Vertex clouds padded to a common V with their centroid (strictly
    interior, so padding never becomes the deepest vertex)."""
    vmax = max(h.shape[0] for h in hulls)
    out = []
    for h in hulls:
        if h.shape[0] < vmax:
            pad = np.repeat(h.mean(axis=0, keepdims=True),
                            vmax - h.shape[0], axis=0)
            h = np.concatenate([h, pad], axis=0)
        out.append(h)
    return out


def make_model(spec: st.ModelSpec,
               scene: Optional[SceneSpec] = None,
               dtype=torch.float32,
               solver_iterations: int = 16,
               ls_iterations: int = 8,
               compat_flat_manifold: bool = False,
               compat_wheel_patch: bool = False,
               device=None) -> Model:
    """Compile a ModelSpec (+ static scene) into a Model on ``device``
    (``None`` = the CPU)."""
    device = torch.device("cpu" if device is None else device)
    scene = scene if scene is not None else open_floor_scene()
    order, fused = _fuse_welded(spec)

    body_names = ["world"] + order
    nbody = len(body_names)
    body_index = {n: i for i, n in enumerate(body_names)}
    body_parent = [0] + [body_index[fused[n]["parent"]] for n in order]

    body_pos = np.zeros((nbody, 3))
    body_quat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    body_mass = np.zeros(nbody)
    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    body_inertia = np.zeros((nbody, 3))

    jnt_type, jnt_body, jnt_axis, jnt_pos, jnt_range = [], [], [], [], []
    jnt_qposadr, jnt_dofadr, jnt_names = [], [], []
    jnt_solref_limit, jnt_solimp_limit = [], []
    limited_jnts = []
    dof_body, dof_jnt = [], []
    dof_damping, dof_armature, dof_frictionloss = [], [], []
    qpos0 = []
    site_body, site_pos, site_quat, site_names = [], [], [], []
    wheel_body, wheel_pos, wheel_axis, wheel_size = [], [], [], []
    wheel_friction, wheel_solref, wheel_solimp = [], [], []
    cbox_body, cbox_pos, cbox_quat, cbox_size = [], [], [], []
    cbox_hull, cbox_faces = [], []

    for name in order:
        i = body_index[name]
        b = fused[name]["body"]
        body_pos[i] = b.pos
        body_quat[i] = b.quat
        m, com, iq, diag = _combine_inertials(fused[name]["inertials"])
        body_mass[i] = m
        body_ipos[i] = com
        body_iquat[i] = iq
        body_inertia[i] = diag
        for j in b.joints:
            code = _JNT_CODE[j.type]
            jnt_names.append(j.name)
            jnt_type.append(code)
            jnt_body.append(i)
            jnt_axis.append(np.asarray(j.axis, dtype=np.float64))
            jnt_pos.append(np.asarray(j.pos, dtype=np.float64))
            jnt_qposadr.append(len(qpos0))
            jnt_dofadr.append(len(dof_body))
            jnt_range.append(j.range if j.range is not None else (0.0, 0.0))
            jnt_solref_limit.append(j.solref_limit)
            jnt_solimp_limit.append(j.solimp_limit)
            if j.range is not None:
                limited_jnts.append(len(jnt_names) - 1)
            ndof = 6 if code == JNT_FREE else 1
            if code == JNT_FREE:
                qpos0.extend(list(b.pos) + list(b.quat))
            else:
                qpos0.append(0.0)
            for _ in range(ndof):
                dof_body.append(i)
                dof_jnt.append(len(jnt_names) - 1)
                dof_damping.append(j.damping)
                dof_armature.append(j.armature)
                dof_frictionloss.append(j.frictionloss)
        for s_ in fused[name]["sites"]:
            site_body.append(i)
            site_pos.append(np.asarray(s_.pos))
            site_quat.append(np.asarray(s_.quat))
            site_names.append(s_.name)
        for g in fused[name]["geoms"]:
            if g.type == st.CYLINDER:
                # cylinder axis = local z rotated by the geom quat
                w, x, y, z = g.quat
                axis = np.array([2 * (x * z + w * y), 2 * (y * z - w * x),
                                 1 - 2 * (x * x + y * y)])
                wheel_body.append(i)
                wheel_pos.append(np.asarray(g.pos))
                wheel_axis.append(axis)
                wheel_size.append(np.asarray(g.size[:2]))
                wheel_friction.append(np.asarray(g.friction))
                wheel_solref.append(np.asarray(g.solref))
                wheel_solimp.append(np.asarray(g.solimp))
            elif g.type == st.BOX:
                cbox_body.append(i)
                cbox_pos.append(np.asarray(g.pos))
                cbox_quat.append(np.asarray(g.quat))
                cbox_size.append(np.asarray(g.size))
                if g.hull is not None:
                    cbox_hull.append(np.asarray(g.hull, dtype=np.float64))
                    cbox_faces.append(tuple(tuple(int(v) for v in f)
                                            for f in (g.hull_faces or ())))
                else:
                    cbox_faces.append(_BOX_TRIS)
                    # the box's 8 corners as the vertex cloud (body frame)
                    signs = np.array([[sx, sy, sz] for sx in (-1, 1)
                                      for sy in (-1, 1) for sz in (-1, 1)],
                                     dtype=np.float64)
                    cbox_hull.append(np.asarray(g.pos)
                                     + (signs * np.asarray(g.size))
                                     @ _rot(g.quat).T)

    nq, nv = len(qpos0), len(dof_body)
    njnt = len(jnt_names)
    cbox_hull_padded = _pad_hulls(cbox_hull) if cbox_hull else []

    plane_z = scene.floor_z
    # the floor is a finite 40x40 m plane for rays (MuJoCo ray_plane)
    plane_half_size = np.array([40.0, 40.0])
    plane_friction = np.asarray(scene.floor_friction)
    plane_solref = np.array([0.02, 1.0])
    plane_solimp = np.array([0.9, 0.95, 0.001, 0.5, 2.0])
    for g in spec.world_geoms:
        if g.type == st.PLANE:
            if len(g.size) >= 2:
                plane_half_size = np.asarray(g.size[:2], np.float64)
            plane_friction = np.asarray(g.friction)
            plane_solref = np.asarray(g.solref)
            plane_solimp = np.asarray(g.solimp)

    jnt_index = {n: i for i, n in enumerate(jnt_names)}
    act_dof, act_gain, act_bias, act_ctrl, act_force, act_names = (
        [], [], [], [], [], [])
    for a in spec.actuators:
        act_dof.append(jnt_dofadr[jnt_index[a.joint]])
        act_gain.append(a.gain)
        act_bias.append(np.asarray(a.bias))
        act_ctrl.append(np.asarray(a.ctrlrange if a.ctrlrange is not None
                                   else (-np.inf, np.inf)))
        act_force.append(np.asarray(a.forcerange if a.forcerange is not None
                                    else (-np.inf, np.inf)))
        act_names.append(a.name)

    eq_pairs, eq_poly, eq_solref, eq_solimp = [], [], [], []
    for e in spec.equalities:
        eq_pairs.append((jnt_dofadr[jnt_index[e.joint1]],
                         jnt_dofadr[jnt_index[e.joint2]]))
        poly5 = np.zeros(5)
        poly5[:min(len(e.polycoef), 5)] = np.asarray(e.polycoef[:5])
        eq_poly.append(poly5)
        eq_solref.append(np.asarray(e.solref))
        eq_solimp.append(np.asarray(e.solimp))

    friction_dofs = tuple(i for i in range(nv) if dof_frictionloss[i] > 0)
    limited_dofs = tuple(jnt_dofadr[j] for j in limited_jnts)

    site_index = {n: i for i, n in enumerate(site_names)}
    sensor_kinds, sensor_obj, sensor_names = [], [], []
    rf_cutoff = []
    for s in spec.sensors:
        sensor_kinds.append(s.type)
        sensor_names.append(s.name)
        if s.type == "jointpos":
            sensor_obj.append(jnt_qposadr[jnt_index[s.obj]])
        elif s.type == "jointvel":
            sensor_obj.append(jnt_dofadr[jnt_index[s.obj]])
        elif s.type == "rangefinder":
            sensor_obj.append(site_index[s.obj])
            rf_cutoff.append(s.cutoff)
        else:
            raise ValueError(f"unsupported sensor type {s.type}")

    def stack(xs, width):
        return np.stack(xs) if xs else np.zeros((0,) + width)

    arrays = dict(
        body_pos=body_pos, body_quat=body_quat, body_mass=body_mass,
        body_ipos=body_ipos, body_iquat=body_iquat,
        body_inertia=body_inertia, body_invweight0=np.zeros((nbody, 2)),
        jnt_axis=np.stack(jnt_axis), jnt_pos=np.stack(jnt_pos),
        jnt_range=np.stack(jnt_range),
        jnt_solref_limit=np.stack(jnt_solref_limit),
        jnt_solimp_limit=np.stack(jnt_solimp_limit),
        dof_damping=dof_damping, dof_armature=dof_armature,
        dof_frictionloss=dof_frictionloss, dof_invweight0=np.zeros(nv),
        qpos0=qpos0,
        site_pos=stack(site_pos, (3,)), site_quat=stack(site_quat, (4,)),
        actuator_gain=act_gain, actuator_bias=stack(act_bias, (3,)),
        actuator_ctrlrange=stack(act_ctrl, (2,)),
        actuator_forcerange=stack(act_force, (2,)),
        eq_polycoef=stack(eq_poly, (5,)), eq_solref=stack(eq_solref, (2,)),
        eq_solimp=stack(eq_solimp, (5,)),
        wheel_pos=stack(wheel_pos, (3,)), wheel_axis=stack(wheel_axis, (3,)),
        wheel_size=stack(wheel_size, (2,)),
        wheel_friction=stack(wheel_friction, (3,)),
        wheel_solref=stack(wheel_solref, (2,)),
        wheel_solimp=stack(wheel_solimp, (5,)),
        chassis_box_pos=stack(cbox_pos, (3,)),
        chassis_box_quat=stack(cbox_quat, (4,)),
        chassis_box_size=stack(cbox_size, (3,)),
        chassis_hull_verts=stack(cbox_hull_padded, (8, 3)),
        plane_z=plane_z, plane_half_size=plane_half_size,
        plane_friction=plane_friction, plane_solref=plane_solref,
        plane_solimp=plane_solimp,
        scene_box_pos=scene.box_pos.reshape(-1, 3),
        scene_box_size=scene.box_size.reshape(-1, 3),
        gravity=spec.option.gravity, timestep=spec.option.timestep,
        sensor_cutoff=rf_cutoff)
    statics = dict(
        nq=nq, nv=nv, nu=len(act_names), nbody=nbody, njnt=njnt,
        nsite=len(site_names),
        body_parent=tuple(body_parent), body_names=tuple(body_names),
        jnt_type=tuple(jnt_type), jnt_body=tuple(jnt_body),
        jnt_qposadr=tuple(jnt_qposadr), jnt_dofadr=tuple(jnt_dofadr),
        jnt_names=tuple(jnt_names),
        dof_body=tuple(dof_body), dof_jnt=tuple(dof_jnt),
        site_body=tuple(site_body), site_names=tuple(site_names),
        actuator_dof=tuple(act_dof), actuator_names=tuple(act_names),
        eq_dof_pairs=tuple(eq_pairs),
        limited_dofs=limited_dofs, friction_dofs=friction_dofs,
        sensor_kinds=tuple(sensor_kinds), sensor_obj=tuple(sensor_obj),
        sensor_names=tuple(sensor_names),
        wheel_body=tuple(wheel_body), chassis_box_body=tuple(cbox_body),
        chassis_hull_quadrants=tuple(_hull_quadrants(h)
                                     for h in cbox_hull_padded),
        chassis_hull_bias=tuple(_hull_spread_bias(h)
                                for h in cbox_hull_padded),
        chassis_hull_faces=tuple(cbox_faces),
        num_scene_boxes=int(scene.num_boxes),
        compat_flat_manifold=bool(compat_flat_manifold),
        compat_wheel_patch=bool(compat_wheel_patch),
        solver_iterations=solver_iterations, ls_iterations=ls_iterations)

    # invweight0 (MuJoCo's mj_setConst) from the dynamics at qpos0, in
    # float64 on the host; cast to the model dtype below
    from . import inertia
    host = Model(**statics, **{k: torch.as_tensor(np.asarray(v, np.float64))
                               for k, v in arrays.items()})
    body_iw, dof_iw = inertia.invweight0(host)
    arrays["body_invweight0"] = body_iw.numpy()
    arrays["dof_invweight0"] = dof_iw.numpy()
    return Model(**statics, **{
        k: torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                           device=device) for k, v in arrays.items()})
