"""MJCF -> ModelSpec importer (subset): the port of the JAX package's
``spec/mjcf_import.py``.

Inverse of :mod:`mujoco_playground_tpu_torch.spec.mjcf`: brings existing
MJCF robots into the engine without a hand-written spec.  Supported subset
(the reference models' feature set): nested bodies, free/hinge/slide
joints, plane/sphere/cylinder/box geoms, **mesh geoms with STL assets**
(mass properties through ``spec/mesh.py``, which follows MuJoCo's compiler
for all four mesh-inertia modes; collision through the convex-hull vertex
cloud the narrowphase consumes, so MJCF+STL robots import end to end),
sites, <replicate> expansion, explicit inertials, position/velocity/motor/
general actuators, jointpos/jointvel/rangefinder sensors, joint-coupling
equalities, compiler angle modes and meshdir, and option timestep/gravity.
Mesh geoms whose asset file cannot be found are skipped with a warning
(supply explicit <inertial>).

A body without an <inertial> whose geoms carry mass gets the rigid
combination of all of them, mesh parts and primitives alike, as MuJoCo's
compiler does; the JAX importer builds such a body's inertial from its
mesh geoms alone, so ``make_model`` drops the primitives' masses there.
Primitive geoms without a ``mass`` carry none (as ``make_model`` reads
them), where MuJoCo gives them its default density.

Parsing is self-contained (ElementTree + numpy + scipy qhull); the tests
hold the imported spec against MuJoCo 3.10's compiler and the JAX
importer.
"""
from __future__ import annotations

import math
import os
import warnings
from typing import List, Optional, Tuple
from xml.etree import ElementTree as ET

import numpy as np

from mujoco_playground_tpu_torch.physics.model import _geom_inertial
from mujoco_playground_tpu_torch.spec import mesh as mesh_lib
from mujoco_playground_tpu_torch.spec import types as st
from mujoco_playground_tpu_torch.spec.types import (quat_from_axis_angle,
                                                    quat_mul_np)


def _qmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _floats(s, default=None):
    if s is None:
        return default
    return tuple(float(x) for x in s.split())


def _quat_from_elem(elem, angle_scale: float):
    """Resolve orientation attrs (quat / euler / axisangle / zaxis)."""
    if elem.get("quat") is not None:
        q = _floats(elem.get("quat"))
        n = math.sqrt(sum(x * x for x in q))
        return tuple(x / n for x in q)
    if elem.get("euler") is not None:
        e = [x * angle_scale for x in _floats(elem.get("euler"))]
        # MuJoCo default eulerseq "xyz", intrinsic (rotating axes):
        # q = qx * qy * qz
        q = (1.0, 0.0, 0.0, 0.0)
        for axis, ang in zip(((1, 0, 0), (0, 1, 0), (0, 0, 1)), e):
            q = quat_mul_np(q, quat_from_axis_angle(axis, ang))
        return q
    if elem.get("axisangle") is not None:
        a = _floats(elem.get("axisangle"))
        return quat_from_axis_angle(a[:3], a[3] * angle_scale)
    if elem.get("zaxis") is not None:
        z = np.asarray(_floats(elem.get("zaxis")), dtype=np.float64)
        z = z / np.linalg.norm(z)
        # minimal rotation taking (0,0,1) to z (MuJoCo zaxis semantics)
        zhat = np.array([0.0, 0.0, 1.0])
        c = float(np.dot(zhat, z))
        if c > 1 - 1e-12:
            return (1.0, 0.0, 0.0, 0.0)
        if c < -1 + 1e-12:
            return (0.0, 1.0, 0.0, 0.0)
        axis = np.cross(zhat, z)
        axis = axis / np.linalg.norm(axis)
        return quat_from_axis_angle(axis, math.acos(c))
    return (1.0, 0.0, 0.0, 0.0)


def _combine_inertials(parts: List[st.InertialSpec]) -> st.InertialSpec:
    """Rigid composition of per-geom inertials into one body inertial
    (MuJoCo's compiler does this when a body has geom masses and no
    explicit <inertial>): total mass, mass-weighted CoM, parallel-axis
    inertia sum, principal re-decomposition."""
    if len(parts) == 1:
        return parts[0]
    M = sum(p.mass for p in parts)
    com = sum(np.asarray(p.pos) * p.mass for p in parts) / M
    I = np.zeros((3, 3))
    for p in parts:
        R = _qmat(p.quat)
        Ii = R @ np.diag(p.diaginertia) @ R.T
        d = np.asarray(p.pos) - com
        I += Ii + p.mass * ((d @ d) * np.eye(3) - np.outer(d, d))
    diag, q = mesh_lib.principal_frame(I)
    return st.InertialSpec(mass=M, pos=tuple(com), quat=tuple(q),
                           diaginertia=tuple(diag))


def from_mjcf(xml: str, name: Optional[str] = None,
              base_dir: Optional[str] = None) -> st.ModelSpec:
    """Parse an MJCF string into a ModelSpec (see module docstring).

    ``base_dir``: directory mesh asset paths are resolved against
    (``from_mjcf_file`` passes the XML's own directory, matching MuJoCo);
    ``<compiler meshdir>`` composes on top.
    """
    root = ET.fromstring(xml)
    compiler = root.find("compiler")
    angle_mode = (compiler.get("angle", "degree") if compiler is not None
                  else "degree")
    ang = math.pi / 180.0 if angle_mode == "degree" else 1.0
    meshdir = compiler.get("meshdir") if compiler is not None else None

    # <asset><mesh name file scale inertia>: resolved lazily, cached
    mesh_assets = {}
    for asset in root.findall("asset"):
        for mel in asset.findall("mesh"):
            fname = mel.get("file", "")
            mname = mel.get("name") or os.path.splitext(
                os.path.basename(fname))[0]
            mesh_assets[mname] = dict(
                file=fname,
                scale=_floats(mel.get("scale"), (1.0, 1.0, 1.0)),
                inertia=mel.get("inertia", "legacy"))

    def resolve_mesh_path(fname):
        if os.path.isabs(fname):
            return fname if os.path.exists(fname) else None
        roots = []
        if meshdir is not None:
            if os.path.isabs(meshdir):
                roots.append(meshdir)
            elif base_dir is not None:
                roots.append(os.path.join(base_dir, meshdir))
            else:
                roots.append(meshdir)
        if base_dir is not None:
            roots.append(base_dir)
        roots.append(os.getcwd())
        for r in roots:
            p = os.path.normpath(os.path.join(r, fname))
            if os.path.exists(p):
                return p
        return None

    option = st.OptionSpec()
    opt_elem = root.find("option")
    if opt_elem is not None:
        if opt_elem.get("timestep"):
            option.timestep = float(opt_elem.get("timestep"))
        if opt_elem.get("gravity"):
            option.gravity = _floats(opt_elem.get("gravity"))

    spec = st.ModelSpec(name=name or root.get("model", "imported"),
                        option=option)

    # defaults (flat subset: geom defaults only)
    default_geom = {}
    default_elem = root.find("default")
    if default_elem is not None:
        g = default_elem.find("geom")
        if g is not None:
            default_geom = dict(g.attrib)

    def parse_mesh_geom(g, attrs):
        """Mesh geom -> (box-proxy GeomSpec with hull cloud, InertialSpec),
        both in the parent BODY frame — the exact structure the hand-spec
        bakes for the reference chassis (spec/robot.py _mesh_proxy_geom).
        Returns (None, None) when the asset cannot be resolved."""
        asset = mesh_assets.get(attrs.get("mesh", ""))
        path = resolve_mesh_path(asset["file"]) if asset else None
        if path is None:
            warnings.warn(
                "mesh geom skipped on import (asset file not found); "
                "provide an explicit <inertial> and primitive collision "
                "proxies (see spec/robot.py)")
            return None, None
        tris = mesh_lib.load_stl(path)
        scale = np.asarray(asset["scale"], np.float64)
        if np.any(scale != 1.0):
            tris = tris * scale
            if np.prod(np.sign(scale)) < 0:
                tris = tris[:, ::-1]       # mirror flips orientation
        mass = attrs.get("mass")
        m, com, I = mesh_lib.mesh_mass_properties(
            tris, mass=float(mass) if mass is not None else None,
            density=float(attrs.get("density", 1000.0)),
            mode=asset["inertia"])
        diag, q_p = mesh_lib.principal_frame(I)
        gpos = np.asarray(_floats(attrs.get("pos"), (0.0, 0.0, 0.0)))
        gquat = _quat_from_elem(g, ang)
        Rg = _qmat(gquat)
        ipos = tuple(gpos + Rg @ com)
        iquat = tuple(quat_mul_np(gquat, tuple(q_p)))
        inertial = st.InertialSpec(mass=m, pos=ipos, quat=iquat,
                                   diaginertia=tuple(diag))
        # convex hull: body-frame cloud for the narrowphase + faces for the
        # compat manifold (qhull triangulation — MuJoCo's own mesh graph
        # may order faces differently; vertex sets agree)
        hull_mesh, faces = mesh_lib.convex_hull(tris.reshape(-1, 3))
        hull_body = gpos[None, :] + hull_mesh @ Rg.T
        # proxy box = mesh AABB in the inertial (principal) frame
        Rp = _qmat(tuple(q_p))
        v_in = (hull_mesh - com) @ Rp
        center = (v_in.min(0) + v_in.max(0)) / 2.0
        half = (v_in.max(0) - v_in.min(0)) / 2.0
        Ri = _qmat(iquat)
        proxy_pos = tuple(np.asarray(ipos) + Ri @ center)
        geom = st.GeomSpec(
            name=attrs.get("name", ""), type="box", size=tuple(half),
            pos=proxy_pos, quat=iquat, mass=None,
            friction=_floats(attrs.get("friction"), (1.0, 0.005, 0.0001)),
            contype=int(attrs.get("contype", 1)),
            conaffinity=int(attrs.get("conaffinity", 1)),
            condim=int(attrs.get("condim", 3)),
            solref=_floats(attrs.get("solref"), (0.02, 1.0)),
            solimp=_floats(attrs.get("solimp"),
                           (0.9, 0.95, 0.001, 0.5, 2.0)),
            rgba=_floats(attrs.get("rgba"), (0.5, 0.5, 0.5, 1.0)),
            group=int(attrs.get("group", 0)),
            hull=tuple(map(tuple, hull_body)),
            hull_faces=tuple(map(tuple, faces.tolist())))
        return geom, inertial

    def parse_geom(g) -> Optional[st.GeomSpec]:
        gs, _ = parse_geom_inertial(g)
        return gs

    def parse_geom_inertial(g):
        """(GeomSpec, InertialSpec of a mesh geom or None) in the body
        frame."""
        attrs = {**default_geom, **g.attrib}
        gtype = attrs.get("type", "sphere")
        if gtype == "mesh":
            return parse_mesh_geom(g, attrs)
        mass = attrs.get("mass")
        return st.GeomSpec(
            name=attrs.get("name", ""), type=gtype,
            size=_floats(attrs.get("size"), ()) or (),
            pos=_floats(attrs.get("pos"), (0.0, 0.0, 0.0)),
            quat=_quat_from_elem(g, ang),
            mass=float(mass) if mass is not None else None,
            friction=_floats(attrs.get("friction"), (1.0, 0.005, 0.0001)),
            contype=int(attrs.get("contype", 1)),
            conaffinity=int(attrs.get("conaffinity", 1)),
            condim=int(attrs.get("condim", 3)),
            solref=_floats(attrs.get("solref"), (0.02, 1.0)),
            solimp=_floats(attrs.get("solimp"),
                           (0.9, 0.95, 0.001, 0.5, 2.0)),
            rgba=_floats(attrs.get("rgba"), (0.5, 0.5, 0.5, 1.0)),
            group=int(attrs.get("group", 0))), None

    def parse_joint(j) -> st.JointSpec:
        jtype = j.get("type", "hinge")
        rng = _floats(j.get("range"))
        if rng is not None and jtype in ("hinge", "ball"):
            rng = tuple(x * ang for x in rng)
        return st.JointSpec(
            name=j.get("name", ""), type=jtype,
            pos=_floats(j.get("pos"), (0.0, 0.0, 0.0)),
            axis=_floats(j.get("axis"), (0.0, 0.0, 1.0)),
            range=rng,
            damping=float(j.get("damping", 0.0)),
            armature=float(j.get("armature", 0.0)),
            frictionloss=float(j.get("frictionloss", 0.0)),
            stiffness=float(j.get("stiffness", 0.0)))

    def expand_replicate(parent_elems, elem):
        """Expand <replicate count= sep= euler=/offset=> children."""
        count = int(elem.get("count", 1))
        sep = elem.get("sep", "")
        euler = [x * ang for x in _floats(elem.get("offset_euler") or
                                          elem.get("euler"),
                                          (0.0, 0.0, 0.0))]
        offset = _floats(elem.get("offset"), (0.0, 0.0, 0.0))
        width = len(str(count - 1))
        out = []
        for i in range(count):
            # cumulative rotation i times about z etc.
            q = (1.0, 0.0, 0.0, 0.0)
            for _ in range(i):
                for axis, a_ in zip(((1, 0, 0), (0, 1, 0), (0, 0, 1)), euler):
                    if a_:
                        q = quat_mul_np(q, quat_from_axis_angle(axis, a_))
            for child in elem:
                c = ET.fromstring(ET.tostring(child))
                base = c.get("name", "")
                c.set("name", f"{base}{sep}{i:0{width}d}")
                p = np.asarray(_floats(c.get("pos"), (0.0, 0.0, 0.0)))
                p = p + i * np.asarray(offset)
                # rotate pos/orientation by q
                w, x, y, z = q
                R = np.array([
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]])
                p = R @ p
                c.set("pos", " ".join(repr(float(v)) for v in p))
                cq = quat_mul_np(q, _quat_from_elem(c, ang))
                for k in ("euler", "axisangle", "zaxis"):
                    if k in c.attrib:
                        del c.attrib[k]
                c.set("quat", " ".join(repr(float(v)) for v in cq))
                out.append(c)
        return out

    def walk_body(elem, parent_name: str):
        bname = elem.get("name", f"body_{len(spec.bodies)}")
        body = st.BodySpec(
            name=bname, parent=parent_name,
            pos=_floats(elem.get("pos"), (0.0, 0.0, 0.0)),
            quat=_quat_from_elem(elem, ang))
        inertial = elem.find("inertial")
        if inertial is not None:
            diag = _floats(inertial.get("diaginertia"), (0.0, 0.0, 0.0))
            body.inertial = st.InertialSpec(
                mass=float(inertial.get("mass", 0.0)),
                pos=_floats(inertial.get("pos"), (0.0, 0.0, 0.0)),
                quat=_quat_from_elem(inertial, ang),
                diaginertia=diag)
        # the inertial of each geom that carries mass, in document order;
        # whether any of them is a mesh's
        geom_inertials, has_mesh = [], False
        for child in list(elem):
            tag = child.tag
            if tag in ("joint",):
                body.joints.append(parse_joint(child))
            elif tag == "freejoint":
                body.joints.append(st.JointSpec(
                    name=child.get("name", f"{bname}_free"), type="free"))
            elif tag == "geom":
                g, gin = parse_geom_inertial(child)
                if g is not None:
                    body.geoms.append(g)
                if gin is not None:
                    geom_inertials.append(gin)
                    has_mesh = True
                elif g is not None:
                    prim = _geom_inertial(g)
                    if prim is not None:
                        m, p, q, d = prim
                        geom_inertials.append(st.InertialSpec(
                            mass=m, pos=tuple(p), quat=tuple(q),
                            diaginertia=tuple(d)))
            elif tag == "site":
                body.sites.append(st.SiteSpec(
                    name=child.get("name", ""),
                    pos=_floats(child.get("pos"), (0.0, 0.0, 0.0)),
                    quat=_quat_from_elem(child, ang),
                    size=(_floats(child.get("size"), (0.003,)) or (0.003,))[0]))
            elif tag == "replicate":
                for c in expand_replicate(elem, child):
                    if c.tag == "site":
                        body.sites.append(st.SiteSpec(
                            name=c.get("name", ""),
                            pos=_floats(c.get("pos"), (0.0, 0.0, 0.0)),
                            quat=_quat_from_elem(c, 1.0),
                            size=(_floats(c.get("size"), (0.003,))
                                  or (0.003,))[0]))
        # a body without mesh geoms keeps no inertial: make_model combines
        # its primitives' as this would
        if body.inertial is None and has_mesh:
            body.inertial = _combine_inertials(geom_inertials)
        spec.bodies.append(body)
        for child in elem.findall("body"):
            walk_body(child, bname)

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF has no <worldbody>")
    for g in worldbody.findall("geom"):
        gs = parse_geom(g)
        if gs is not None:
            spec.world_geoms.append(gs)
    for b in worldbody.findall("body"):
        walk_body(b, "world")

    act_root = root.find("actuator")
    if act_root is not None:
        for a in act_root:
            name = a.get("name", "")
            joint = a.get("joint", "")
            ctrlrange = _floats(a.get("ctrlrange"))
            forcerange = _floats(a.get("forcerange"))
            if a.tag == "position":
                spec.actuators.append(st.ActuatorSpec.position(
                    name, joint, kp=float(a.get("kp", 1.0)),
                    kv=float(a.get("kv", 0.0)), ctrlrange=ctrlrange,
                    forcerange=forcerange))
            elif a.tag == "velocity":
                spec.actuators.append(st.ActuatorSpec.velocity(
                    name, joint, kv=float(a.get("kv", 1.0)),
                    ctrlrange=ctrlrange, forcerange=forcerange))
            elif a.tag == "motor":
                spec.actuators.append(st.ActuatorSpec.motor(
                    name, joint, gear=float((_floats(a.get("gear"))
                                             or (1.0,))[0]),
                    ctrlrange=ctrlrange, forcerange=forcerange))
            elif a.tag == "general":
                gain = (_floats(a.get("gainprm")) or (1.0,))[0]
                bias = _floats(a.get("biasprm"), (0.0, 0.0, 0.0))[:3]
                spec.actuators.append(st.ActuatorSpec(
                    name, joint, gain=gain, bias=tuple(bias),
                    ctrlrange=ctrlrange, forcerange=forcerange))

    sens_root = root.find("sensor")
    if sens_root is not None:
        for s_ in sens_root:
            if s_.tag in ("jointpos", "jointvel"):
                spec.sensors.append(st.SensorSpec(
                    s_.get("name", ""), s_.tag, s_.get("joint", "")))
            elif s_.tag == "rangefinder":
                site = s_.get("site", "")
                cutoff = float(s_.get("cutoff", 0.0))
                # a rangefinder on a replicated site expands to one sensor
                # per generated site (MuJoCo behavior for <replicate>)
                matches = [st_.name for b in spec.bodies for st_ in b.sites
                           if st_.name == site
                           or st_.name.startswith(site + "-")]
                base = s_.get("name", site)
                if len(matches) <= 1:
                    spec.sensors.append(st.SensorSpec(
                        base, "rangefinder", matches[0] if matches else site,
                        cutoff=cutoff))
                else:
                    width = len(str(len(matches) - 1))
                    for i, m in enumerate(sorted(matches)):
                        spec.sensors.append(st.SensorSpec(
                            f"{base}-{i:0{width}d}", "rangefinder", m,
                            cutoff=cutoff))

    eq_root = root.find("equality")
    if eq_root is not None:
        for e in eq_root.findall("joint"):
            # pad to the 5 coefficients the constraint assembly indexes
            # (MJCF allows fewer; a short tuple would make jnp's clamped
            # OOB gather silently repeat the last coefficient)
            poly = _floats(e.get("polycoef"), (0.0, 1.0, 0.0, 0.0, 0.0))
            poly = tuple(poly) + (0.0,) * (5 - len(poly))
            spec.equalities.append(st.EqualitySpec(
                name=e.get("name", ""), joint1=e.get("joint1", ""),
                joint2=e.get("joint2", ""),
                polycoef=poly[:5],
                solref=_floats(e.get("solref"), (0.02, 1.0)),
                solimp=_floats(e.get("solimp"),
                               (0.9, 0.95, 0.001, 0.5, 2.0))))
    return spec


def from_mjcf_file(path: str, name: Optional[str] = None) -> st.ModelSpec:
    """``from_mjcf`` of a file, mesh assets resolved against its
    directory."""
    with open(path) as f:
        return from_mjcf(f.read(), name=name,
                         base_dir=os.path.dirname(os.path.abspath(path)))
