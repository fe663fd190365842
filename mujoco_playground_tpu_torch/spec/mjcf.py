"""ModelSpec -> MJCF XML export (MuJoCo interop / parity testing).

A copy of the JAX package's ``spec/mjcf.py``: for the same spec and scene
the two write the same XML, byte for byte.  The spec layer is the source of
truth; MJCF is generated, never hand-edited.  Exported models compile in
MuJoCo to the same nq/nv/actuator/sensor layout as
:func:`mujoco_playground_tpu_torch.physics.model.make_model` produces, so
trajectory parity tests can run MuJoCo and the port on identical physics,
and the viewers (``envs/gym_wrapper.py``, ``main_sim.py``) draw the port's
state through MuJoCo.

Inertials are always written explicitly (``<inertial>``), so no mesh assets
are needed — the reference's STL chassis meshes are represented by their baked
compiled inertia plus AABB box collision proxies (see spec/robot.py).
"""
from __future__ import annotations

from typing import Optional
from xml.etree import ElementTree as ET

import numpy as np

from mujoco_playground_tpu_torch.spec import types as st
from mujoco_playground_tpu_torch.spec.scene import SceneSpec


def _fmt(vals) -> str:
    arr = np.atleast_1d(np.asarray(vals, dtype=np.float64))
    return " ".join(repr(float(v)) for v in arr)


def to_mjcf(spec: st.ModelSpec, scene: Optional[SceneSpec] = None) -> str:
    root = ET.Element("mujoco", model=spec.name)
    ET.SubElement(root, "compiler", angle="radian")
    ET.SubElement(root, "option", timestep=_fmt(spec.option.timestep),
                  gravity=_fmt(spec.option.gravity))
    world = ET.SubElement(root, "worldbody")

    # The scene's floor height wins over the spec's plane (the spec models the
    # open-floor arena; maze scenes drop the ground to floor_z=-0.5, matching
    # the reference's XML surgery, maze_env.py:320-335).
    spec_plane = next((g for g in spec.world_geoms if g.type == st.PLANE), None)
    for g in spec.world_geoms:
        if g.type == st.PLANE and scene is not None:
            continue
        _geom_elem(world, g)
    if scene is not None:
        friction = (spec_plane.friction if spec_plane is not None
                    else scene.floor_friction)
        ET.SubElement(world, "geom", name="floor", type="plane",
                      size="40 40 0.1", pos=_fmt([0, 0, scene.floor_z]),
                      friction=_fmt(friction), contype="1", conaffinity="7")
        for k in range(scene.num_boxes):
            ET.SubElement(world, "geom", name=f"obstacle_{k}", type="box",
                          size=_fmt(scene.box_size[k]),
                          pos=_fmt(scene.box_pos[k]))

    body_elems = {"world": world}
    for b in spec.bodies:
        parent = body_elems[b.parent]
        e = ET.SubElement(parent, "body", name=b.name, pos=_fmt(b.pos),
                          quat=_fmt(b.quat))
        body_elems[b.name] = e
        if b.inertial is not None:
            ET.SubElement(e, "inertial", mass=_fmt(b.inertial.mass),
                          pos=_fmt(b.inertial.pos), quat=_fmt(b.inertial.quat),
                          diaginertia=_fmt(b.inertial.diaginertia))
        for j in b.joints:
            if j.type == st.FREE:
                ET.SubElement(e, "freejoint", name=j.name)
            else:
                kw = dict(name=j.name, type=j.type, pos=_fmt(j.pos),
                          axis=_fmt(j.axis), damping=_fmt(j.damping),
                          armature=_fmt(j.armature),
                          frictionloss=_fmt(j.frictionloss))
                if j.range is not None:
                    kw["range"] = _fmt(j.range)
                    kw["limited"] = "true"
                ET.SubElement(e, "joint", **kw)
        for g in b.geoms:
            _geom_elem(e, g)
        for s_ in b.sites:
            ET.SubElement(e, "site", name=s_.name, pos=_fmt(s_.pos),
                          quat=_fmt(s_.quat), size=_fmt(s_.size),
                          type="sphere", rgba="0 0 0 0")

    if spec.equalities:
        eq = ET.SubElement(root, "equality")
        for c in spec.equalities:
            ET.SubElement(eq, "joint", name=c.name, joint1=c.joint1,
                          joint2=c.joint2, polycoef=_fmt(c.polycoef),
                          solref=_fmt(c.solref), solimp=_fmt(c.solimp))

    if spec.actuators:
        act = ET.SubElement(root, "actuator")
        for a in spec.actuators:
            kw = dict(name=a.name, joint=a.joint, gaintype="fixed",
                      gainprm=_fmt([a.gain, 0, 0]), biastype="affine",
                      biasprm=_fmt(a.bias))
            if a.ctrlrange is not None:
                kw["ctrlrange"] = _fmt(a.ctrlrange)
                kw["ctrllimited"] = "true"
            if a.forcerange is not None:
                kw["forcerange"] = _fmt(a.forcerange)
            ET.SubElement(act, "general", **kw)

    if spec.sensors:
        sens = ET.SubElement(root, "sensor")
        for s_ in spec.sensors:
            if s_.type == "jointpos":
                ET.SubElement(sens, "jointpos", name=s_.name, joint=s_.obj)
            elif s_.type == "jointvel":
                ET.SubElement(sens, "jointvel", name=s_.name, joint=s_.obj)
            elif s_.type == "rangefinder":
                ET.SubElement(sens, "rangefinder", name=s_.name, site=s_.obj,
                              cutoff=_fmt(s_.cutoff))

    ET.indent(root)
    return ET.tostring(root, encoding="unicode")


def _geom_elem(parent, g: st.GeomSpec):
    kw = dict(name=g.name, type=g.type, pos=_fmt(g.pos), quat=_fmt(g.quat),
              friction=_fmt(g.friction), contype=str(g.contype),
              conaffinity=str(g.conaffinity), condim=str(g.condim),
              solref=_fmt(g.solref), solimp=_fmt(g.solimp),
              rgba=_fmt(g.rgba), group=str(g.group))
    if g.size:
        kw["size"] = _fmt(g.size)
    if g.mass is not None:
        kw["mass"] = _fmt(g.mass)
    ET.SubElement(parent, "geom", **kw)
