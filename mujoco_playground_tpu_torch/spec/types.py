"""Model specification layer (numpy-only copy of the JAX package's spec).

The reference authors its robot as MJCF XML (``models/ackermann_robot_v2.xml``)
and compiles it with MuJoCo's C model compiler at every env reset.  Here the
model is a plain-Python spec, compiled once into a static model of tensors
(:func:`mujoco_playground_tpu_torch.physics.model.make_model`) at build time.

Conventions follow MuJoCo so that trajectories can be compared 1:1:

* quaternions are ``[w, x, y, z]``,
* free-joint qvel is ``[v_world(3), omega_body(3)]``,
* angles are radians in the spec (degrees only appear in MJCF export).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Joint types (subset of MuJoCo's mjtJoint we support).
FREE = "free"
HINGE = "hinge"
SLIDE = "slide"

# Geom types we support.
PLANE = "plane"
SPHERE = "sphere"
CAPSULE = "capsule"
CYLINDER = "cylinder"
BOX = "box"


@dataclasses.dataclass
class JointSpec:
    name: str
    type: str = HINGE
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    range: Optional[Tuple[float, float]] = None  # radians; None = unlimited
    damping: float = 0.0
    armature: float = 0.0
    frictionloss: float = 0.0
    stiffness: float = 0.0
    # Constraint softness for limits (MuJoCo defaults).
    solref_limit: Tuple[float, float] = (0.02, 1.0)
    solimp_limit: Tuple[float, ...] = (0.9, 0.95, 0.001, 0.5, 2.0)


@dataclasses.dataclass
class GeomSpec:
    name: str
    type: str
    size: Tuple[float, ...] = ()
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    # None mass => geom carries no inertia (inertia given explicitly on body).
    mass: Optional[float] = None
    friction: Tuple[float, float, float] = (1.0, 0.005, 0.0001)
    contype: int = 1
    conaffinity: int = 1
    condim: int = 3
    solref: Tuple[float, float] = (0.02, 1.0)
    solimp: Tuple[float, ...] = (0.9, 0.95, 0.001, 0.5, 2.0)
    margin: float = 0.0
    rgba: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 1.0)
    group: int = 0
    # Convex-hull vertex cloud in the BODY frame for mesh-proxy geoms (the
    # narrowphase collides these vertices; pos/quat/size still describe the
    # box used for MJCF export and raycast OBB tests).  None => derive the
    # cloud from the box's 8 corners.
    hull: Optional[Tuple[Tuple[float, float, float], ...]] = None
    # Hull triangles (index triples into ``hull``) in MuJoCo's mesh-graph
    # face order, for the ``compat_flat_manifold`` support-face manifold.
    hull_faces: Optional[Tuple[Tuple[int, int, int], ...]] = None


@dataclasses.dataclass
class SiteSpec:
    name: str
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    size: float = 0.003


@dataclasses.dataclass
class InertialSpec:
    mass: float
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    diaginertia: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class BodySpec:
    name: str
    parent: str  # parent body name; "world" for root bodies
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    joints: List[JointSpec] = dataclasses.field(default_factory=list)
    geoms: List[GeomSpec] = dataclasses.field(default_factory=list)
    sites: List[SiteSpec] = dataclasses.field(default_factory=list)
    inertial: Optional[InertialSpec] = None


@dataclasses.dataclass
class ActuatorSpec:
    """Affine gain/bias actuator (covers MuJoCo <position>/<velocity>/<motor>).

    force = gain * ctrl + bias0 + bias1 * q + bias2 * qdot, clamped to
    forcerange; matches MuJoCo's compiled gainprm/biasprm representation
    (reference models/ackermann_robot_v2.xml:111-121 compiles to
    gainprm=[kp], biasprm=[0,-kp,-kv] for <position>, gainprm=[kv],
    biasprm=[0,0,-kv] for <velocity>).
    """

    name: str
    joint: str
    gain: float = 1.0
    bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ctrlrange: Optional[Tuple[float, float]] = None
    forcerange: Optional[Tuple[float, float]] = None

    @classmethod
    def position(cls, name, joint, kp, kv=0.0, ctrlrange=None, forcerange=None):
        return cls(name, joint, gain=kp, bias=(0.0, -kp, -kv),
                   ctrlrange=ctrlrange, forcerange=forcerange)

    @classmethod
    def velocity(cls, name, joint, kv, ctrlrange=None, forcerange=None):
        return cls(name, joint, gain=kv, bias=(0.0, 0.0, -kv),
                   ctrlrange=ctrlrange, forcerange=forcerange)

    @classmethod
    def motor(cls, name, joint, gear=1.0, ctrlrange=None, forcerange=None):
        return cls(name, joint, gain=gear, bias=(0.0, 0.0, 0.0),
                   ctrlrange=ctrlrange, forcerange=forcerange)


@dataclasses.dataclass
class SensorSpec:
    """Sensors: jointpos / jointvel / rangefinder (the reference's set,
    models/ackermann_robot_v2.xml:92-104)."""

    name: str
    type: str  # "jointpos" | "jointvel" | "rangefinder"
    obj: str  # joint name or site name
    cutoff: float = 0.0


@dataclasses.dataclass
class EqualitySpec:
    """Joint-coupling equality q1 = poly(q2) (reference uses polycoef="0 1",
    models/ackermann_robot_v2.xml:106-109)."""

    name: str
    joint1: str
    joint2: str
    polycoef: Tuple[float, ...] = (0.0, 1.0, 0.0, 0.0, 0.0)
    solref: Tuple[float, float] = (0.02, 1.0)
    solimp: Tuple[float, ...] = (0.9, 0.95, 0.001, 0.5, 2.0)


@dataclasses.dataclass
class OptionSpec:
    timestep: float = 0.002
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    # Constraint-solver controls (MuJoCo defaults; we run fixed iterations).
    solver_iterations: int = 100
    solver_tolerance: float = 1e-8
    impratio: float = 1.0


@dataclasses.dataclass
class ModelSpec:
    name: str
    bodies: List[BodySpec] = dataclasses.field(default_factory=list)
    world_geoms: List[GeomSpec] = dataclasses.field(default_factory=list)
    actuators: List[ActuatorSpec] = dataclasses.field(default_factory=list)
    sensors: List[SensorSpec] = dataclasses.field(default_factory=list)
    equalities: List[EqualitySpec] = dataclasses.field(default_factory=list)
    option: OptionSpec = dataclasses.field(default_factory=OptionSpec)

    def body(self, name: str) -> BodySpec:
        for b in self.bodies:
            if b.name == name:
                return b
        raise KeyError(name)


def quat_from_axis_angle(axis: Sequence[float], angle: float) -> Tuple[float, ...]:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return (float(np.cos(angle / 2.0)), *(float(a * s) for a in axis))


def quat_mul_np(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )
