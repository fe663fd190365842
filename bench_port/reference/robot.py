"""Ackermann robot model spec (numpy-only copy of the JAX package's spec).

Physical parameters transcribed from the reference MJCF
(``models/ackermann_robot_v2.xml`` of the reference project): chassis freejoint (l.25-26),
4 wheel cylinders r=0.0325 half-width 0.01 (l.39-80), steering hinges ±35 deg
(l.58,71), 72-beam lidar ``<replicate count="72" sep="-" euler="0 0 5">``
(l.83-86), sensors (l.92-104), steering-coupling equality (l.106-109), and the
position/velocity actuators (l.111-121).

The reference's chassis is two STL meshes (Base/Ceiling, mass 5 each) whose
inertias MuJoCo derives from the mesh geometry at compile time.  We bake the
*compiled* inertial constants here (extracted once from
``mujoco.MjModel.from_xml_path`` on the reference XML) so the smooth dynamics
match bit-for-bit without shipping mesh assets; the meshes' collision role is
approximated by their exact AABB box proxies (the chassis essentially never
contacts anything — the wheels carry all ground contact).
"""
from __future__ import annotations

import math

import numpy as np

from .spec_types import (
    ActuatorSpec,
    BodySpec,
    EqualitySpec,
    GeomSpec,
    InertialSpec,
    JointSpec,
    ModelSpec,
    OptionSpec,
    SensorSpec,
    SiteSpec,
    quat_from_axis_angle,
    quat_mul_np,
)

# ---------------------------------------------------------------------------
# Baked compiled constants (from MuJoCo's compilation of the reference XML).
# ---------------------------------------------------------------------------
# Base.stl mesh, mass 5: inertial frame + principal moments.
_BASE_INERTIAL = InertialSpec(
    mass=5.0,
    pos=(-0.00107417178473859, -0.00019042341875348, -0.0279999999050051),
    quat=(7.0710678020262008e-01, 3.7302603201889604e-05,
          -7.0710678020262008e-01, 3.7302603202005180e-05),
    diaginertia=(0.03705411530740222, 0.02900182907355553, 0.00806383436330927),
)
# Ceiling.stl mesh, mass 5.
_CEILING_INERTIAL = InertialSpec(
    mass=5.0,
    pos=(-0.0055293805036892, 0.00133056381673774, -0.0079999999050051),
    quat=(0.7071046262617281, 0.00174571454210018,
          -0.7071046262617282, 0.00174571454210026),
    diaginertia=(0.03556324584308559, 0.02797834211227548, 0.00759601207885357),
)
# Mesh AABBs in the mesh (inertial) frame: (center(3), half-size(3)).
_BASE_AABB = ((0.0, 0.000195, -0.013572), (0.002, 0.075009, 0.137506))
_CEILING_AABB = ((-0.0, -0.001156, -0.017919), (0.002, 0.075415, 0.137765))

# Convex-hull vertices of each chassis mesh, expressed in the CHASSIS BODY
# frame (geom_pos + R(geom_quat) @ mesh_vert over the hull vertices of
# MuJoCo's compiled mesh — exactly the vertex set MuJoCo's convex collider
# uses for these geoms).  Baked like the inertials: extracted once from
# ``mujoco.MjModel.from_xml_path`` on the reference XML
# (models/ackermann_robot_v2.xml:29,34) so collision geometry matches the
# reference meshes without shipping the STL assets.  Both plates are 4 mm
# thick with chamfered front corners (36 hull vertices each).
_BASE_HULL = (
    (0.10092214, 0.07373521, -0.03000000),
    (0.10092214, 0.07373521, -0.02600000),
    (0.10255926, 0.07295260, -0.03000000),
    (0.10255926, 0.07295260, -0.02600000),
    (0.14849879, 0.03620098, -0.03000000),
    (0.14930727, 0.03532738, -0.03000000),
    (0.14982289, 0.03425456, -0.03000000),
    (0.15000001, 0.03307750, -0.03000000),
    (0.15000001, -0.03307750, -0.03000000),
    (0.14849878, -0.03620098, -0.03000000),
    (0.10255926, -0.07295260, -0.03000000),
    (0.14982289, -0.03425455, -0.03000000),
    (0.14930727, -0.03532738, -0.03000000),
    (0.10092213, -0.07373521, -0.03000000),
    (0.04327947, -0.07500000, -0.03000000),
    (-0.10149999, -0.07500001, -0.03000000),
    (-0.12500000, -0.07500000, -0.03000000),
    (-0.12500000, 0.07500000, -0.03000000),
    (-0.09850000, 0.07500000, -0.03000000),
    (0.04327947, 0.07500000, -0.03000000),
    (0.04327947, 0.07500000, -0.02600000),
    (-0.09850000, 0.07500000, -0.02600000),
    (0.04327947, -0.07500000, -0.02600000),
    (0.14849879, 0.03620098, -0.02600000),
    (0.14930727, 0.03532738, -0.02600000),
    (0.14982289, 0.03425456, -0.02600000),
    (0.15000001, 0.03307750, -0.02600000),
    (0.15000001, -0.03307750, -0.02600000),
    (0.14982289, -0.03425455, -0.02600000),
    (0.14930727, -0.03532738, -0.02600000),
    (0.14849878, -0.03620098, -0.02600000),
    (0.10255926, -0.07295260, -0.02600000),
    (0.10092213, -0.07373521, -0.02600000),
    (-0.12500000, 0.07500000, -0.02600000),
    (-0.10149999, -0.07500001, -0.02600000),
    (-0.12500000, -0.07500000, -0.02600000),
)
_CEILING_HULL = (
    (0.10092213, 0.07373521, -0.01000000),
    (0.10092213, 0.07373521, -0.00600000),
    (0.10255926, 0.07295260, -0.01000000),
    (0.10255926, 0.07295260, -0.00600000),
    (0.14849879, 0.03620098, -0.01000000),
    (0.14930727, 0.03532738, -0.01000000),
    (0.14982289, 0.03425455, -0.01000000),
    (0.15000001, 0.03307750, -0.01000000),
    (0.15000001, -0.03307750, -0.01000000),
    (0.14849879, -0.03620098, -0.01000000),
    (0.14982289, -0.03425456, -0.01000000),
    (0.14930727, -0.03532738, -0.01000000),
    (0.10255926, -0.07295260, -0.01000000),
    (0.10092214, -0.07373520, -0.01000000),
    (0.04327947, -0.07500001, -0.01000000),
    (-0.12500000, -0.07500000, -0.01000000),
    (-0.12500000, 0.07500000, -0.01000000),
    (-0.10150000, -0.07500000, -0.01000000),
    (0.03538468, 0.07500000, -0.01000000),
    (0.04327947, 0.07500000, -0.01000000),
    (0.04327947, 0.07500000, -0.00600000),
    (0.03538468, 0.07500000, -0.00600000),
    (0.04327947, -0.07500001, -0.00600000),
    (0.14849879, 0.03620098, -0.00600000),
    (0.14930727, 0.03532738, -0.00600000),
    (0.14982289, 0.03425455, -0.00600000),
    (0.15000001, 0.03307750, -0.00600000),
    (0.15000001, -0.03307750, -0.00600000),
    (0.14982289, -0.03425456, -0.00600000),
    (0.14930727, -0.03532738, -0.00600000),
    (0.14849879, -0.03620098, -0.00600000),
    (0.10255926, -0.07295260, -0.00600000),
    (0.10092214, -0.07373520, -0.00600000),
    (-0.10150000, -0.07500000, -0.00600000),
    (-0.12500000, -0.07500000, -0.00600000),
    (-0.12500000, 0.07500000, -0.00600000),
)

WHEEL_RADIUS = 0.0325
WHEEL_HALF_WIDTH = 0.01
WHEELBASE = 0.20       # front-to-rear axle distance (x = ±0.10)
TRACK_WIDTH = 0.174    # left-to-right wheel distance (y = ±0.087)
STEER_LIMIT = math.radians(35.0)
N_LIDAR_BEAMS = 72
LIDAR_RADIUS = 0.035
LIDAR_CUTOFF = 12.0
CHASSIS_Z0 = 0.065     # chassis body frame height in keyframe pose

_WHEEL_FRICTION = (1.4, 0.08, 0.0015)
_WHEEL_QUAT = quat_from_axis_angle((1.0, 0.0, 0.0), math.pi / 2)  # euler 90 0 0


def _wheel_geom(name: str) -> GeomSpec:
    return GeomSpec(
        name=name, type="cylinder", size=(WHEEL_RADIUS, WHEEL_HALF_WIDTH),
        quat=_WHEEL_QUAT, friction=_WHEEL_FRICTION,
        contype=4, conaffinity=1, group=2, rgba=(0.1, 0.1, 0.1, 1.0),
    )


def _wheel_joint(name: str, damping: float, frictionloss: float,
                 armature: float) -> JointSpec:
    return JointSpec(name=name, type="hinge", axis=(0.0, 1.0, 0.0),
                     damping=damping, frictionloss=frictionloss,
                     armature=armature)


def _steer_joint(name: str) -> JointSpec:
    return JointSpec(name=name, type="hinge", axis=(0.0, 0.0, 1.0),
                     range=(-STEER_LIMIT, STEER_LIMIT),
                     damping=0.25, frictionloss=0.005)

# Hull triangles (index triples into the hull tuples above), extracted from
# MuJoCo's compiled mesh graph (mesh_graph face_globalid) for the same
# meshes and mapped onto the baked vertex ordering.  Consumed only by the
# ``reference_flat_manifold`` parity flag: MuJoCo's native convex collider
# emits the SUPPORT FACE of the deepest vertex as the plane-contact
# manifold (verified against 3.10 — the flipped flat plate's 3 contacts are
# exactly one hull triangle), which is what makes a flat plate rock.
_BASE_HULL_FACES = (  # 60 hull-graph triangles over 32 graph verts
    (16, 33, 17),
    (33, 16, 35),
    (20, 19, 17),
    (33, 20, 17),
    (19, 20, 0),
    (20, 1, 0),
    (22, 16, 14),
    (16, 22, 35),
    (13, 22, 14),
    (22, 13, 32),
    (24, 5, 4),
    (23, 24, 4),
    (3, 2, 0),
    (1, 3, 0),
    (2, 3, 4),
    (3, 23, 4),
    (27, 8, 7),
    (26, 27, 7),
    (6, 25, 7),
    (25, 26, 7),
    (25, 6, 5),
    (24, 25, 5),
    (13, 31, 32),
    (10, 31, 13),
    (11, 16, 17),
    (19, 11, 17),
    (2, 11, 0),
    (11, 19, 0),
    (16, 11, 14),
    (8, 11, 7),
    (11, 13, 14),
    (10, 11, 9),
    (5, 11, 4),
    (11, 2, 4),
    (11, 6, 7),
    (6, 11, 5),
    (11, 10, 13),
    (11, 12, 9),
    (12, 30, 9),
    (30, 12, 29),
    (30, 10, 9),
    (30, 31, 10),
    (28, 33, 35),
    (28, 3, 1),
    (28, 20, 33),
    (22, 28, 35),
    (28, 27, 26),
    (20, 28, 1),
    (28, 22, 32),
    (25, 28, 26),
    (28, 24, 23),
    (3, 28, 23),
    (28, 30, 29),
    (28, 25, 24),
    (31, 28, 32),
    (30, 28, 31),
    (11, 28, 12),
    (12, 28, 29),
    (27, 28, 8),
    (28, 11, 8),
)
_CEILING_HULL_FACES = (  # 60 hull-graph triangles over 32 graph verts
    (15, 35, 16),
    (35, 15, 34),
    (20, 19, 16),
    (35, 20, 16),
    (19, 20, 0),
    (20, 1, 0),
    (22, 15, 14),
    (15, 22, 34),
    (13, 22, 14),
    (22, 13, 32),
    (24, 5, 4),
    (23, 24, 4),
    (3, 2, 0),
    (1, 3, 0),
    (2, 3, 4),
    (3, 23, 4),
    (27, 8, 7),
    (26, 27, 7),
    (6, 25, 7),
    (25, 26, 7),
    (25, 6, 5),
    (24, 25, 5),
    (13, 31, 32),
    (12, 31, 13),
    (10, 15, 16),
    (19, 10, 16),
    (2, 10, 0),
    (10, 19, 0),
    (15, 10, 14),
    (8, 10, 7),
    (10, 13, 14),
    (12, 10, 9),
    (5, 10, 4),
    (10, 2, 4),
    (10, 6, 7),
    (6, 10, 5),
    (10, 12, 13),
    (10, 11, 9),
    (11, 30, 9),
    (30, 11, 29),
    (30, 12, 9),
    (30, 31, 12),
    (28, 35, 34),
    (28, 3, 1),
    (28, 20, 35),
    (22, 28, 34),
    (28, 27, 26),
    (20, 28, 1),
    (28, 22, 32),
    (25, 28, 26),
    (28, 24, 23),
    (3, 28, 23),
    (28, 30, 29),
    (28, 25, 24),
    (31, 28, 32),
    (30, 28, 31),
    (10, 28, 11),
    (11, 28, 29),
    (27, 28, 8),
    (28, 10, 8),
)


def _mesh_proxy_geom(name: str, inertial: InertialSpec, aabb,
                     hull=None, hull_faces=None) -> GeomSpec:
    """Box-typed proxy for a chassis mesh carrying its convex-hull vertices.

    MuJoCo re-centers mesh geoms at their inertial frame; the proxy box is the
    mesh's AABB transformed into the chassis body frame (used for MJCF export
    and raycast OBB tests).  ``hull`` attaches the mesh's convex-hull vertex
    cloud (body frame) — the engine's narrowphase collides those vertices,
    matching MuJoCo's convex collider for these geoms.
    """
    center, half = np.asarray(aabb[0]), np.asarray(aabb[1])
    w, x, y, z = inertial.quat
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    pos = np.asarray(inertial.pos) + R @ center
    return GeomSpec(
        name=name, type="box", size=tuple(half), pos=tuple(pos),
        quat=inertial.quat, contype=2, conaffinity=1, group=2,
        rgba=(0.2, 0.8, 0.8, 1.0), hull=hull, hull_faces=hull_faces,
    )


def lidar_site_frames():
    """Site pos/quat for the 72 lidar beams on the ``lidar_360`` body.

    Replicates MJCF ``<replicate count="72" sep="-" euler="0 0 5">`` of
    ``<site name="rf" pos="0.035 0 0" euler="0 90 0"/>``: beam i sits at
    Rz(5 deg * i) @ [r, 0, 0] with orientation Rz(5 deg * i) * Ry(90 deg),
    so its local +Z (the rangefinder ray direction) points radially outward.
    """
    base_quat = quat_from_axis_angle((0.0, 1.0, 0.0), math.pi / 2)
    frames = []
    for i in range(N_LIDAR_BEAMS):
        ang = math.radians(5.0 * i)
        rz = quat_from_axis_angle((0.0, 0.0, 1.0), ang)
        pos = (LIDAR_RADIUS * math.cos(ang), LIDAR_RADIUS * math.sin(ang), 0.0)
        frames.append((pos, quat_mul_np(rz, base_quat)))
    return frames


def ackermann_robot_legacy(floor: bool = True, n_beams: int = 36) -> ModelSpec:
    """The older robot variant embedded in the maze_flat scene.

    Differences from v2 (models/environments/ackermann_maze_flat.xml:141-304):
    independent left/right steering position actuators + torque (`motor`)
    rear drive with forcerange +-2, and a 36-beam lidar at 10-degree spacing.
    Drive with core.controller.ackermann_cmd_vel_to_controls (the reference's
    AckermannController, controller.py:27-78).
    """
    spec = ackermann_robot_v2(floor=floor)
    spec.name = "ackermann_robot_legacy"
    # lidar: n_beams at even spacing (reference uses explicit zaxis sites at
    # 10-degree spacing; same geometry)
    lidar_body = spec.body("lidar_360")
    lidar_body.sites = []
    base_quat = quat_from_axis_angle((0.0, 1.0, 0.0), math.pi / 2)
    step = 360.0 / n_beams
    for i in range(n_beams):
        ang = math.radians(step * i)
        rz = quat_from_axis_angle((0.0, 0.0, 1.0), ang)
        lidar_body.sites.append(SiteSpec(
            name=f"rf-{i:02d}",
            pos=(LIDAR_RADIUS * math.cos(ang), LIDAR_RADIUS * math.sin(ang),
                 0.0),
            quat=quat_mul_np(rz, base_quat)))
    # actuators: independent steering + torque rear drive
    spec.actuators = [
        ActuatorSpec.position("front_steer_left", "front_left_steer",
                              kp=40.0, kv=6.0, ctrlrange=(-0.61, 0.61),
                              forcerange=(-2.0, 2.0)),
        ActuatorSpec.position("front_steer_right", "front_right_steer",
                              kp=40.0, kv=6.0, ctrlrange=(-0.61, 0.61),
                              forcerange=(-2.0, 2.0)),
        ActuatorSpec.motor("rear_left_drive", "rear_left_wheel",
                           forcerange=(-2.0, 2.0)),
        ActuatorSpec.motor("rear_right_drive", "rear_right_wheel",
                           forcerange=(-2.0, 2.0)),
    ]
    # no steering-coupling equality (independent steering)
    spec.equalities = []
    # sensors: keep encoders, swap rangefinders for the n_beams set
    spec.sensors = [s for s in spec.sensors if s.type != "rangefinder"]
    for i in range(n_beams):
        spec.sensors.append(SensorSpec(
            f"lidar-{i:02d}", "rangefinder", f"rf-{i:02d}",
            cutoff=LIDAR_CUTOFF))
    return spec


def ackermann_robot_v2(floor: bool = True) -> ModelSpec:
    """Build the Ackermann robot spec (optionally with the 40x40 m floor)."""
    spec = ModelSpec(name="ackermann_robot", option=OptionSpec(
        timestep=0.002, gravity=(0.0, 0.0, -9.81)))

    if floor:
        spec.world_geoms.append(GeomSpec(
            name="floor", type="plane", size=(40.0, 40.0, 0.1),
            friction=(1.0, 0.005, 0.0001), contype=1, conaffinity=7,
            rgba=(0.9, 0.9, 0.9, 1.0)))

    chassis = BodySpec(name="chassis", parent="world", pos=(0.0, 0.0, CHASSIS_Z0),
                       joints=[JointSpec(name="root", type="free")])
    spec.bodies.append(chassis)

    spec.bodies.append(BodySpec(
        name="base", parent="chassis", inertial=_BASE_INERTIAL,
        geoms=[_mesh_proxy_geom("chassis", _BASE_INERTIAL, _BASE_AABB,
                                hull=_BASE_HULL,
                                hull_faces=_BASE_HULL_FACES)]))
    spec.bodies.append(BodySpec(
        name="ceiling", parent="chassis", inertial=_CEILING_INERTIAL,
        geoms=[_mesh_proxy_geom("ceiling", _CEILING_INERTIAL, _CEILING_AABB,
                                hull=_CEILING_HULL,
                                hull_faces=_CEILING_HULL_FACES)]))

    wheel_inertial = InertialSpec(mass=0.05, diaginertia=(1e-4, 1e-4, 1e-4))
    spec.bodies.append(BodySpec(
        name="rear_left", parent="chassis", pos=(-0.10, 0.087, -0.0325),
        inertial=wheel_inertial,
        joints=[_wheel_joint("rear_left_wheel", 0.15, 0.02, 0.002)],
        geoms=[_wheel_geom("rear_left_wheel_geom")]))
    spec.bodies.append(BodySpec(
        name="rear_right", parent="chassis", pos=(-0.10, -0.087, -0.0325),
        inertial=wheel_inertial,
        joints=[_wheel_joint("rear_right_wheel", 0.15, 0.02, 0.002)],
        geoms=[_wheel_geom("rear_right_wheel_geom")]))

    front_wheel_joint = lambda n: _wheel_joint(n, 0.12, 0.012, 0.0015)
    spec.bodies.append(BodySpec(
        name="front_left_steer", parent="chassis", pos=(0.10, 0.087, -0.0325),
        inertial=wheel_inertial, joints=[_steer_joint("front_left_steer")]))
    spec.bodies.append(BodySpec(
        name="front_left", parent="front_left_steer",
        inertial=wheel_inertial,
        joints=[front_wheel_joint("front_left_wheel")],
        geoms=[_wheel_geom("front_left_wheel_geom")]))
    spec.bodies.append(BodySpec(
        name="front_right_steer", parent="chassis", pos=(0.10, -0.087, -0.0325),
        inertial=wheel_inertial, joints=[_steer_joint("front_right_steer")]))
    spec.bodies.append(BodySpec(
        name="front_right", parent="front_right_steer",
        inertial=wheel_inertial,
        joints=[front_wheel_joint("front_right_wheel")],
        geoms=[_wheel_geom("front_right_wheel_geom")]))

    lidar_body = BodySpec(name="lidar_360", parent="chassis", pos=(0.0, 0.0, 0.03))
    for i, (pos, quat) in enumerate(lidar_site_frames()):
        lidar_body.sites.append(SiteSpec(name=f"rf-{i:02d}", pos=pos, quat=quat))
    spec.bodies.append(lidar_body)

    spec.equalities.append(EqualitySpec(
        name="steer_coupling", joint1="front_left_steer",
        joint2="front_right_steer"))

    spec.actuators.append(ActuatorSpec.position(
        "steering_servo", "front_left_steer", kp=40.0, kv=6.0,
        ctrlrange=(-0.61, 0.61), forcerange=(-2.0, 2.0)))
    spec.actuators.append(ActuatorSpec.velocity(
        "rear_left_drive", "rear_left_wheel", kv=1.0, ctrlrange=(-50.0, 50.0)))
    spec.actuators.append(ActuatorSpec.velocity(
        "rear_right_drive", "rear_right_wheel", kv=1.0, ctrlrange=(-50.0, 50.0)))

    spec.sensors.extend([
        SensorSpec("rear_left_pos", "jointpos", "rear_left_wheel"),
        SensorSpec("rear_left_vel", "jointvel", "rear_left_wheel"),
        SensorSpec("rear_right_pos", "jointpos", "rear_right_wheel"),
        SensorSpec("rear_right_vel", "jointvel", "rear_right_wheel"),
        SensorSpec("steering_angle", "jointpos", "front_left_steer"),
    ])
    for i in range(N_LIDAR_BEAMS):
        spec.sensors.append(SensorSpec(
            f"lidar-{i:02d}", "rangefinder", f"rf-{i:02d}", cutoff=LIDAR_CUTOFF))

    return spec
