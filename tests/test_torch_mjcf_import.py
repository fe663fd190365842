"""The port's MJCF importer (``spec/mjcf_import.py``) against the JAX
package's and against MuJoCo 3.10's compiler.

* The round trip ``to_mjcf`` -> ``from_mjcf`` of both robots: the port's
  spec equals JAX's field by field; the port's float64 ``make_model``
  leaves equal the hand spec's to 1e-12, except the chassis hull clouds:
  ``to_mjcf`` writes each chassis mesh proxy as its box, so the imported
  hulls are the boxes' 8 corners (in JAX alike).  The float32 models are
  bitwise equal elsewhere, and a few steps of both at B=8 (the staged step
  and the fused step's twin, from reset states) are bitwise equal.
* ``<replicate>``: site frames against MuJoCo's (1e-12 / 1e-10, as
  tests/test_mjcf_import.py), the spec against JAX's.
* A missing mesh asset warns.
* A mesh body (a synthetic STL in ``tmp_path``): its inertial against
  JAX's import (1e-12) and MuJoCo's body mass, CoM and inertia (1e-8),
  its hull cloud and faces against JAX's (bitwise).
* A body of a mesh and a massful box without ``<inertial>``: the port's
  mass, CoM and inertia against MuJoCo's (1e-8); JAX's inertial drops the
  box's mass (ROADMAP.md, Known differences).
* Actuators, sensors and the equality's ``polycoef`` padding against JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_stl import prism_mesh, rotation, write_stl
from mujoco_playground_tpu.spec import mjcf_import as jax_import
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.physics import engine, kinematics
from mujoco_playground_tpu_torch.physics.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       make_model)
from mujoco_playground_tpu_torch.physics.state import make_state
from mujoco_playground_tpu_torch.spec import mjcf, robot
from mujoco_playground_tpu_torch.spec import types as st
from mujoco_playground_tpu_torch.spec.mjcf_import import (from_mjcf,
                                                          from_mjcf_file)

mujoco = pytest.importorskip("mujoco")

# the leaves a round trip changes: the chassis hulls become box corners
HULL_LEAVES = ("chassis_hull_verts",)
HULL_STATICS = ("chassis_hull_quadrants", "chassis_hull_bias",
                "chassis_hull_faces")
MUJOCO_TOL = 1e-8


def _asdict(spec):
    return dataclasses.asdict(spec)


def _box_corners(model):
    """Each chassis box's 8 corners in its body frame, as the compiler
    derives a hull-less box's cloud."""
    out = []
    for p, q, s in zip(model.chassis_box_pos.numpy(),
                       model.chassis_box_quat.numpy(),
                       model.chassis_box_size.numpy()):
        c = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)]) * s
        out.append(p + c @ rotation(q).T)
    return np.stack(out)


@pytest.fixture(scope="module")
def umaze_env():
    return make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, device="cpu", seed=3)


@pytest.mark.parametrize("name", ["ackermann_robot_v2",
                                  "ackermann_robot_legacy"])
def test_round_trip_matches_jax_and_hand_spec(umaze_env, name):
    hand = getattr(robot, name)()
    xml = mjcf.to_mjcf(hand)
    spec = from_mjcf(xml)
    assert _asdict(spec) == _asdict(jax_import.from_mjcf(xml))
    kw = dict(solver_iterations=4, ls_iterations=3, device="cpu")
    m_i = make_model(spec, umaze_env.scene, dtype=torch.float64, **kw)
    m_h = make_model(hand, umaze_env.scene, dtype=torch.float64, **kw)
    for f in STATIC_FIELDS:
        if f not in HULL_STATICS:
            assert getattr(m_i, f) == getattr(m_h, f), f
    for f in ARRAY_FIELDS:
        if f not in HULL_LEAVES:
            np.testing.assert_allclose(getattr(m_i, f).numpy(),
                                       getattr(m_h, f).numpy(), rtol=0,
                                       atol=1e-12, err_msg=f)
    assert m_h.chassis_hull_verts.shape[1] == 36
    np.testing.assert_allclose(m_i.chassis_hull_verts.numpy(),
                               _box_corners(m_h), atol=1e-12)
    # float32: bitwise, the hulls apart
    m32_i = make_model(spec, umaze_env.scene, dtype=torch.float32, **kw)
    m32_h = make_model(hand, umaze_env.scene, dtype=torch.float32, **kw)
    for f in ARRAY_FIELDS:
        if f not in HULL_LEAVES:
            assert torch.equal(getattr(m32_i, f), getattr(m32_h, f)), f


def test_round_trip_steps_like_the_hand_spec(umaze_env):
    """Three staged steps and three steps of the fused step's twin (the
    plain physics step) from the same B=8 reset states, both models:
    bitwise equal (no chassis contact from a reset)."""
    spec = from_mjcf(mjcf.to_mjcf(robot.ackermann_robot_v2()))
    m_i = make_model(spec, umaze_env.scene, solver_iterations=4,
                     ls_iterations=3, device="cpu")
    m_h = umaze_env.model
    g = torch.Generator().manual_seed(0)
    start = umaze_env.reset(8).physics
    for step in (engine.staged_step, engine.step_batch):
        s_i = s_h = start
        for _ in range(3):
            ctrl = torch.rand((8, 3), generator=g) * 2 - 1
            s_i = step(m_i, s_i.replace(ctrl=ctrl))
            s_h = step(m_h, s_h.replace(ctrl=ctrl))
        for f in ("qpos", "qvel", "xpos", "xquat", "qacc_warmstart"):
            assert torch.equal(getattr(s_i, f), getattr(s_h, f)), f
        assert float((s_h.qpos - start.qpos).abs().max()) > 1e-5


REPLICATE_XML = """
<mujoco model="rep">
  <compiler angle="degree"/>
  <worldbody>
    <body name="hub" pos="0 0 0.5">
      <freejoint/>
      <geom type="sphere" size="0.05" mass="1"/>
      <body name="ring" pos="0 0 0.1">
        <replicate count="12" sep="-" euler="0 0 30">
          <site name="s" pos="0.2 0 0" euler="0 90 0" size="0.003"/>
        </replicate>
      </body>
    </body>
  </worldbody>
  <sensor><rangefinder name="beam" site="s" cutoff="5"/></sensor>
</mujoco>"""


def test_replicate_matches_mujoco_and_jax():
    spec = from_mjcf(REPLICATE_XML)
    assert _asdict(spec) == _asdict(jax_import.from_mjcf(REPLICATE_XML))
    mj = mujoco.MjModel.from_xml_string(REPLICATE_XML)
    model = make_model(spec, dtype=torch.float64, device="cpu")
    assert model.nsite == mj.nsite == 12
    assert sum(k == "rangefinder" for k in model.sensor_kinds) == 12
    d = mujoco.MjData(mj)
    mujoco.mj_forward(mj, d)
    state = make_state(model)
    pos, zaxis = kinematics.site_frames(model, state.xpos, state.xquat)
    for i in range(12):
        name = f"s-{i:02d}"
        sid = mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_SITE, name)
        k = model.site_names.index(name)
        np.testing.assert_allclose(pos[k].numpy(), d.site_xpos[sid],
                                   atol=1e-12)
        np.testing.assert_allclose(zaxis[k].numpy(),
                                   d.site_xmat[sid].reshape(3, 3)[:, 2],
                                   atol=1e-10, err_msg=name)


def test_missing_mesh_asset_warns():
    xml = """
    <mujoco><worldbody><body name="b" pos="0 0 1"><freejoint/>
      <geom type="mesh" mesh="m"/>
      <inertial mass="1" pos="0 0 0" diaginertia="0.1 0.1 0.1"/>
    </body></worldbody></mujoco>"""
    with pytest.warns(UserWarning, match="mesh geom skipped"):
        spec = from_mjcf(xml)
    assert spec.body("b").inertial.mass == 1.0
    assert spec.body("b").geoms == []


def _mesh_xml(extra_geoms="", mode="legacy", quat="0.9 0.1 0.3 0.2"):
    return f"""<mujoco model="m">
      <compiler meshdir="parts"/>
      <asset><mesh name="notch" file="notch.stl" inertia="{mode}"/></asset>
      <worldbody><body name="b" pos="0.1 0.2 0.5"><freejoint/>
        <geom name="shell" type="mesh" mesh="notch" pos="0.02 -0.01 0.03"
              quat="{quat}" density="800"/>
        {extra_geoms}
      </body></worldbody></mujoco>"""


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("mjcf")
    (root / "parts").mkdir()
    v, f = prism_mesh([(0.0, 0.0), (0.4, 0.0), (0.4, 0.3), (0.25, 0.3),
                       (0.2, 0.1), (0.15, 0.3), (0.0, 0.3)], (0.2, 0.05),
                      0.125)
    write_stl(str(root / "parts" / "notch.stl"), v, f)
    return root


def _body_tensor(quat, diag):
    R = rotation(quat)
    return R @ np.diag(diag) @ R.T


def _assert_body_matches_mujoco(model, mj, b=1):
    """Mass, CoM and inertia of compiled body b against MuJoCo's: 1e-8
    (principal moments, and the diagonal in MuJoCo's principal frame)."""
    assert float(model.body_mass[b]) == pytest.approx(mj.body_mass[b],
                                                      rel=MUJOCO_TOL)
    np.testing.assert_allclose(model.body_ipos[b].numpy(), mj.body_ipos[b],
                               atol=MUJOCO_TOL)
    inertia = _body_tensor(model.body_iquat[b].numpy(),
                           model.body_inertia[b].numpy())
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(inertia)),
                               np.sort(mj.body_inertia[b]), atol=MUJOCO_TOL)
    frame = rotation(mj.body_iquat[b])
    np.testing.assert_allclose(np.diag(frame.T @ inertia @ frame),
                               mj.body_inertia[b], atol=MUJOCO_TOL)


@pytest.mark.parametrize("mode", ["legacy", "exact", "convex", "shell"])
def test_mesh_body_matches_jax_and_mujoco(mesh_dir, mode):
    path = mesh_dir / "robot.xml"
    path.write_text(_mesh_xml(mode=mode))
    spec = from_mjcf_file(str(path))
    want = jax_import.from_mjcf_file(str(path))
    got_b, want_b = spec.body("b"), want.body("b")
    assert got_b.inertial.mass == pytest.approx(want_b.inertial.mass,
                                                rel=1e-12)
    for f in ("pos", "quat", "diaginertia"):
        np.testing.assert_allclose(getattr(got_b.inertial, f),
                                   getattr(want_b.inertial, f), rtol=0,
                                   atol=1e-12, err_msg=f)
    (g,), (jg,) = got_b.geoms, want_b.geoms
    np.testing.assert_array_equal(np.array(g.hull), np.array(jg.hull))
    assert g.hull_faces == jg.hull_faces
    assert g.type == jg.type == st.BOX
    for f in ("size", "pos", "quat"):
        np.testing.assert_allclose(getattr(g, f), getattr(jg, f), rtol=0,
                                   atol=1e-12, err_msg=f)
    mj = mujoco.MjModel.from_xml_path(str(path))
    model = make_model(spec, dtype=torch.float64, device="cpu")
    _assert_body_matches_mujoco(model, mj)


def test_mixed_mesh_and_primitive_body_matches_mujoco(mesh_dir):
    """A body of a mesh geom and a box of mass 1.5 with no <inertial>:
    MuJoCo combines both; so does the port, while JAX's inertial is the
    mesh's alone, 1.5 kg short."""
    box = ('<geom name="weight" type="box" size="0.05 0.04 0.03" '
           'pos="-0.2 0.1 0.05" euler="0 0 25" mass="1.5"/>')
    path = mesh_dir / "mixed.xml"
    path.write_text(_mesh_xml(extra_geoms=box))
    spec = from_mjcf_file(str(path))
    mj = mujoco.MjModel.from_xml_path(str(path))
    model = make_model(spec, dtype=torch.float64, device="cpu")
    _assert_body_matches_mujoco(model, mj)
    assert [g.name for g in spec.body("b").geoms] == ["shell", "weight"]
    jax_mass = jax_import.from_mjcf_file(str(path)).body("b").inertial.mass
    assert jax_mass == pytest.approx(mj.body_mass[1] - 1.5, rel=1e-12)
    # the mesh alone gives JAX's inertial
    alone = from_mjcf_file(str(_write(mesh_dir / "alone.xml", _mesh_xml())))
    assert alone.body("b").inertial.mass == pytest.approx(jax_mass,
                                                          rel=1e-12)


def _write(path, text):
    path.write_text(text)
    return path


ACTUATED_XML = """
<mujoco model="act">
  <compiler angle="radian"/>
  <option timestep="0.004" gravity="0 0 -9"/>
  <default><geom friction="0.8 0.01 0.001"/></default>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="base" pos="0 0 0.2">
      <freejoint name="root"/>
      <geom type="box" size="0.1 0.05 0.02" mass="2"/>
      <site name="lidar" pos="0.1 0 0.03" zaxis="1 0 0"/>
      <body name="arm" pos="0.05 0 0" axisangle="0 0 1 0.3">
        <joint name="j1" type="hinge" axis="0 1 0" range="-1 1"
               damping="0.1" armature="0.01" frictionloss="0.02"/>
        <geom type="cylinder" size="0.02 0.05" mass="0.2"/>
      </body>
      <body name="arm2" pos="-0.05 0 0">
        <joint name="j2" type="slide" axis="1 0 0" range="-0.1 0.1"/>
        <geom type="sphere" size="0.02" mass="0.1"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position name="p" joint="j1" kp="20" kv="1" ctrlrange="-1 1"/>
    <velocity name="v" joint="j2" kv="3" forcerange="-5 5"/>
    <motor name="m" joint="j1" gear="2.5"/>
    <general name="g" joint="j2" gainprm="4" biasprm="0.5 -1 -0.2"/>
  </actuator>
  <sensor>
    <jointpos name="q1" joint="j1"/>
    <jointvel name="v2" joint="j2"/>
    <rangefinder name="r" site="lidar" cutoff="3"/>
  </sensor>
  <equality><joint name="couple" joint1="j2" joint2="j1" polycoef="0 0.5"/>
  </equality>
</mujoco>"""


def test_actuators_sensors_equalities_match_jax():
    spec = from_mjcf(ACTUATED_XML)
    assert _asdict(spec) == _asdict(jax_import.from_mjcf(ACTUATED_XML))
    assert [a.name for a in spec.actuators] == ["p", "v", "m", "g"]
    assert spec.actuators[0].bias == (0.0, -20.0, -1.0)
    assert spec.actuators[3].gain == 4.0
    assert [s.type for s in spec.sensors] == ["jointpos", "jointvel",
                                              "rangefinder"]
    (eq,) = spec.equalities
    assert eq.polycoef == (0.0, 0.5, 0.0, 0.0, 0.0)
    assert spec.option.timestep == 0.004
    model = make_model(spec, dtype=torch.float64, device="cpu")
    assert model.nu == 4 and len(model.eq_dof_pairs) == 1
