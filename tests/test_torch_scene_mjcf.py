"""The port's registry mazes, legacy robot and MJCF export against the JAX
package's, and MuJoCo 3.10 as the port's own oracle (CPU).

* ``registry_maze_map`` and ``pointmaze_scene`` for registered PointMaze
  ids that the scene module does not transcribe: the same cell grid, and
  ``box_pos``, ``box_size`` and ``free_cells`` equal to JAX's (exact: the
  same numpy arithmetic).  An unknown id raises ``KeyError`` on both sides.
* ``ackermann_robot_legacy``'s compiled model leaves against JAX's
  (``_torch_parity.assert_model_matches``: atol 1e-6, rtol 1e-5 on the
  invweight0 leaves).
* ``to_mjcf``'s XML byte-equal to JAX's for the v2 robot with no scene, the
  open floor, maze_flat and umaze, and for the legacy robot.
* MuJoCo 3.10 compiles the port's XML and the port's float64 per-env step
  (``engine.step``, solver 20/12) follows ``mj_step`` for 100 steps from a
  settled, driving state, at ``test_engine_parity.py``'s
  ``test_trajectory_parity_driving`` tolerances: chassis qpos 1e-8, wheel
  angles 1e-4, qvel 1e-6; and the port's float64 sensordata (encoders
  and the 72 rangefinders) equals MuJoCo's within 1e-12 at three spawn
  yaws in umaze and maze_flat, as ``test_lidar_parity`` holds JAX's.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (assert_model_matches, jax_model_arrays,  # noqa
                           one_torch_thread)
from mujoco_playground_tpu.physics.model import make_model as jax_make_model
from mujoco_playground_tpu.spec import mjcf as jmjcf
from mujoco_playground_tpu.spec import robot as jrobot
from mujoco_playground_tpu.spec import scene as jscene
from mujoco_playground_tpu_torch.physics import engine, sensors
from mujoco_playground_tpu_torch.physics.model import make_model
from mujoco_playground_tpu_torch.physics.state import make_state
from mujoco_playground_tpu_torch.spec import mjcf, robot, scene

mujoco = pytest.importorskip("mujoco")

UNTRANSCRIBED = ["PointMaze_Medium_Diverse_GR-v3", "PointMaze_Large_Diverse_G-v3"]


@pytest.mark.parametrize("maze_id", UNTRANSCRIBED)
def test_registered_maze_matches_jax(maze_id):
    assert maze_id not in scene.POINTMAZE_MAPS
    assert scene.registry_maze_map(maze_id) == jscene.registry_maze_map(
        maze_id)
    got, want = scene.pointmaze_scene(maze_id), jscene.pointmaze_scene(
        maze_id)
    assert got.name == want.name == maze_id
    for name in ("box_pos", "box_size", "free_cells"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.floor_z == want.floor_z and got.cell_size == want.cell_size


def test_unknown_maze_id_raises():
    for mod in (scene, jscene):
        with pytest.raises(KeyError, match="not in the transcribed maps"):
            mod.pointmaze_scene("PointMaze_NoSuchMaze-v3")
        with pytest.raises(KeyError, match="no maze_map"):
            mod.registry_maze_map("CartPole-v1")


def test_legacy_robot_model_matches_jax():
    spec = robot.ackermann_robot_legacy()
    assert len(spec.actuators) == 4 and not spec.equalities
    assert sum(s.type == "rangefinder" for s in spec.sensors) == 36
    port = make_model(spec, scene.maze_flat_scene(), device="cpu")
    want = jax_model_arrays(jax_make_model(jrobot.ackermann_robot_legacy(),
                                           jscene.maze_flat_scene()))
    assert port.nu == 4 and port.nsite == 36
    assert_model_matches(port, want)


_EXPORTS = {
    "v2-no-scene": (robot.ackermann_robot_v2, None,
                    jrobot.ackermann_robot_v2, None),
    "v2-floor": (robot.ackermann_robot_v2, scene.open_floor_scene,
                 jrobot.ackermann_robot_v2, jscene.open_floor_scene),
    "v2-maze_flat": (robot.ackermann_robot_v2, scene.maze_flat_scene,
                     jrobot.ackermann_robot_v2, jscene.maze_flat_scene),
    "v2-umaze": (robot.ackermann_robot_v2,
                 lambda: scene.pointmaze_scene("umaze"),
                 jrobot.ackermann_robot_v2,
                 lambda: jscene.pointmaze_scene("umaze")),
    "legacy-maze_flat": (robot.ackermann_robot_legacy, scene.maze_flat_scene,
                         jrobot.ackermann_robot_legacy,
                         jscene.maze_flat_scene),
}


@pytest.mark.parametrize("case", sorted(_EXPORTS))
def test_to_mjcf_is_byte_equal_to_jax(case):
    spec, sc, jspec, jsc = _EXPORTS[case]
    got = mjcf.to_mjcf(spec(), sc() if sc else None)
    want = jmjcf.to_mjcf(jspec(), jsc() if jsc else None)
    assert got == want
    mj = mujoco.MjModel.from_xml_string(got)
    assert mj.nu == len(spec().actuators)


@pytest.fixture(scope="module")
def floor_pair():
    spec = robot.ackermann_robot_v2()
    mj = mujoco.MjModel.from_xml_string(mjcf.to_mjcf(spec))
    model = make_model(spec, dtype=torch.float64, solver_iterations=20,
                       ls_iterations=12, device="cpu")
    return model, mj


def _state_of(model, d):
    st = make_state(model, qpos=torch.from_numpy(d.qpos.copy()),
                    qvel=torch.from_numpy(d.qvel.copy()))
    return st.replace(ctrl=torch.from_numpy(d.ctrl.copy()))


def test_port_step_follows_mujoco_driving(floor_pair):
    model, mj = floor_pair
    d = mujoco.MjData(mj)
    d.qpos[0:3] = [0, 0, 0.1]
    for _ in range(500):
        mujoco.mj_step(mj, d)
    d.ctrl[:] = [0.3, 10.0, 10.0]
    for _ in range(100):
        mujoco.mj_step(mj, d)
    mujoco.mj_forward(mj, d)
    st = _state_of(model, d)
    for _ in range(100):
        st = engine.step(model, st)
        mujoco.mj_step(mj, d)
    # the chassis pose to a tight tolerance; the wheel spin angles are
    # unobservable, so looser there
    np.testing.assert_allclose(st.qpos[:7].numpy(), d.qpos[:7], atol=1e-8)
    np.testing.assert_allclose(st.qpos[7:].numpy(), d.qpos[7:], atol=1e-4)
    np.testing.assert_allclose(st.qvel.numpy(), d.qvel, atol=1e-6)


@pytest.mark.parametrize("arena,spawn", [
    ("umaze", [1.0, 1.0, -0.445]),
    ("maze_flat", [1.5, 0.5, 0.065]),
])
def test_port_sensordata_matches_mujoco(arena, spawn):
    sc = (scene.maze_flat_scene() if arena == "maze_flat"
          else scene.pointmaze_scene(arena))
    spec = robot.ackermann_robot_v2()
    mj = mujoco.MjModel.from_xml_string(mjcf.to_mjcf(spec, sc))
    model = make_model(spec, sc, dtype=torch.float64, device="cpu")
    d = mujoco.MjData(mj)
    rng = np.random.RandomState(3)
    for _ in range(3):
        yaw = rng.uniform(0, 2 * np.pi)
        d.qpos[0:3] = spawn
        d.qpos[3:7] = [np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)]
        mujoco.mj_forward(mj, d)
        st = make_state(model, qpos=torch.from_numpy(d.qpos.copy()))
        np.testing.assert_allclose(sensors.sensordata(model, st).numpy(),
                                   d.sensordata, atol=1e-12)
