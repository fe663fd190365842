"""The port's spawners, ``main_sim`` and plotting against the JAX package's
(CPU).

* ``SimpleMapSpawner`` and ``MapSpawner``: each scene's compiled model
  against JAX's ``make_model`` (``_torch_parity.assert_model_matches``:
  atol 1e-6, rtol 1e-5 on the invweight0 leaves); each scene's spawn state
  (qpos with maze_flat's z = 0.1 and the mazes' floor_z + 0.055, and its
  FK frames) against JAX's spawner's within 1e-6, given positions and
  quaternions included; the seeded index stream repeats and reaches every
  scene; every spawn steps 3 per-env steps to a finite state.
* ``main_sim.main(["--headless", "--steps", "20", "--device", "cpu"])``
  against JAX's loop (``engine.step`` under ``jit`` with the same figure-8
  ctrl in float32, the model compiled by each package): qpos within 1e-6
  and qvel within 1e-4 (measured 7.4e-8 and 6.4e-6, with |qvel| up to
  13.4 on the wheels: the two compile invweight0 in float32 and float64
  and sum in other orders); its viewer
  path with a stub passive viewer: the state mirrored into MuJoCo and one
  line per lidar beam from the port's ``site_frames`` (1e-6).
* ``plot_trajectory`` and ``rollout_and_plot`` write a PNG under
  ``tmp_path``.
"""
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_model_matches, jax_model_arrays,  # noqa
                           one_torch_thread)
from mujoco_playground_tpu.core import controller as jctl
from mujoco_playground_tpu.envs import spawner as jspawner
from mujoco_playground_tpu.physics import engine as jengine
from mujoco_playground_tpu.physics import make_model as jax_make_model
from mujoco_playground_tpu.physics import make_state as jax_make_state
from mujoco_playground_tpu.spec.robot import ackermann_robot_v2 as jrobot_v2
from mujoco_playground_tpu.spec.scene import open_floor_scene as jfloor
from mujoco_playground_tpu_torch import main_sim
from mujoco_playground_tpu_torch.envs import make_ackermann_env, spawner
from mujoco_playground_tpu_torch.physics import engine, kinematics
from mujoco_playground_tpu_torch.utils import visualize

SCENES = ["PointMaze_UMaze-v3", "PointMaze_Open-v3", "PointMaze_Medium-v3",
          "PointMaze_Large-v3", "ackermann_maze_flat"]


@pytest.fixture(scope="module")
def spawners():
    return (spawner.MapSpawner(device="cpu", seed=0), jspawner.MapSpawner(),
            spawner.SimpleMapSpawner(device="cpu"),
            jspawner.SimpleMapSpawner())


def _by_name(sp, n=60):
    """The first spawn of each scene in n draws, by scene name."""
    out = {}
    for _ in range(n):
        model, state, name = sp.load_random_environment()
        out.setdefault(name, (model, state))
    return out


@pytest.mark.parametrize("name", SCENES + ["simple_floor"])
def test_spawner_models_match_jax(spawners, name):
    port, ref, simple, jsimple = spawners
    if name == "simple_floor":
        got, want = simple.model, jsimple.model
    else:
        got = port.models[[s.name for s in port.scenes].index(name)]
        want = ref.models[[s.name for s in ref.scenes].index(name)]
    assert_model_matches(got, jax_model_arrays(want))


def test_spawn_states_match_jax(spawners):
    port, ref, simple, jsimple = spawners
    got, want = _by_name(port), _by_name(ref)
    assert set(got) == set(want) == set(SCENES)
    pairs = [(got[n][1], want[n][1]) for n in SCENES]
    pairs.append((simple.load_random_environment()[1],
                  jsimple.load_random_environment()[1]))
    pos, quat = [0.5, -1.0, 0.2], [math.cos(0.3), 0.0, 0.0, math.sin(0.3)]
    pairs.append((port.load_random_environment(pos, quat)[1],
                  ref.load_random_environment(pos, quat)[1]))
    pairs.append((simple.load_random_environment(pos, quat)[1],
                  jsimple.load_random_environment(pos, quat)[1]))
    for p, j in pairs:
        for f in ("qpos", "qvel", "xpos", "xquat"):
            np.testing.assert_allclose(getattr(p, f).numpy(),
                                       np.asarray(getattr(j, f)), atol=1e-6,
                                       err_msg=f)
    z = {n: float(got[n][1].qpos[2]) for n in SCENES}
    assert z["ackermann_maze_flat"] == pytest.approx(0.1)
    for n in SCENES[:4]:
        assert z[n] == pytest.approx(-0.5 + 0.055)
    np.testing.assert_allclose(pairs[-2][0].qpos[:7].numpy(), pos + quat,
                               atol=1e-7)


def test_spawner_index_stream_is_seeded_and_reaches_every_scene():
    def draws(seed):
        sp = spawner.MapSpawner(device="cpu", seed=seed)
        return sp, [sp.load_random_environment() for _ in range(40)]

    sp, first = draws(3)
    names = [[d[2] for d in first]] + [[d[2] for d in draws(s)[1]]
                                       for s in (3, 4)]
    assert names[0] == names[1] and names[2] != names[0]
    assert set(names[0]) == set(SCENES)
    # the models are compiled once and handed out again
    for model, _, name in first:
        assert model is sp.models[[s.name for s in sp.scenes].index(name)]


def test_spawned_states_step_finite(spawners):
    port, _, simple, _ = spawners
    spawns = list(_by_name(port).values()) + [
        simple.load_random_environment()[:2]]
    for model, state in spawns:
        for _ in range(3):
            state = engine.step(model, state)
        for f in ("qpos", "qvel", "xpos"):
            assert bool(torch.isfinite(getattr(state, f)).all()), f


def test_main_sim_matches_jax_loop(capsys):
    steps = 20
    got = main_sim.main(["--headless", "--steps", str(steps), "--device",
                         "cpu", "--print-every", "10"])
    out = capsys.readouterr().out
    assert out.count("Lidar scan:") == 2 and out.count("Odometry") == 2

    model = jax_make_model(jrobot_v2(), jfloor())
    state = jax_make_state(model, qpos=model.qpos0.at[2].set(0.1))
    step = jax.jit(lambda s: jengine.step(model, s))
    timestep = float(model.timestep)
    for t in range(steps):
        ctrl = jctl.bicycle_cmd_vel_to_controls(
            jnp.float32(0.5), jnp.float32(0.8 * np.sin(t * timestep)))
        state = step(state.replace(ctrl=ctrl))
    assert got.qpos.dtype == torch.float32
    np.testing.assert_allclose(got.qpos.numpy(), np.asarray(state.qpos),
                               atol=1e-6)
    np.testing.assert_allclose(got.qvel.numpy(), np.asarray(state.qvel),
                               atol=1e-4)
    assert float(got.time) == pytest.approx(steps * timestep)


def test_main_sim_viewer_draws_the_lidar(monkeypatch):
    mujoco = pytest.importorskip("mujoco")
    import mujoco.viewer
    seen = {}

    def launch_passive(m, d, key_callback=None):
        seen.update(data=d, keys=key_callback, syncs=0)
        seen["viewer"] = SimpleNamespace(
            user_scn=mujoco.MjvScene(m, maxgeom=200),
            is_running=lambda: True,
            sync=lambda: seen.update(syncs=seen["syncs"] + 1),
            close=lambda: seen.update(closed=True))
        return seen["viewer"]

    monkeypatch.setattr(mujoco.viewer, "launch_passive", launch_passive)
    state = main_sim.main(["--steps", "3", "--device", "cpu"])
    assert seen["syncs"] == 3 and seen["closed"]
    assert seen["keys"].__name__ == "key_callback"
    np.testing.assert_allclose(seen["data"].qpos, state.qpos.numpy(),
                               atol=1e-6)
    # one line per beam, from each lidar site of the last state
    model = make_ackermann_env("simple", device="cpu").model
    pos, _ = kinematics.site_frames(model, state.xpos, state.xquat)
    scn = seen["viewer"].user_scn
    assert scn.ngeom == 72 == pos.shape[0]
    np.testing.assert_allclose(np.stack([scn.geoms[i].pos
                                         for i in range(72)]),
                               pos.numpy(), atol=1e-6)


def test_plot_trajectory_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    from mujoco_playground_tpu_torch.spec.scene import pointmaze_scene
    scene = pointmaze_scene("umaze")
    t = np.linspace(0, 1, 50)
    dirs = np.stack([np.cos(np.linspace(0, 2 * np.pi, 72)),
                     np.sin(np.linspace(0, 2 * np.pi, 72))], -1)
    path = visualize.plot_trajectory(
        scene, np.stack([t - 1, t], -1), goal=[1.0, 1.0], start=[-1.0, 0.0],
        lidar_frames=[(np.zeros(2), dirs, np.full(72, 0.8))],
        path=str(tmp_path / "traj.png"))
    data = (tmp_path / "traj.png").read_bytes()
    assert path == str(tmp_path / "traj.png")
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000


def test_rollout_and_plot_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    env = make_ackermann_env("maze", "umaze", device="cpu",
                             solver_iterations=4, ls_iterations=3,
                             max_episode_steps=3)
    path = visualize.rollout_and_plot(
        env, lambda obs: torch.tensor([[0.5, 0.2]]),
        generator=torch.Generator().manual_seed(1), max_steps=5,
        path=str(tmp_path / "rollout.png"))
    assert (tmp_path / "rollout.png").read_bytes()[:4] == b"\x89PNG"
    assert path.endswith("rollout.png")
