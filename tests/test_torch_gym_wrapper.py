"""The port's Gymnasium wrappers (``envs/gym_wrapper.py``) on the CPU:
``test_wrappers.py``'s API, seeding and vector-contract checks (B=4, 7
steps), both wrappers with gymnasium hidden (their API on a plain object
base), and the single env's viewer path, which mirrors the state into
MuJoCo through ``to_mjcf`` (a stub stands for the passive viewer's
window; qpos within 1e-6, float32 into float64).
``test_torch_gym_wrapper_parity.py`` holds their steps against JAX's.
"""
import importlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from mujoco_playground_tpu_torch.envs import EnvConfig, make_ackermann_env
from mujoco_playground_tpu_torch.envs import gym_wrapper as gw

gym = pytest.importorskip("gymnasium")


def test_gym_wrapper_api():
    env = gw.GymAckermannEnv(maze_id="PointMaze_UMaze-v3",
                             config=EnvConfig(max_episode_steps=10),
                             device="cpu")
    assert isinstance(env, gym.Env)
    assert env.observation_space.shape == (79,)
    assert env.action_space.shape == (2,)
    obs, info = env.reset(seed=3)
    assert obs.shape == (79,) and obs.dtype == np.float32
    assert env.observation_space.contains(obs)
    assert info["map_name"] == "PointMaze_UMaze-v3"
    assert len(info["goal_position"]) == 2
    for i in range(10):
        obs, reward, terminated, truncated, info = env.step([0.5, 0.1])
        assert isinstance(reward, float) and info["step"] == i + 1
        assert {"step", "goal_distance", "collision", "min_lidar",
                "linear_velocity", "angular_velocity"} <= set(info)
    assert truncated and not terminated  # 10-step truncation
    obs2, _ = env.reset(seed=4)
    assert obs2.shape == (79,)
    env.close()


def test_gym_wrapper_seeding_reproducible():
    env = gw.GymAckermannEnv(maze_id="PointMaze_UMaze-v3", device="cpu")
    o1, _ = env.reset(seed=11)
    o2, _ = env.reset(seed=11)
    np.testing.assert_array_equal(o1, o2)
    o3, _ = env.reset(seed=12)
    assert not np.array_equal(o1, o3)
    # a reset with no seed moves the seed on by one, as the JAX wrapper's
    env.reset(seed=11)
    o4, _ = env.reset()
    np.testing.assert_array_equal(o4, o3)


def test_gym_vector_env():
    from gymnasium.vector import VectorEnv
    from gymnasium.vector.vector_env import AutoresetMode

    venv = gw.GymVectorAckermannEnv(4, maze_id="PointMaze_UMaze-v3",
                                    config=EnvConfig(max_episode_steps=6),
                                    device="cpu")
    assert isinstance(venv, VectorEnv)
    assert venv.metadata["autoreset_mode"] is AutoresetMode.SAME_STEP
    assert venv.observation_space.shape == (4, 79)
    assert venv.action_space.shape == (4, 2)
    obs, _ = venv.reset(seed=0)
    assert obs.shape == (4, 79)
    assert venv.observation_space.contains(obs)
    acts = np.tile([0.5, 0.1], (4, 1)).astype(np.float32)
    for i in range(6):
        obs, rew, term, trunc, info = venv.step(acts)
        assert obs.shape == (4, 79) and obs.dtype == np.float32
        assert rew.shape == term.shape == trunc.shape == (4,)
        if i < 5:
            assert "final_obs" not in info
    assert trunc.all() and not term.any()     # all truncate at step 6
    # SAME_STEP convention: final_obs/final_info + mask keys
    assert info["final_obs"].shape == (4, 79)
    assert info["_final_obs"].all() and info["_final_info"].all()
    assert set(info["final_info"]) == {"goal_distance", "collision",
                                       "_goal_distance", "_collision"}
    obs, rew, term, trunc, info = venv.step(acts)
    assert not trunc.any()                    # fresh episodes after autoreset
    assert "final_obs" not in info            # no episode ended this step
    # the same seed repeats the episode's start
    np.testing.assert_array_equal(venv.reset(seed=0)[0],
                                  venv.reset()[0])
    venv.close()


@pytest.fixture
def no_gymnasium(monkeypatch):
    """gym_wrapper reloaded with gymnasium hidden; reloaded as it was
    after the test."""
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    try:
        yield importlib.reload(gw)
    finally:
        monkeypatch.undo()
        importlib.reload(gw)


@pytest.mark.parametrize("kind", ["single", "vector"])
def test_wrappers_without_gymnasium(no_gymnasium, kind):
    assert no_gymnasium._BASE is object and no_gymnasium._VBASE is object
    cfg = EnvConfig(max_episode_steps=2)
    if kind == "single":
        env = no_gymnasium.GymAckermannEnv(maze_id="umaze", config=cfg,
                                           device="cpu")
        assert type(env).__mro__[1] is object
        obs, info = env.reset(seed=1)
        assert obs.shape == (79,)
        assert info["map_name"] == "PointMaze_UMaze-v3"
        out = [env.step([0.2, 0.0]) for _ in range(2)]
        assert out[-1][3] and out[-1][0].dtype == np.float32
    else:
        env = no_gymnasium.GymVectorAckermannEnv(2, maze_id="umaze",
                                                 config=cfg, device="cpu")
        assert type(env).__mro__[1] is object and env.metadata == {}
        obs, _ = env.reset(seed=1)
        assert obs.shape == (2, 79)
        acts = np.zeros((2, 2), np.float32)
        out = [env.step(acts) for _ in range(2)]
        assert out[-1][3].all() and out[-1][4]["_final_obs"].all()
    assert not hasattr(env, "observation_space")


def test_render_mirrors_the_state_into_mujoco(monkeypatch):
    """``render_mode="human"``: the viewer path builds the MuJoCo model
    from ``to_mjcf`` and mirrors the port's qpos/qvel each step."""
    mujoco = pytest.importorskip("mujoco")
    import mujoco.viewer
    syncs = []
    monkeypatch.setattr(mujoco.viewer, "launch_passive", lambda m, d: (
        SimpleNamespace(sync=lambda: syncs.append(d.qpos.copy()),
                        close=lambda: syncs.append("closed"))))
    penv = make_ackermann_env("maze", "umaze", device="cpu",
                              solver_iterations=4, ls_iterations=3)
    env = gw.GymAckermannEnv(env=penv, render_mode="human")
    env.reset(seed=2)
    env.step([0.4, 0.2])
    assert env.render_mode == "human" and len(syncs) == 2
    np.testing.assert_allclose(syncs[-1], env._state.physics.qpos.numpy(),
                               atol=1e-6)
    assert env._mj_model.nq == penv.model.nq
    env.close()
    assert syncs[-1] == "closed"
