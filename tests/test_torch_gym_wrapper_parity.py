"""The port's Gymnasium wrappers' ``step`` against the JAX package's
wrappers from identical injected states (``interop.env_state_from_arrays``)
on the CPU: umaze, solver 4/3, the port's env on JAX's model.

* ``GymAckermannEnv`` (the per-env step on both sides, each making
  MuJoCo's warm-start pick) for 4 steps through a truncation: obs, reward,
  goal_distance and min_lidar 1e-5 (the goal angle through sin and cos),
  terminated, truncated, collision, step and the commanded velocities
  exact.
* ``GymVectorAckermannEnv`` at B=4 for 3 steps with the even envs one
  step from truncation and JAX's own auto-reset draws injected as the
  port's: the same outputs and every info key (``final_obs`` 1e-5, the
  ``_`` masks exact), with the port's K1 twin forced to MuJoCo's
  warm-start pick (``_torch_parity.force_warmstart_pick``), as JAX's CPU
  step makes it (ROADMAP, Known differences).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (force_warmstart_pick, jax_env_state_arrays,
                           jax_model_arrays, obs_close,  # noqa: F401
                           one_torch_thread, truncate_half)
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.envs import gym_wrapper as jgw
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import gym_wrapper as gw
from mujoco_playground_tpu_torch.envs import make_ackermann_env

pytest.importorskip("gymnasium")

SOLVER = dict(solver_iterations=4, ls_iterations=3)
MAX_STEPS = 3
TOL = 1e-5


@pytest.fixture(scope="module")
def envs():
    jenv = jax_make_env("maze", "umaze", max_episode_steps=MAX_STEPS,
                        **SOLVER)
    penv = make_ackermann_env("maze", "umaze", max_episode_steps=MAX_STEPS,
                              device="cpu", **SOLVER)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    return jenv, penv


def test_gym_step_matches_jax(envs):
    jenv, penv = envs
    jw = jgw.GymAckermannEnv(env=jenv)
    pw = gw.GymAckermannEnv(env=penv)
    _, jinfo = jw.reset(seed=5)
    pw._state = interop.env_state_from_arrays(
        jax_env_state_arrays(jw._state), "cpu")
    rng = np.random.default_rng(6)
    for i in range(MAX_STEPS + 1):
        action = rng.uniform(-1.2, 1.2, 2).astype(np.float32)
        if i == MAX_STEPS:     # past the end: the per-env step goes on
            action = np.float32([0.5, -0.3])
        got, want = pw.step(action), jw.step(action)
        obs_close(got[0][None], want[0][None], TOL)
        np.testing.assert_allclose(got[1], want[1], atol=TOL)
        assert got[2:4] == want[2:4]
        assert set(got[4]) == set(want[4])
        for key in ("step", "collision", "linear_velocity",
                    "angular_velocity"):
            assert got[4][key] == want[4][key], key
        for key in ("goal_distance", "min_lidar"):
            np.testing.assert_allclose(got[4][key], want[4][key], atol=TOL)
        assert got[3] == (i + 1 >= MAX_STEPS and not got[2])


def test_gym_vector_step_matches_jax(envs, monkeypatch):
    force_warmstart_pick(monkeypatch)
    jenv, penv = envs
    B = 4
    jv = jgw.GymVectorAckermannEnv(B, env=jenv)
    pv = gw.GymVectorAckermannEnv(B, env=penv)
    jv.reset(seed=0)
    jv._states = truncate_half(jv._states, MAX_STEPS)
    pv._states = interop.env_state_from_arrays(
        jax_env_state_arrays(jv._states), "cpu")
    jfresh_of = jax.jit(lambda rng: jax.vmap(jenv.reset_core)(
        jax.vmap(jax.random.split)(rng)[:, 1]))
    rng = np.random.default_rng(7)
    n_final = 0
    for _ in range(3):
        actions = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        fresh = interop.env_state_from_arrays(
            jax_env_state_arrays(jfresh_of(jv._states.rng)), "cpu")
        monkeypatch.setattr(penv, "reset_core", lambda *a, **kw: fresh)
        got, want = pv.step(actions), jv.step(jnp.asarray(actions))
        obs_close(got[0], want[0], TOL)
        np.testing.assert_allclose(got[1], want[1], atol=TOL)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
        info, jinfo = got[4], want[4]
        assert set(info) == set(jinfo)
        np.testing.assert_allclose(info["goal_distance"],
                                   jinfo["goal_distance"], atol=TOL)
        np.testing.assert_array_equal(info["collision"], jinfo["collision"])
        if "final_obs" in jinfo:
            n_final += 1
            obs_close(info["final_obs"], jinfo["final_obs"], TOL)
            for key in ("_final_obs", "_final_info"):
                np.testing.assert_array_equal(info[key], jinfo[key])
            assert set(info["final_info"]) == set(jinfo["final_info"])
            for key, v in jinfo["final_info"].items():
                np.testing.assert_allclose(info["final_info"][key], v,
                                           atol=TOL, err_msg=key)
    assert n_final >= 1
