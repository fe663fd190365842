"""The port's reference-compat knobs against the JAX package on the CPU
(umaze, B=8, solver 4/3): ``reference_delayed_obs`` and
``physics_substeps``, which ``rl/train.py --reference-compat`` and
PARITY.md's reproduction of the reference's learning dynamics run.

* Delayed obs over 6 steps of ``step_autoreset_batch`` from identical
  carried-across states, half the envs truncating on the first step, with
  JAX's own ``reset_core`` samples injected as the port's ``fresh``,
  against JAX's CPU ``step_autoreset_batch``: obs and final_obs 1e-4 (the
  goal angle through sin and cos), reward 2e-5, ``done`` exact, qpos 1e-5
  (the tolerances of ``test_torch_env_knobs.py``).  The port's twin makes
  MuJoCo's warm-start pick here (``force_warmstart_pick``), as JAX's CPU
  step (the staged step) does, so that the two compare like with like.
  Two physics substeps take the same test in
  ``test_torch_compat_substeps.py`` (a file of its own keeps each file's
  JAX builds and compiles under a minute).
* The kernels each knob calls: under delayed obs one K1 without the env
  (``<0,0,0>``) and two K2 a step (the pre-step observation and the fresh
  batch); with two substeps one ``<0,0,0>`` and one fused K1 a step, K2
  only at reset.
* Aliasing and delayed obs together on the open floor (the
  ``--reference-compat`` trainer's arena), 4 steps against JAX: the same
  tolerances, beams 0-9 equal to beam 71, and every step pays the -50
  collision penalty (every no-hit beam reads -1), as
  ``test_env_parity.py``'s open-floor test holds the JAX env to.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (autoreset_rollout, force_warmstart_pick,
                           jax_model_arrays, obs_close, one_torch_thread,
                           truncate_half)  # noqa: F401
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.ops import step as k1

B = 8
SOLVER = dict(solver_iterations=4, ls_iterations=3)
KNOBS = {"delayed": dict(reference_delayed_obs=True),
         "substeps2": dict(physics_substeps=2)}


def envs_of(arena, knobs):
    """The JAX env and the port's, on the JAX env's model."""
    args = ("maze", "umaze") if arena == "umaze" else ("simple",)
    jenv = jax_make_env(*args, **SOLVER, **knobs)
    penv = make_ackermann_env(*args, device="cpu", **SOLVER, **knobs)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    return jenv, penv


def check_step(pstates, jstates):
    obs_close(pstates.obs.numpy(), np.asarray(jstates.obs), 1e-4)
    obs_close(pstates.final_obs.numpy(), np.asarray(jstates.final_obs), 1e-4)
    np.testing.assert_allclose(pstates.reward.numpy(),
                               np.asarray(jstates.reward), atol=2e-5)
    np.testing.assert_allclose(pstates.physics.qpos.numpy(),
                               np.asarray(jstates.physics.qpos), atol=1e-5)


def rollout_matches_jax(knobs, monkeypatch):
    """6 auto-reset steps of the port against JAX's (module docstring)."""
    jenv, penv = envs_of("umaze", knobs)
    force_warmstart_pick(monkeypatch)
    max_steps = jenv.config.max_episode_steps
    jstates = truncate_half(jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(4), B)), max_steps)
    n_done = autoreset_rollout(jenv, jax.jit(jenv.step_autoreset_batch),
                               penv.step_autoreset_batch, jstates, 6,
                               seed=11, check=check_step)
    assert n_done >= B // 2


def test_delayed_obs_autoreset_rollout_matches_jax(monkeypatch):
    rollout_matches_jax(KNOBS["delayed"], monkeypatch)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_compat_knob_kernel_calls(knob, monkeypatch):
    """Which K1 flag sets and how many K2 scans a step of each knob
    makes (the counts ``chip_smoke.py`` holds on the card)."""
    penv = make_ackermann_env("maze", "umaze", device="cpu", **SOLVER,
                              **KNOBS[knob])
    calls = []
    step_fused, lidar = k1.step_fused, k2.lidar

    def spy_k1(*a, **kw):
        calls.append(("K1", kw.get("env_statics") is not None,
                      kw.get("fresh_statics") is not None))
        return step_fused(*a, **kw)

    def spy_k2(*a, **kw):
        calls.append(("K2",))
        return lidar(*a, **kw)

    monkeypatch.setattr(k1, "step_fused", spy_k1)
    monkeypatch.setattr(k2, "lidar", spy_k2)
    st = penv.reset(2)
    assert calls == [("K2",)]
    calls.clear()
    penv.step_autoreset_batch(st, torch.zeros((2, 2)))
    if knob == "delayed":
        assert calls == [("K1", False, False), ("K2",), ("K2",)], calls
    else:
        assert calls == [("K1", False, False), ("K1", True, True)], calls


def test_open_floor_aliasing_and_delayed_obs_match_jax(monkeypatch):
    knobs = dict(reference_delayed_obs=True, reference_lidar_aliasing=True)
    jenv, penv = envs_of("simple", knobs)
    force_warmstart_pick(monkeypatch)
    jstates = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(2), B))
    rewards = []

    def check(pstates, jstates):
        check_step(pstates, jstates)
        obs = pstates.obs.numpy()
        np.testing.assert_array_equal(obs[:, :10], obs[:, 71:72].repeat(10,
                                                                         1))
        rewards.append(pstates.reward.numpy())

    autoreset_rollout(jenv, jax.jit(jenv.step_autoreset_batch),
                      penv.step_autoreset_batch, jstates, 4, seed=5,
                      check=check)
    assert np.all(np.concatenate(rewards) < -49.0)
