"""The port's env knobs that the main path bakes into K1, all on at once,
against the JAX package on the CPU over 12 auto-reset steps at B=8 (half
the envs truncating on the first, JAX's ``reset_core`` samples injected):

* umaze with ``collision_ignores_nohit`` (``--sane-collision``),
  ``progress_reward_scale``, ``collision_penalty`` and
  ``reference_lidar_aliasing``;
* the open floor with the first two.

The port's twin makes MuJoCo's warm-start pick as JAX's CPU step does
(``force_warmstart_pick``: over 12 steps the fused step without it meets a
contact-set change where the two starts part), so both sides compare like
with like: obs within 1e-6 (the goal angle through sin and cos), reward
1e-6, qpos 1e-7, ``done`` and ``collision`` exact.  On the open floor the
goal lies up to 8 m away, where one float32 ulp is 9.5e-7: the distance
columns are held at 2e-6, and the reward, whose progress term is 3 times a
difference of two such distances, at 4e-6 (measured: 1.5e-6).
"""
import jax
import numpy as np
import pytest

from _torch_parity import (assert_angles_close, autoreset_rollout,
                           force_warmstart_pick, jax_model_arrays,
                           one_torch_thread, truncate_half)  # noqa: F401
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import make_ackermann_env

B = 8
ANGLE = 78
SANE = dict(collision_ignores_nohit=True, progress_reward_scale=3.0)
KNOBS = {"umaze": dict(SANE, collision_penalty=-1.0,
                       reference_lidar_aliasing=True),
         "simple": SANE}
# (obs, reward) tolerances: see the module docstring
TOL = {"umaze": (1e-6, 1e-6), "simple": (2e-6, 4e-6)}


def _check(p, j, tol):
    obs_tol, reward_tol = tol
    for got, want in ((p.obs, j.obs), (p.final_obs, j.final_obs)):
        got, want = got.numpy(), np.asarray(want)
        cols = [c for c in range(want.shape[-1]) if c != ANGLE]
        np.testing.assert_allclose(got[:, cols], want[:, cols], atol=obs_tol)
        assert_angles_close(got[:, ANGLE], want[:, ANGLE], 1e-6)
    np.testing.assert_allclose(p.reward.numpy(), np.asarray(j.reward),
                               atol=reward_tol)
    np.testing.assert_allclose(p.physics.qpos.numpy(),
                               np.asarray(j.physics.qpos), atol=1e-7)
    np.testing.assert_array_equal(p.collision.numpy(),
                                  np.asarray(j.collision))


@pytest.mark.parametrize("arena", ["umaze", "simple"])
def test_env_knobs_match_jax_over_12_steps(arena, monkeypatch):
    env_type = "maze" if arena == "umaze" else "simple"
    kw = dict(solver_iterations=4, ls_iterations=3, **KNOBS[arena])
    jenv = jax_make_env(env_type, "umaze", **kw)
    penv = make_ackermann_env(env_type, "umaze", device="cpu", **kw)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    force_warmstart_pick(monkeypatch)
    jstates = truncate_half(jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(6), B)),
        jenv.config.max_episode_steps)
    n_done = autoreset_rollout(jenv, jax.jit(jenv.step_autoreset_batch),
                               penv.step_autoreset_batch, jstates, 12, 1,
                               lambda p, j: _check(p, j, TOL[arena]))
    assert n_done >= B // 2
