"""The staged step (path B) as a whole against the JAX package on the CPU,
with the same float32 inputs on both sides.

* The staged step against JAX ``engine.step_batch`` with both compat flags,
  5 chained steps, on the umaze arena and on the wall scene of
  ``test_compat_manifolds.py``: qpos and xpos 1e-5 (as that file holds
  JAX's own staged step against the per-env step).
* A 5-step compat-env ``step_autoreset_batch`` against JAX's, with JAX's
  ``reset_core`` samples injected, half the envs truncating on the first
  step: obs, final_obs and reward 1e-4, ``done`` exact, qpos 1e-5; the
  settle template (3 staged steps at B=1) at 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_angles_close, jax_env_state_arrays,
                           jax_model_arrays)
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.physics import engine as jeng
from mujoco_playground_tpu.physics.state import make_state as jax_make_state
from mujoco_playground_tpu.spec import pointmaze_scene as jax_pointmaze
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.physics import engine
from mujoco_playground_tpu_torch.physics.state import State
from test_torch_staged import _models, _t, _wall_scene

B = 8
ANGLE = 78


def _port_state(s):
    return State(**{k: _t(np.asarray(getattr(s, k)))
                    for k in State.__dataclass_fields__})


@pytest.mark.parametrize("arena", ["umaze", "wall"])
def test_staged_step_matches_jax(arena):
    scene = jax_pointmaze("umaze") if arena == "umaze" else _wall_scene()
    jm, pm = _models(scene, True, True)
    rng = np.random.default_rng(5)
    q = np.tile(np.asarray(jm.qpos0, np.float32), (B, 1))
    if arena == "umaze":
        q[:, :2] = rng.uniform(-0.3, 0.3, (B, 2))
        q[:, 2] = float(jm.plane_z) + 0.048
    else:
        q[:, 0] = 0.26 + 0.005 * rng.uniform(-1, 1, B)
    states = jax.vmap(lambda x: jax_make_state(jm, qpos=x))(jnp.asarray(q))
    ctrl = np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-10, 10, B),
                     rng.uniform(-10, 10, B)], 1).astype(np.float32)
    states = states.replace(ctrl=jnp.asarray(ctrl))
    pstates = _port_state(states)
    jstep = jax.jit(lambda s: jeng.step_batch(jm, s))
    for _ in range(5):
        states = jstep(states)
        pstates = engine.step_batch(pm, pstates)
        np.testing.assert_allclose(pstates.qpos.numpy(),
                                   np.asarray(states.qpos), atol=1e-5)
        np.testing.assert_allclose(pstates.xpos.numpy(),
                                   np.asarray(states.xpos), atol=1e-5)
    assert float(np.abs(np.asarray(states.qvel)).max()) > 1e-2


def _obs_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    cols = [c for c in range(want.shape[-1]) if c != ANGLE]
    np.testing.assert_allclose(got[:, cols], want[:, cols], atol=atol)
    assert_angles_close(got[:, ANGLE], want[:, ANGLE], atol)


def test_compat_env_autoreset_rollout_matches_jax():
    kw = dict(solver_iterations=4, ls_iterations=3,
              reference_flat_manifold=True, reference_wheel_patch=True)
    jenv = jax_make_env("maze", "umaze", **kw)
    penv = make_ackermann_env("maze", "umaze", device="cpu", **kw)
    np.testing.assert_allclose(penv._template.qpos.numpy(),
                               np.asarray(jenv._template.qpos, np.float32),
                               atol=1e-6)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    jstates = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(6), B))
    steps = jnp.where(jnp.arange(B) % 2 == 0,
                      jenv.config.max_episode_steps - 1, 0
                      ).astype(jstates.steps.dtype)
    jstates = jstates.replace(steps=steps)
    pstates = interop.env_state_from_arrays(jax_env_state_arrays(jstates),
                                            "cpu")
    jstep = jax.jit(jenv.step_autoreset_batch)
    jfresh_of = jax.jit(lambda rng: jax.vmap(jenv.reset_core)(
        jax.vmap(jax.random.split)(rng)[:, 1]))
    rng = np.random.default_rng(7)
    n_done = 0
    for _ in range(5):
        actions = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        fresh = interop.env_state_from_arrays(
            jax_env_state_arrays(jfresh_of(jstates.rng)), "cpu")
        jstates = jstep(jstates, jnp.asarray(actions))
        pstates = penv.step_autoreset_batch(pstates, torch.from_numpy(actions),
                                            fresh=fresh)
        np.testing.assert_array_equal(pstates.done.numpy(),
                                      np.asarray(jstates.done))
        _obs_close(pstates.final_obs.numpy(), jstates.final_obs, 1e-4)
        _obs_close(pstates.obs.numpy(), jstates.obs, 1e-4)
        np.testing.assert_allclose(pstates.reward.numpy(),
                                   np.asarray(jstates.reward), atol=1e-4)
        np.testing.assert_allclose(pstates.physics.qpos.numpy(),
                                   np.asarray(jstates.physics.qpos),
                                   atol=1e-5)
        n_done += int(pstates.done.sum())
    assert n_done >= B // 2
