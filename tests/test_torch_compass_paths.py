"""The goal compass and the geodesic shaping on path A,
``DomainRandomizedEnv`` (K1e's twin), against the JAX package on the CPU:
umaze, B=8, JAX's randomized leaves carried across (floor offsets of +-2
cm), three auto-reset steps from JAX's reset states with half the envs
truncating on the first, JAX's ``reset_core`` samples injected.  obs and
final_obs 81 wide within 1e-4 (the compass 1e-5), reward within 2e-5,
``done`` exact, qpos 1e-5.  ``test_torch_compass_staged.py`` holds path B
the same way.
"""
import jax
import numpy as np
import torch

from _torch_parity import (autoreset_rollout, jax_model_arrays, obs_close,
                           one_torch_thread, truncate_half)  # noqa: F401
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.envs.domain_randomization import \
    DomainRandomizedEnv as JaxDREnv
from mujoco_playground_tpu.envs.domain_randomization import \
    RandomizationConfig as JaxConfig
from mujoco_playground_tpu.physics import engine as jax_engine
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import (DomainRandomizedEnv,
                                              RandomizationConfig,
                                              make_ackermann_env)

B = 8
KNOBS = dict(geodesic_reward_scale=10.0, goal_compass=True,
             solver_iterations=4, ls_iterations=3)
WIDE = dict(floor_z_offset=(-0.02, 0.02))


def _envs(**kw):
    jenv = jax_make_env("maze", "umaze", **KNOBS, **kw)
    penv = make_ackermann_env("maze", "umaze", device="cpu", **KNOBS, **kw)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    return jenv, penv


def _check(p, j):
    assert p.obs.shape == p.final_obs.shape == (B, 81)
    obs_close(p.final_obs.numpy(), j.final_obs, 1e-4, compass_atol=1e-5)
    obs_close(p.obs.numpy(), j.obs, 1e-4, compass_atol=1e-5)
    np.testing.assert_allclose(p.reward.numpy(), np.asarray(j.reward),
                               atol=2e-5)
    np.testing.assert_allclose(p.physics.qpos.numpy(),
                               np.asarray(j.physics.qpos), atol=1e-5)


def test_compass_and_shaping_on_path_a_match_jax():
    jenv, penv = _envs()
    jdr = JaxDREnv(jenv, B, jax.random.PRNGKey(5), JaxConfig(**WIDE))
    pdr = DomainRandomizedEnv(penv, B, torch.Generator().manual_seed(0),
                              RandomizationConfig(**WIDE))
    pdr.models = interop.randomized_model_from_arrays(
        penv.model, {name: np.asarray(leaf, np.float32) for name, leaf in
                     jax_engine.batched_field_dict(jdr.models,
                                                   jenv.model).items()})
    assert_rollout_matches(jenv, jdr, pdr)


def assert_rollout_matches(jenv, jstepper, pstepper):
    """Three auto-reset steps of ``jstepper`` (a JAX env or DR env of
    ``jenv``) and ``pstepper`` from the same states, held by ``_check``."""
    jstates = truncate_half(jax.jit(jax.vmap(jstepper.reset))(
        jax.random.split(jax.random.PRNGKey(6), B)),
        jenv.config.max_episode_steps)
    n_done = autoreset_rollout(
        jenv, jax.jit(jstepper.step_autoreset_batch),
        pstepper.step_autoreset_batch, jstates, 3, 3, _check)
    assert n_done >= B // 2
