"""The umaze slice as a whole: ``rollout_gae`` of the port against the JAX
package's, on the CPU at T=4, B=8, from one env state carried across
through ``interop.py``, with JAX's action noise and reset samples
injected.  Obs, actions, log-probabilities, rewards, values, advantages,
returns, qpos and the updated norm statistics at 1e-4 (the two JAX step
paths differ by 2.4e-5 in qpos, ROADMAP Queue 3); done and terminated
flags exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_angles_close, jax_env_state_arrays,
                           jax_model_arrays)
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.rl import networks as jax_networks
from mujoco_playground_tpu.rl import ppo as jax_ppo
from mujoco_playground_tpu.rl.config import RLConfig as JaxRLConfig
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.rl import networks, ppo
from mujoco_playground_tpu_torch.rl.config import RLConfig

OBS = 79
ANGLE = 78   # the goal-angle column of the observation
NORM_FIELDS = ("obs_mean", "obs_var", "ret_mean", "ret_var", "count",
               "env_returns")


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny ops: one thread runs them as
    fast and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, atol=0.0, rtol=0.0, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=err_msg)


def test_rollout_gae_matches_jax():
    """T=4 steps of 8 umaze envs from one state carried across, half of
    them truncating on the second step, with normalization on (non-trivial
    statistics) and JAX's action noise and reset samples injected.  The
    solver runs the main path's 4 Newton and 3 line-search iterations: the
    JAX CPU step picks its Newton start by cost and K1 starts from the warm
    start (ROADMAP Queue 3, "Warm starts differ"), which 2 iterations leave
    unconverged enough to part the paths by ~1e-3 in lidar readings after 4
    steps (measured)."""
    T, B = 4, 8
    kw = dict(num_envs=B, unroll_length=T, num_minibatches=2, ppo_epochs=1,
              solver_iterations=4, ls_iterations=3, normalize_obs=True,
              normalize_reward=True, env_type="maze")
    jconfig, config = JaxRLConfig(**kw), RLConfig(**kw)
    jenv = jax_make_env("maze", "umaze", solver_iterations=4, ls_iterations=3)
    penv = make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, device="cpu")
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    jnet = jax_networks.ActorCritic(action_size=2, hidden=(64, 64))
    params = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(11), jnp.zeros((OBS,), jnp.float32)))
    jts = jax.jit(functools.partial(jax_ppo.init_train_state, jenv, jnet,
                                    jconfig))(jax.random.PRNGKey(12))
    rng = np.random.default_rng(13)
    steps = np.where(np.arange(B) % 2 == 0,
                     jenv.config.max_episode_steps - 2, 5)
    norm = jax_ppo.NormState(
        obs_mean=jnp.asarray(rng.normal(0, 0.5, OBS).astype(np.float32)),
        obs_var=jnp.asarray(rng.uniform(0.5, 2.0, OBS).astype(np.float32)),
        ret_mean=jnp.asarray(np.float32(0.3)),
        ret_var=jnp.asarray(np.float32(4.0)),
        count=jnp.asarray(np.float32(100.0)),
        env_returns=jnp.asarray(rng.normal(0, 5, B).astype(np.float32)))
    jts = jts.replace(
        params=jax.tree.map(jnp.asarray, params), norm=norm,
        env_states=jts.env_states.replace(steps=jnp.asarray(
            steps, jts.env_states.steps.dtype)))
    jts2, (jbatch, jadv, jret, _), jmetrics = jax.jit(
        jax_ppo.make_train_step(jenv, jnet, jconfig).rollout_gae)(jts)

    # JAX's draws: the action noise of each step, and each step's reset
    # samples from the per-env keys (which move on where an env is done)
    _, k_roll, _ = jax.random.split(jts.rng, 3)
    eps = np.stack([np.asarray(jax.random.normal(k, (B, 2), jnp.float32))
                    for k in jax.random.split(k_roll, T)])
    split = jax.jit(jax.vmap(jax.random.split))
    reset_core = jax.jit(jax.vmap(jenv.reset_core))
    keys = {"rng": jts.env_states.rng}

    def fresh(step, states):
        if step > 0:
            done = jnp.asarray(states.done.numpy())[:, None]
            keys["rng"] = jnp.where(done, keys["next"], keys["rng"])
        rngs = split(keys["rng"])
        keys["next"] = rngs[:, 0]
        return interop.env_state_from_arrays(
            jax_env_state_arrays(reset_core(rngs[:, 1])), "cpu")

    net = networks.ActorCritic(OBS, 2, (64, 64))
    net.load_state_dict(interop.actor_critic_from_flax(params))
    ts = ppo.TrainState(
        network=net, optimizer=ppo.make_optimizer(config, net.parameters()),
        env_states=interop.env_state_from_arrays(
            jax_env_state_arrays(jts.env_states), "cpu"),
        generator=torch.Generator(), global_step=0,
        norm=interop.norm_state_from_arrays(
            {k: np.asarray(getattr(norm, k)) for k in NORM_FIELDS}, "cpu"),
        env_generator=penv.generator)
    ts2, (batch, adv, ret), metrics = ppo.make_train_step(
        penv, config).rollout_gae(ts, eps=t(eps), fresh=fresh)

    np.testing.assert_array_equal(batch["done"].numpy(),
                                  np.asarray(jbatch.done))
    np.testing.assert_array_equal(batch["terminated"].numpy(),
                                  np.asarray(jbatch.terminated))
    assert 0 < float(batch["done"].sum()) < T * B   # mid-slab episode ends
    # the normalized obs, the goal angle through sin and cos of the raw one
    cols = [c for c in range(OBS) if c != ANGLE]
    close(batch["obs"][:, cols], np.asarray(jbatch.obs)[:, cols], atol=1e-4)
    std = np.sqrt(np.asarray(norm.obs_var)[ANGLE] + 1e-8)
    mu = np.asarray(norm.obs_mean)[ANGLE]
    assert_angles_close(batch["obs"][:, ANGLE].numpy() * std + mu,
                        np.asarray(jbatch.obs)[:, ANGLE] * std + mu, 1e-4)
    for k in ("action", "logp", "value", "reward"):
        close(batch[k], getattr(jbatch, k), atol=1e-4, err_msg=k)
    close(adv, jadv, atol=1e-4)
    close(ret, jret, atol=1e-4)
    close(ts2.env_states.physics.qpos, jts2.env_states.physics.qpos,
          atol=1e-4)
    for k in NORM_FIELDS:
        close(getattr(ts2.norm, k), getattr(jts2.norm, k), rtol=1e-4,
              atol=1e-4, err_msg=k)
    for k, v in jmetrics.items():
        close(metrics[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
