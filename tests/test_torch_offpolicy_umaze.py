"""One SAC ``train_step`` on umaze against the JAX package's, on the CPU
(B=8, 30-step episodes, solver 2/2, 2 collect + 2 gradient steps, 64x64
towers), with half the envs one step from truncation so that both paths
of the auto-reset write buffer rows.

JAX's key splits are replayed and injected: the collect steps' normal
draws, the auto-reset's fresh spawns (``reset_core`` of each env's split
key, as ``autoreset_rollout`` does), each update's minibatch rows and its
two normal draws; JAX's initial parameters and env states are carried
across. The port's twin makes MuJoCo's warm-start pick, as JAX's CPU step
does (``force_warmstart_pick``).

Tolerances (float32): the buffer's observations within 1e-5 (the env
step's float32 physics and lidar over two steps, the goal angle through
sin and cos; `test_torch_env_knobs.py` holds 1e-6 over 12 steps), its
actions and rewards within 1e-5 and its flags bitwise; the mean reward
and alpha within 1e-5 relative; parameters, targets and ``log_alpha``
within 1e-4 absolute, a third of one Adam step (lr 3e-4): Adam's first
steps divide each gradient entry by its own magnitude plus eps = 1e-8,
so an entry whose gradient is near eps moves by up to lr either way on a
tiny difference of that gradient, which the 1e-5 differences of the
env's observations give the critics (2.2e-5 measured on 3 of 5,184
entries of ``q1_dense_0``; the actor and the targets within 5e-7); the
actor loss, which those critics feed, within 5e-4 absolute (1.0e-4
measured).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import (carry_offpolicy_params, force_warmstart_pick,
                           jax_env_state_arrays, jax_offpolicy_leaves,
                           obs_close, truncate_half)
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.rl import sac as jax_sac
from mujoco_playground_tpu.rl.config import RLConfig as JaxRLConfig
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.rl import sac
from mujoco_playground_tpu_torch.rl.config import RLConfig

B, EP = 8, 30
KW = dict(num_envs=B, sac_buffer_size=1024, sac_batch_size=32,
          sac_learning_starts=0, solver_iterations=2, ls_iterations=2,
          max_episode_steps=EP, offpolicy_hidden_sizes=(64, 64))
ATOL = 1e-5
PARAM_ATOL = 1e-4
LOSS_ATOL = 5e-4


def t(a):
    return torch.from_numpy(np.array(a))


def test_sac_train_step_on_umaze_matches_jax(monkeypatch):
    force_warmstart_pick(monkeypatch)
    collect_steps = grad_steps = 2
    jcfg = JaxRLConfig(**KW)
    with jax.enable_x64(False):
        jenv = jax_make_env("maze", "umaze", max_episode_steps=EP,
                            solver_iterations=2, ls_iterations=2)
        init, make_step = jax_sac.make_sac(jenv, jcfg, collect_steps,
                                           grad_steps)
        j0 = jax.jit(init)(jax.random.PRNGKey(0))
        j0 = j0.replace(env_states=truncate_half(j0.env_states, EP))
        j1, jm = jax.jit(make_step(random_actions=False))(j0)

        # JAX's draws, its key splits replayed; an env's key moves on
        # (to the first half of its split) only where its step ended the
        # episode, which the steps counters and JAX's buffer flags say
        _, k_collect, k_updates = jax.random.split(j0.rng, 3)
        fresh_of = jax.jit(lambda rng: jax.vmap(jenv.reset_core)(
            jax.vmap(jax.random.split)(rng)[:, 1]))
        rng, steps = j0.env_states.rng, np.asarray(j0.env_states.steps)
        term = np.asarray(j1.buffer.terminated)[:collect_steps * B]
        eps_c, fresh, n_done = [], [], 0
        for k, key in enumerate(jax.random.split(k_collect, collect_steps)):
            eps_c.append(jax.random.normal(key, (B, 2), jnp.float32))
            fresh.append(interop.env_state_from_arrays(
                jax_env_state_arrays(fresh_of(rng)), "cpu"))
            done = (term[k * B:(k + 1) * B] > 0) | (steps + 1 >= EP)
            rng = jnp.where(done[:, None],
                            jax.vmap(jax.random.split)(rng)[:, 0], rng)
            steps = np.where(done, 0, steps + 1)
            n_done += int(done.sum())
        idx, eps_t, eps_a = [], [], []
        for key in jax.random.split(k_updates, grad_steps):
            k1, k2, k3 = jax.random.split(key, 3)
            idx.append(jax.random.randint(
                k1, (KW["sac_batch_size"],), 0,
                jnp.maximum(j1.buffer.size, 1)))
            eps_t.append(jax.random.normal(k2, (KW["sac_batch_size"], 2),
                                           jnp.float32))
            eps_a.append(jax.random.normal(k3, (KW["sac_batch_size"], 2),
                                           jnp.float32))
    assert n_done >= B // 2
    assert np.array_equal(steps, np.asarray(j1.env_states.steps))

    env = make_ackermann_env("maze", "umaze", max_episode_steps=EP,
                             solver_iterations=2, ls_iterations=2,
                             device="cpu")
    pinit, pmake = sac.make_sac(env, RLConfig(**KW), collect_steps,
                                grad_steps)
    p = pinit()
    carry_offpolicy_params(p, j0)
    p = p.replace(env_states=interop.env_state_from_arrays(
        jax_env_state_arrays(j0.env_states), "cpu"))
    stack = lambda xs: t(np.stack([np.asarray(x) for x in xs]))  # noqa
    p, pm = pmake(random_actions=False)(
        p, collect_draws=stack(eps_c), fresh=lambda k, _s: fresh[k],
        idx=stack(idx), eps_target=stack(eps_t), eps_actor=stack(eps_a))

    jb, pb, n = j1.buffer, p.buffer, collect_steps * B
    assert pb.size == int(jb.size) == n and pb.ptr == int(jb.ptr)
    for name in ("obs", "next_obs"):
        obs_close(getattr(pb, name)[:n].numpy(),
                  np.asarray(getattr(jb, name))[:n], ATOL)
    for name in ("action", "reward"):
        np.testing.assert_allclose(getattr(pb, name)[:n].numpy(),
                                   np.asarray(getattr(jb, name))[:n],
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(pb.terminated[:n].numpy(),
                                  np.asarray(jb.terminated)[:n])
    d = interop.offpolicy_checkpoint_from_flax(jax_offpolicy_leaves(j1))
    for name in p.MODULES:
        got = getattr(p, name).state_dict()
        for k, v in d[name].items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       atol=PARAM_ATOL,
                                       err_msg=f"{name}.{k}")
    np.testing.assert_allclose(float(p.log_alpha.detach()),
                               float(d["log_alpha"]), atol=PARAM_ATOL)
    assert p.global_step == int(j1.global_step) == n
    for k in ("mean_reward", "alpha"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(pm["actor_loss"]),
                               float(jm["actor_loss"]), atol=LOSS_ATOL)
