"""The port's PPO pieces against the JAX package's, on the CPU, fed the same
numpy inputs.

Tolerances (float32 unless said otherwise):

* ``gae`` 1e-6; ``update_norm_state`` over done patterns with mid-slab
  episode ends 1e-6 of each statistic's largest magnitude;
  ``normalize_obs``/``normalize_reward`` 1e-6;
* ``ActorCritic`` with carried weights against ``network.apply`` 1e-6;
  ``gaussian_logp``, ``gaussian_entropy`` and ``sample_action`` with the
  same normal draws 1e-6;
* the PPO loss and its gradients against ``jax.value_and_grad`` of the JAX
  loss, 1e-5 relative;
* clipped Adam, with and without the linear schedule, against optax over
  several updates, one of them clipped, 1e-6 relative;
* the shuffle: a permutation for each case of ``test_ppo_shuffle.py``, and
  JAX's rows given JAX's permutation and roll;
* one whole ``update`` with JAX's per-epoch permutations, 1e-5 relative on
  the parameters' largest magnitude;
* the committed flagship policy, carried across, acts as JAX's on 256
  seeded observations, 1e-5;
* ``compute_episode_stats`` and ``StepTimer`` exactly (the same float64
  arithmetic on the host).
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mujoco_playground_tpu.rl import evaluate as jax_evaluate
from mujoco_playground_tpu.rl import networks as jax_networks
from mujoco_playground_tpu.rl import ppo as jax_ppo
from mujoco_playground_tpu.rl import utils as jax_utils
from mujoco_playground_tpu.rl.config import RLConfig as JaxRLConfig
from mujoco_playground_tpu.utils import profiler as jax_profiler
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.rl import evaluate, networks, ppo, utils
from mujoco_playground_tpu_torch.rl.config import RLConfig
from mujoco_playground_tpu_torch.utils import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "rl_logs", "flagship", "ppo",
                        "step_0300023808")
OBS = 79


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=0.0, rtol=0.0, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=err_msg)


def rel_close(got, want, rel, err_msg=""):
    """|got - want| <= rel * max|want| (normwise relative)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{err_msg}: {err:.3e} > {rel} x {scale:.3e}"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny ops: one thread runs them as
    fast and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_net_and_params(seed=0, hidden=(64, 64)):
    net = jax_networks.ActorCritic(action_size=2, hidden=hidden)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((OBS,), jnp.float32))
    return net, jax.tree.map(np.asarray, params)


def port_net(params, hidden=(64, 64)):
    net = networks.ActorCritic(OBS, 2, hidden)
    net.load_state_dict(interop.actor_critic_from_flax(params))
    return net


def port_grads(net):
    """The port's gradients keyed like ``actor_critic_from_flax``'s
    output."""
    return {k: p.grad for k, p in net.named_parameters()}


def flax_leaves(tree):
    """The flax tree's leaves keyed like the port's state_dict (kernels
    transposed)."""
    return {k: v.numpy() for k, v in
            interop.actor_critic_from_flax(jax.tree.map(np.asarray,
                                                        tree)).items()}


# ----------------------------------------------------------------- GAE, norm
def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, B = 12, 5
    r, v, fv = (rng.standard_normal((T, B)).astype(np.float32)
                for _ in range(3))
    term = (rng.random((T, B)) < 0.2).astype(np.float32)
    done = np.maximum(term, rng.random((T, B)) < 0.2).astype(np.float32)
    want = jax_ppo.gae(*(jnp.asarray(x) for x in (r, v, fv, term, done)),
                       0.99, 0.95)
    got = ppo.gae(*(t(x) for x in (r, v, fv, term, done)), 0.99, 0.95)
    close(got, want, atol=1e-6)


def _norm_arrays(norm):
    return {k: np.asarray(getattr(norm, k)) for k in
            ("obs_mean", "obs_var", "ret_mean", "ret_var", "count",
             "env_returns")}


def test_update_norm_state_matches_jax():
    """Three folds of (T=7, B=5) slabs whose done flags end episodes in the
    middle of the slab (and one env never ends)."""
    rng = np.random.default_rng(3)
    T, B, D = 7, 5, 6
    jnorm = jax_ppo.init_norm_state(D, B)
    pnorm = ppo.init_norm_state(D, B)
    for _ in range(3):
        obs = (rng.standard_normal((T, B, D)) * 3.0 + 1.5).astype(np.float32)
        rew = (rng.standard_normal((T, B)) * 10).astype(np.float32)
        done = (rng.random((T, B)) < 0.3).astype(np.float32)
        done[:, 0] = 0.0
        done[3, 1] = 1.0
        jnorm = jax_ppo.update_norm_state(jnorm, jnp.asarray(obs),
                                          jnp.asarray(rew),
                                          jnp.asarray(done), 0.9)
        pnorm = ppo.update_norm_state(pnorm, t(obs), t(rew), t(done), 0.9)
        # normwise: the running returns cancel (XLA may fuse the
        # multiply-add), so each statistic is held to 1e-6 of its scale
        for k, want in _norm_arrays(jnorm).items():
            rel_close(getattr(pnorm, k), want, 1e-6, k)
    x = (rng.standard_normal((64, D)) * 4).astype(np.float32)
    close(ppo.normalize_obs(pnorm, t(x)),
          jax_ppo.normalize_obs(jnorm, jnp.asarray(x)), atol=1e-6)
    r = (rng.standard_normal(64) * 100).astype(np.float32)
    close(ppo.normalize_reward(pnorm, t(r)),
          jax_ppo.normalize_reward(jnorm, jnp.asarray(r)), atol=1e-6)


# -------------------------------------------------------------- the network
def test_actor_critic_forward_matches_flax():
    jnet, params = jax_net_and_params(1)
    # a stored log_std outside [-20, 2]: the output is clipped, the
    # parameter is not
    params["params"]["log_std"] = np.asarray([3.0, -0.5], np.float32)
    net = port_net(params)
    obs = np.random.default_rng(2).standard_normal((16, OBS)).astype(
        np.float32)
    want = jax.jit(jnet.apply)(params, jnp.asarray(obs))
    with torch.no_grad():
        got = net(t(obs))
    for g, w, name in zip(got, want, ("mean", "log_std", "value")):
        close(g, w, atol=1e-6, err_msg=name)
    assert float(got[1][0]) == 2.0 and float(net.log_std.detach()[0]) == 3.0


def test_actor_critic_init_is_sb3_layout():
    net = networks.ActorCritic(OBS, 2, (64, 64),
                               generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    for name, gain in (("pi_tower.dense_0", 2.0), ("pi_tower.dense_1", 2.0),
                       ("vf_tower.dense_0", 2.0), ("action_head", 1e-4),
                       ("value_head", 1.0)):
        w = sd[f"{name}.weight"].double()
        close(w @ w.T, gain * np.eye(w.shape[0]), atol=1e-6 * gain,
              err_msg=name)
        assert not sd[f"{name}.bias"].any(), name
    assert not sd["log_std"].any()
    again = networks.ActorCritic(OBS, 2, (64, 64),
                                 generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], v) for k, v in again.state_dict().items())


def test_gaussian_helpers_match_jax():
    rng = np.random.default_rng(4)
    mean = rng.standard_normal((32, 2)).astype(np.float32)
    log_std = np.asarray([-0.7, 0.3], np.float32)
    action = rng.standard_normal((32, 2)).astype(np.float32)
    close(networks.gaussian_logp(t(mean), t(log_std), t(action)),
          jax_networks.gaussian_logp(jnp.asarray(mean), jnp.asarray(log_std),
                                     jnp.asarray(action)), atol=1e-6)
    close(networks.gaussian_entropy(t(log_std)),
          jax_networks.gaussian_entropy(jnp.asarray(log_std)), atol=1e-6)
    key = jax.random.PRNGKey(5)
    eps = jax.random.normal(key, mean.shape, jnp.float32)
    ja, jl = jax_networks.sample_action(jnp.asarray(mean),
                                        jnp.asarray(log_std), key)
    pa, pl = networks.sample_action(t(mean), t(log_std), eps=t(eps))
    close(pa, ja, atol=1e-6)
    close(pl, jl, atol=1e-6)


# ------------------------------------------------------ loss and optimizer
def _closure(fn, name):
    """A free variable of a closure (the JAX loss sits inside
    make_train_step)."""
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells[name].cell_contents


def _jax_grad_fn(config):
    step = jax_ppo.make_train_step(None, jax_networks.ActorCritic(
        action_size=2, hidden=tuple(config.hidden_sizes)), config)
    return _closure(_closure(step.update, "update_epoch"), "grad_fn")


def _minibatch(rng, n, net_params, jnet):
    obs = rng.standard_normal((n, OBS)).astype(np.float32)
    mean, log_std, _ = jnet.apply(net_params, jnp.asarray(obs))
    action = np.asarray(mean + jnp.exp(log_std) * rng.standard_normal(
        (n, 2)).astype(np.float32))
    # old log-probabilities near the current ones, some outside the clip
    logp = (np.asarray(jax_networks.gaussian_logp(mean, log_std, action))
            + rng.normal(0, 0.3, n)).astype(np.float32)
    adv = (rng.standard_normal(n) * 2 + 0.5).astype(np.float32)
    ret = (rng.standard_normal(n) * 3).astype(np.float32)
    return dict(obs=obs, action=action, logp=logp), adv, ret


def _jax_transition(b):
    z = jnp.zeros(b["logp"].shape, jnp.float32)
    return jax_ppo.Transition(obs=jnp.asarray(b["obs"]),
                              action=jnp.asarray(b["action"]),
                              logp=jnp.asarray(b["logp"]), value=z, reward=z,
                              terminated=z, done=z, final_obs=z)


def test_ppo_loss_and_grads_match_jax():
    config = RLConfig()
    jnet, params = jax_net_and_params(6)
    batch, adv, ret = _minibatch(np.random.default_rng(6), 128, params, jnet)
    (jloss, jaux), jgrads = jax.jit(_jax_grad_fn(JaxRLConfig()))(
        params, _jax_transition(batch), jnp.asarray(adv), jnp.asarray(ret))
    assert 0.0 < float(jaux["clip_frac"]) < 1.0   # the clip is exercised
    net = port_net(params)
    loss, aux = ppo.ppo_loss(net, config, {k: t(v) for k, v in batch.items()},
                             t(adv), t(ret))
    loss.backward()
    rel_close(loss, jloss, 1e-5, "loss")
    for k in ppo.AUX_KEYS:
        rel_close(aux[k], jaux[k], 1e-5, k)
    got = port_grads(net)
    for k, want in flax_leaves(jgrads).items():
        rel_close(got[k], want, 1e-5, k)


@pytest.mark.parametrize("anneal", [False, True])
def test_clipped_adam_matches_optax(anneal):
    """Six updates (the third with gradients 100x, so the global-norm clip
    fires); with ``anneal`` the linear schedule runs over 4 updates, so the
    last two use a learning rate of 0."""
    kw = dict(num_envs=8, unroll_length=4, ppo_epochs=2, num_minibatches=2,
              total_timesteps=32, anneal_lr=anneal)
    jconfig, config = JaxRLConfig(**kw), RLConfig(**kw)
    tx = jax_ppo.make_optimizer(jconfig)
    _, params = jax_net_and_params(7)
    params = jax.tree.map(jnp.asarray, params)
    state = tx.init(params)
    net = port_net(jax.tree.map(np.asarray, params))
    opt = ppo.make_optimizer(config, net.parameters())
    assert opt.updates_total == (4 if anneal else None)
    rng = np.random.default_rng(8)
    clipped = 0

    @jax.jit
    def jax_step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for k in range(6):
        scale = 100.0 if k == 2 else 0.002
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32) * scale), params)
        clipped += float(optax.global_norm(grads)) > config.max_grad_norm
        params, state = jax_step(grads, state, params)
        port = flax_leaves(grads)
        for name, p in net.named_parameters():
            p.grad = torch.from_numpy(port[name].copy())
        opt.step()
        for name, want in flax_leaves(params).items():
            close(net.state_dict()[name], want, rtol=1e-6, atol=1e-9,
                  err_msg=f"update {k} {name}")
    assert clipped == 1 and opt.count == 6


# ------------------------------------------------------------------ shuffle
SHUFFLE_CASES = [
    (4096 * 32, 32, 128),     # the production default: 4096x32, blk=128
    (4096, 32, 128),
    (1024, 8, 64),
    (4096, 32, 1),            # SB3-exact per-row
    (4096, 32, 7),            # non-dividing blk -> per-row fallback
    (256, 4, 256),            # blk == n -> single block (roll still moves)
]


@pytest.mark.parametrize("n,mb,blk", SHUFFLE_CASES)
def test_shuffle_is_permutation(n, mb, blk):
    for seed in (0, 1, 17):
        take = ppo.make_epoch_shuffle(
            n, mb, blk, torch.Generator().manual_seed(seed))
        out = take(torch.arange(n))
        assert out.shape == (mb, n // mb)
        np.testing.assert_array_equal(np.sort(out.reshape(-1).numpy()),
                                      np.arange(n))


def _jax_shuffle_draws(key, n, mb, blk):
    """(perm, shift) as JAX's make_epoch_shuffle draws them from ``key``."""
    if blk > 1 and n % blk == 0 and (n // mb) % blk == 0:
        k_perm, k_roll = jax.random.split(key)
        return (np.asarray(jax.random.permutation(k_perm, n // blk)),
                np.asarray(jax.random.randint(k_roll, (), 0, n)))
    return np.asarray(jax.random.permutation(key, n)), None


@pytest.mark.parametrize("n,mb,blk", SHUFFLE_CASES)
def test_shuffle_takes_jax_rows(n, mb, blk):
    x = np.stack([np.arange(n), np.arange(n) * 10], 1)
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        want = jax_ppo.make_epoch_shuffle(key, n, mb, blk)(jnp.asarray(x))
        perm, shift = _jax_shuffle_draws(key, n, mb, blk)
        got = ppo.make_epoch_shuffle(
            n, mb, blk, perm=t(perm),
            shift=None if shift is None else torch.tensor(int(shift)))(t(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ whole update
@pytest.mark.parametrize("blk", [1, 8])
def test_update_matches_jax(blk):
    """Two epochs of two minibatches over a 32-row slab, per-row (blk=1)
    and in blocks of 8, with JAX's per-epoch shuffles injected."""
    kw = dict(num_envs=8, unroll_length=4, ppo_epochs=2, num_minibatches=2,
              shuffle_block_size=blk, total_timesteps=64, anneal_lr=True)
    jconfig, config = JaxRLConfig(**kw), RLConfig(**kw)
    jnet, params = jax_net_and_params(9)
    batch, adv, ret = _minibatch(np.random.default_rng(9), 32, params, jnet)
    jparams = jax.tree.map(jnp.asarray, params)
    jts = jax_ppo.TrainState(
        params=jparams, opt_state=jax_ppo.make_optimizer(jconfig).init(
            jparams), env_states=None, rng=jax.random.PRNGKey(0),
        global_step=jnp.zeros((), jnp.int32))
    k_update = jax.random.PRNGKey(10)
    jstep = jax_ppo.make_train_step(None, jnet, jconfig)
    jts2, jmetrics = jax.jit(jstep.update)(
        jts, (_jax_transition(batch), jnp.asarray(adv), jnp.asarray(ret),
              k_update))
    shuffles = [tuple(None if a is None else torch.tensor(np.asarray(a))
                      for a in _jax_shuffle_draws(k, 32, 2, blk))
                for k in jax.random.split(k_update, config.ppo_epochs)]
    net = port_net(params)
    ts = ppo.TrainState(network=net,
                        optimizer=ppo.make_optimizer(config, net.parameters()),
                        env_states=None, generator=torch.Generator(),
                        global_step=0)
    step = ppo.make_train_step(None, config)
    ts2, metrics = step.update(
        ts, ({k: t(v) for k, v in batch.items()}, t(adv), t(ret)), shuffles)
    assert ts2.global_step == 32 and ts2.optimizer.count == 4
    # 1e-5 of the parameters' largest magnitude: Adam divides each entry's
    # step by its own gradient scale, so the float32 rounding of a tiny
    # gradient entry moves that entry's step (measured: 4.8e-8 on a bias
    # entry whose steps are ~3e-4)
    want = flax_leaves(jts2.params)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        close(net.state_dict()[name], w, atol=1e-5 * scale, err_msg=name)
    for k in ppo.AUX_KEYS:
        rel_close(metrics[k], jmetrics[k], 1e-5, k)


# ------------------------------------------------- the flagship, carried
def test_flagship_policy_carried_across():
    import orbax.checkpoint as ocp
    raw = ocp.StandardCheckpointer().restore(FLAGSHIP)
    params = jax.tree.map(np.asarray, raw["params"])
    jnorm = jax_ppo.NormState(**{k: jnp.asarray(v)
                                 for k, v in raw["norm"].items()})
    assert np.asarray(raw["norm"]["env_returns"]).shape == (4096,)
    jnet = jax_networks.ActorCritic(action_size=2, hidden=(64, 64))
    net = port_net(params)
    pnorm = interop.norm_state_from_arrays(raw["norm"], "cpu")
    rng = np.random.default_rng(14)
    obs = (np.asarray(raw["norm"]["obs_mean"])
           + rng.standard_normal((256, OBS))
           * np.sqrt(np.asarray(raw["norm"]["obs_var"])) * 1.5
           ).astype(np.float32)
    want = jax_evaluate.deterministic_policy(jnet, params, norm=jnorm)(
        jnp.asarray(obs))
    got = evaluate.deterministic_policy(net, norm=pnorm)(t(obs))
    close(got, want, atol=1e-5)
    assert float(np.abs(np.asarray(want)).max()) > 0.1   # a trained policy


# ------------------------------------------------ the host-side helpers
def test_episode_stats_match_jax():
    """Mean, std (divided by n), min and max of returns and lengths."""
    rng = np.random.default_rng(15)
    returns = rng.normal(-20.0, 8.0, 37).tolist()
    lengths = rng.integers(1, 1000, 37).tolist()
    got = utils.compute_episode_stats(returns, lengths)
    assert got == jax_utils.compute_episode_stats(returns, lengths)
    assert got["std_return"] == float(np.std(returns, ddof=0))


def test_step_timer_matches_jax(monkeypatch):
    """The rolling env-steps/s counter on one fake clock: 0 at the first
    tick, then steps over the interval, smoothed by the EMA."""
    now = [100.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    got, want = profiler.StepTimer(4096), jax_profiler.StepTimer(4096)
    assert got.tick() == want.tick() == 0.0
    now[0] += 0.5
    assert got.tick() == want.tick() == 4096 / 0.5
    for dt in np.random.default_rng(16).uniform(0.1, 2.0, 10):
        now[0] += float(dt)
        assert got.tick() == want.tick()
