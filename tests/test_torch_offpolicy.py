"""The port's off-policy learners (``rl/replay_buffer.py``, ``rl/sac.py``,
``rl/td3.py``) against the JAX package's, on the CPU, fed the same numpy
inputs and JAX's own random draws.

Tolerances (float32):

* the replay buffer against JAX's ``insert`` and ``sample``: bitwise,
  including the clamp of an insert that runs past the end
  (``capacity % B != 0``);
* ``sample_tanh`` given JAX's normal draw: action 1e-6, logp 1e-5 (its
  ``log(1 - a^2)`` term magnifies an ulp of ``a`` near |a| = 1: 8e-6
  measured at a = 0.97);
* SAC's and TD3's ``q_target`` on carried parameters, batch and noise:
  1e-5 relative (JAX's ``test_offpolicy.py`` cases);
* ``alpha_loss``'s gradient against its closed form: 1e-6 relative;
* one whole SAC ``train_step`` and two TD3 ``train_step`` calls on the
  1-step bandit (2 collect + 2 gradient steps each), given JAX's key
  splits replayed as actions, noise and minibatch rows, against JAX's
  jitted ``train_step``: the buffer's observations and flags bitwise, its
  actions and rewards within 1e-6 (the libraries' tanh and exp part by an
  ulp on ~1% of the actions); parameters, targets and
  ``log_alpha`` within 2e-6 absolute (Adam moves a parameter by up to
  ~lr = 3e-3 a step; the two libraries round sums and Adam's arithmetic
  in different orders, 2.4e-7 measured); the metrics 1e-5 relative.

The port alone: the flax-style init (truncated normal, zero biases),
TD3's delayed policy updates, and the bandit learning checks (both
learners' deterministic action within 0.15 of the optimum 0.6).
"""
import dataclasses
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import carry_offpolicy_params, jax_offpolicy_leaves
from mujoco_playground_tpu.rl import replay_buffer as jax_rb
from mujoco_playground_tpu.rl import sac as jax_sac
from mujoco_playground_tpu.rl import td3 as jax_td3
from mujoco_playground_tpu.rl.config import RLConfig as JaxRLConfig
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.rl import replay_buffer as rb
from mujoco_playground_tpu_torch.rl import sac, td3
from mujoco_playground_tpu_torch.rl.config import RLConfig
from mujoco_playground_tpu_torch.rl.networks import lecun_normal_

PARAM_ATOL = 2e-6
BUFFER_ATOL = 1e-6
METRIC_RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ------------------------------------------------------------ replay buffer

def _assert_buffer_equal(pbuf, jbuf, atol=None):
    """Every row bitwise; with ``atol``, the actions and rewards (computed
    by the networks) within it."""
    for name in rb.FIELDS:
        got, want = _np(getattr(pbuf, name)), np.asarray(getattr(jbuf, name))
        if atol is not None and name in ("action", "reward"):
            np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert pbuf.ptr == int(jbuf.ptr) and pbuf.size == int(jbuf.size)


@pytest.mark.parametrize("capacity,chunk,inserts", [(8, 4, 3), (40, 16, 5)])
def test_replay_buffer_matches_jax_bitwise(capacity, chunk, inserts):
    """``test_replay_buffer_ring_semantics``'s case, and capacity 40 with
    chunks of 16: the third insert is clamped to rows 24-39 while the
    cursor moves to 8."""
    rng = np.random.default_rng(capacity)
    jbuf = jax_rb.make_buffer(capacity, 3, 2)
    pbuf = rb.make_buffer(capacity, 3, 2)
    for i in range(inserts):
        obs, nxt = (rng.normal(size=(chunk, 3)).astype(np.float32)
                    for _ in range(2))
        act = rng.uniform(-1, 1, (chunk, 2)).astype(np.float32)
        rew = rng.normal(size=chunk).astype(np.float32)
        term = (rng.uniform(size=chunk) < 0.3).astype(np.float32)
        jbuf = jax_rb.insert(jbuf, *map(jnp.asarray,
                                        (obs, act, rew, nxt, term)))
        pbuf = rb.insert(pbuf, *map(t, (obs, act, rew, nxt, term)))
        _assert_buffer_equal(pbuf, jbuf)
        if capacity == 40 and i == 2:
            assert pbuf.ptr == 8
            np.testing.assert_array_equal(pbuf.obs[24:40].numpy(), obs)


def test_replay_sample_takes_jax_rows():
    rng = np.random.default_rng(1)
    jbuf = jax_rb.make_buffer(40, 3, 2)
    pbuf = rb.make_buffer(40, 3, 2)
    obs = rng.normal(size=(24, 3)).astype(np.float32)
    act = rng.uniform(-1, 1, (24, 2)).astype(np.float32)
    rew = rng.normal(size=24).astype(np.float32)
    term = (rng.uniform(size=24) < 0.3).astype(np.float32)
    jbuf = jax_rb.insert(jbuf, *map(jnp.asarray, (obs, act, rew, obs, term)))
    pbuf = rb.insert(pbuf, *map(t, (obs, act, rew, obs, term)))
    key = jax.random.PRNGKey(5)
    want = jax_rb.sample(jbuf, key, 64)
    idx = jax.random.randint(key, (64,), 0, jnp.maximum(jbuf.size, 1))
    assert int(np.asarray(idx).max()) < 24
    got = rb.sample(pbuf, 64, idx=t(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # drawn rows stay in the filled region
    idx = rb.sample(pbuf, 4096, torch.Generator().manual_seed(0))[2]
    assert set(np.unique(idx.numpy())) <= set(rew.tolist())


# --------------------------------------------------------- numeric oracles

def test_lecun_normal_init_is_flax_default():
    w = torch.empty(512, 256)
    lecun_normal_(w, torch.Generator().manual_seed(0))
    std = math.sqrt(1 / 256) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    np.testing.assert_allclose(float(w.std()), math.sqrt(1 / 256), rtol=0.01)
    actor = sac.TanhGaussianActor(79, 2, (256, 256),
                                  torch.Generator().manual_seed(0))
    assert all(float(b.detach().abs().max()) == 0.0 for n, b in
               actor.named_parameters() if n.endswith("bias"))
    again = sac.TanhGaussianActor(79, 2, (256, 256),
                                  torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(actor.parameters(),
                                                 again.parameters()))


def test_sample_tanh_matches_jax():
    key = jax.random.PRNGKey(3)
    # test_offpolicy.py's case; near |a| = 1 float32 rounds 1 - a^2 so
    # coarsely that the two libraries' tanh part by far more than 1e-5
    mean = np.asarray([[0.3, -1.2], [0.0, 2.0]], np.float32)
    log_std = np.asarray([[-0.5, 0.2], [0.1, -1.0]], np.float32)
    ja, jlogp = jax_sac.sample_tanh(jnp.asarray(mean), jnp.asarray(log_std),
                                    key)
    eps = jax.random.normal(key, mean.shape, jnp.float32)
    pa, plogp = sac.sample_tanh(t(mean), t(log_std), eps=t(eps))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(plogp.numpy(), np.asarray(jlogp), atol=1e-5)


def _jax_nets(obs_size=3, action_size=2, seed=0, deterministic=False):
    actor = (jax_td3.DeterministicActor(action_size=action_size, hidden=(8,))
             if deterministic else
             jax_sac.TanhGaussianActor(action_size=action_size, hidden=(8,)))
    qnet = jax_sac.TwinQ(hidden=(8,))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    ap = actor.init(k1, jnp.zeros(obs_size, jnp.float32))
    qp = qnet.init(k2, jnp.zeros(obs_size, jnp.float32),
                   jnp.zeros(action_size, jnp.float32))
    return actor, qnet, ap, qp


def _port_nets(ap, qp, deterministic=False, obs_size=3, action_size=2):
    cls = td3.DeterministicActor if deterministic else sac.TanhGaussianActor
    actor = cls(obs_size, action_size, (8,))
    actor.load_state_dict(interop.dense_stack_from_flax(ap))
    qnet = sac.TwinQ(obs_size, action_size, (8,))
    qnet.load_state_dict(interop.dense_stack_from_flax(qp))
    return actor, qnet


def _batch(obs_size=3, action_size=2, n=5, seed=1):
    k = jax.random.split(jax.random.PRNGKey(seed), 5)
    f32 = jnp.float32
    return (jax.random.normal(k[0], (n, obs_size), f32),
            jnp.tanh(jax.random.normal(k[1], (n, action_size), f32)),
            jax.random.normal(k[2], (n,), f32),
            jax.random.normal(k[3], (n, obs_size), f32),
            (jax.random.uniform(k[4], (n,)) < 0.4).astype(f32))


def test_sac_q_target_matches_jax():
    actor, qnet, ap, qp = _jax_nets()
    batch = _batch()
    key = jax.random.PRNGKey(7)
    want = jax_sac.q_target(actor, qnet, ap, qp, jnp.float32(0.37), batch,
                            key, 0.93)
    pactor, pq = _port_nets(ap, qp)
    eps = jax.random.normal(key, (5, 2), jnp.float32)
    with torch.no_grad():
        got = sac.q_target(pactor, pq, t(np.float32(0.37)),
                           tuple(map(t, batch)), 0.93, eps=t(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_td3_q_target_matches_jax():
    actor, qnet, ap, qp = _jax_nets(deterministic=True)
    batch = _batch()
    key = jax.random.PRNGKey(9)
    jcfg = JaxRLConfig(gamma=0.95, td3_policy_noise=0.2, td3_noise_clip=0.5)
    want = jax_td3.q_target(actor, qnet, jcfg, ap, qp, batch, key)
    pactor, pq = _port_nets(ap, qp, deterministic=True)
    eps = jax.random.normal(key, (5, 2), jnp.float32)
    cfg = RLConfig(gamma=0.95, td3_policy_noise=0.2, td3_noise_clip=0.5)
    with torch.no_grad():
        got = td3.q_target(pactor, pq, cfg, tuple(map(t, batch)),
                           eps=t(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_sac_alpha_gradient_closed_form():
    logp = torch.tensor([-1.0, -2.5, 0.5])
    log_alpha = torch.tensor(0.11, requires_grad=True)
    sac.alpha_loss(log_alpha, logp, -2.0).backward()
    np.testing.assert_allclose(float(log_alpha.grad),
                               -(float(logp.mean()) - 2.0), rtol=1e-6)


# ------------------------------------------------- bandit: whole train steps

@struct.dataclass
class _JaxBanditState:
    obs: Any
    reward: Any
    final_obs: Any
    terminated: Any


class _JaxBanditEnv:
    """``tests/test_offpolicy.py``'s 1-step continuous bandit: reward
    1 - (a - 0.6)^2, always terminates."""
    obs_size = 1
    action_size = 1

    def reset(self, rng):
        z = jnp.zeros((1,), jnp.float32)
        return _JaxBanditState(obs=z, reward=jnp.zeros((), jnp.float32),
                               final_obs=z,
                               terminated=jnp.zeros((), jnp.float32))

    def step_autoreset_batch(self, states, action):
        r = 1.0 - (action[..., 0] - 0.6) ** 2
        return _JaxBanditState(obs=states.obs, reward=r,
                               final_obs=states.obs,
                               terminated=jnp.ones_like(r))


@dataclasses.dataclass
class _BanditState:
    obs: torch.Tensor
    reward: torch.Tensor
    final_obs: torch.Tensor
    terminated: torch.Tensor


class _BanditEnv:
    """The same bandit for the port."""
    obs_size = 1
    action_size = 1
    device = torch.device("cpu")

    def reset(self, num_envs):
        z = torch.zeros((num_envs, 1))
        return _BanditState(obs=z, reward=torch.zeros(num_envs),
                            final_obs=z, terminated=torch.zeros(num_envs))

    def step_autoreset_batch(self, states, action, fresh=None):
        r = 1.0 - (action[..., 0] - 0.6) ** 2
        return _BanditState(obs=states.obs, reward=r, final_obs=states.obs,
                            terminated=torch.ones_like(r))


def _bandit_kw(**kw):
    base = dict(num_envs=32, sac_buffer_size=4096, sac_batch_size=64,
                sac_learning_rate=3e-3, td3_learning_rate=3e-3, sac_tau=0.05,
                offpolicy_hidden_sizes=(32, 32))
    base.update(kw)
    return base


def _sac_draws(jstate, cfg, collect_steps, grad_steps, size_after):
    """JAX's ``train_step`` draws, its key splits replayed: the collect
    step's normal draws, then each update's rows and two normal draws."""
    B, A, n = cfg.num_envs, 1, cfg.sac_batch_size
    _, k_collect, k_updates = jax.random.split(jstate.rng, 3)
    draws = dict(collect_draws=[jax.random.normal(k, (B, A), jnp.float32)
                                for k in jax.random.split(k_collect,
                                                          collect_steps)],
                 idx=[], eps_target=[], eps_actor=[])
    for key in jax.random.split(k_updates, grad_steps):
        k1, k2, k3 = jax.random.split(key, 3)
        draws["idx"].append(jax.random.randint(
            k1, (n,), 0, jnp.maximum(jnp.int32(size_after), 1)))
        draws["eps_target"].append(jax.random.normal(k2, (n, A), jnp.float32))
        draws["eps_actor"].append(jax.random.normal(k3, (n, A), jnp.float32))
    return {k: t(np.stack([np.asarray(x) for x in v]))
            for k, v in draws.items()}


def _td3_draws(jstate, cfg, collect_steps, grad_steps, size_after):
    B, A, n = cfg.num_envs, 1, cfg.sac_batch_size
    _, k_collect, k_updates = jax.random.split(jstate.rng, 3)
    draws = dict(collect_draws=[jax.random.normal(k, (B, A), jnp.float32)
                                for k in jax.random.split(k_collect,
                                                          collect_steps)],
                 idx=[], eps_target=[])
    for key in jax.random.split(k_updates, grad_steps):
        k1, k2 = jax.random.split(key)
        draws["idx"].append(jax.random.randint(
            k1, (n,), 0, jnp.maximum(jnp.int32(size_after), 1)))
        draws["eps_target"].append(jax.random.normal(k2, (n, A), jnp.float32))
    return {k: t(np.stack([np.asarray(x) for x in v]))
            for k, v in draws.items()}


def _assert_state_matches(pstate, jstate):
    d = interop.offpolicy_checkpoint_from_flax(jax_offpolicy_leaves(jstate))
    for name in pstate.MODULES:
        got = getattr(pstate, name).state_dict()
        for k, v in d[name].items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       atol=PARAM_ATOL, err_msg=f"{name}.{k}")
    for name in pstate.TENSORS:
        np.testing.assert_allclose(_np(getattr(pstate, name)),
                                   d[name].numpy(), atol=PARAM_ATOL)
    assert pstate.global_step == d["global_step"]
    _assert_buffer_equal(pstate.buffer, jstate.buffer, atol=BUFFER_ATOL)


def test_sac_train_step_matches_jax():
    collect_steps = grad_steps = 2
    jcfg, cfg = JaxRLConfig(**_bandit_kw()), RLConfig(**_bandit_kw())
    with jax.enable_x64(False):
        init, make_step = jax_sac.make_sac(_JaxBanditEnv(), jcfg,
                                           collect_steps, grad_steps)
        j0 = init(jax.random.PRNGKey(0))
        j1, jm = jax.jit(make_step(random_actions=False))(j0)
        draws = _sac_draws(j0, jcfg, collect_steps, grad_steps,
                           int(j1.buffer.size))
    pinit, pmake = sac.make_sac(_BanditEnv(), cfg, collect_steps, grad_steps)
    p = pinit()
    carry_offpolicy_params(p, j0)
    p, pm = pmake(random_actions=False)(p, **draws)
    _assert_state_matches(p, j1)
    for k in ("mean_reward", "actor_loss", "alpha"):
        np.testing.assert_allclose(_np(pm[k]), np.asarray(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert pm["buffer_size"] == int(jm["buffer_size"]) == 64


def test_td3_train_steps_match_jax():
    """Two calls with ``td3_policy_delay=2``: policy updates at update
    counts 0 and 2, the actor target moving with them."""
    collect_steps = grad_steps = 2
    kw = _bandit_kw(td3_policy_delay=2)
    jcfg, cfg = JaxRLConfig(**kw), RLConfig(**kw)
    pinit, pmake = td3.make_td3(_BanditEnv(), cfg, collect_steps, grad_steps)
    p = pinit()
    pstep = pmake(random_actions=False)
    with jax.enable_x64(False):
        init, make_step = jax_td3.make_td3(_JaxBanditEnv(), jcfg,
                                           collect_steps, grad_steps)
        j = init(jax.random.PRNGKey(0))
        carry_offpolicy_params(p, j)
        jstep = jax.jit(make_step(random_actions=False))
        for _ in range(2):
            jn, jm = jstep(j)
            draws = _td3_draws(j, jcfg, collect_steps, grad_steps,
                               int(jn.buffer.size))
            p, pm = pstep(p, **draws)
            j = jn
            _assert_state_matches(p, j)
            assert p.update_count == int(j.update_count)
            np.testing.assert_allclose(_np(pm["mean_reward"]),
                                       np.asarray(jm["mean_reward"]),
                                       rtol=METRIC_RTOL)
    assert p.update_count == 4


def test_td3_delayed_policy_updates():
    """The actor and its target move only on every policy_delay-th critic
    update; the critic on every one (JAX's test, on the port)."""
    cfg = RLConfig(num_envs=8, sac_buffer_size=512, sac_batch_size=16,
                   td3_policy_delay=2, offpolicy_hidden_sizes=(32, 32))
    init, make_step = td3.make_td3(_BanditEnv(), cfg, collect_steps=1,
                                   grad_steps=1)
    state = init()
    step = make_step(random_actions=False)

    def flat(m):
        return torch.cat([p.detach().reshape(-1)
                          for p in m.parameters()]).clone()

    a0, q0 = flat(state.actor), flat(state.q)
    state, _ = step(state)       # update_count 0 -> policy update
    a1, at1, q1 = flat(state.actor), flat(state.actor_target), flat(state.q)
    state, _ = step(state)       # update_count 1 -> none
    assert state.update_count == 2
    assert not torch.equal(a1, a0) and not torch.equal(q1, q0)
    assert torch.equal(flat(state.actor), a1)
    assert torch.equal(flat(state.actor_target), at1)
    assert not torch.equal(flat(state.q), q1)


def test_warmup_step_collects_uniform_actions_and_updates():
    """``random_actions=True`` collects uniform actions in [-1, 1) and
    still runs its gradient steps, as the JAX warm-up does."""
    cfg = RLConfig(**_bandit_kw())
    init, make_step = sac.make_sac(_BanditEnv(), cfg, 2, 2)
    state = init()
    q0 = [p.detach().clone() for p in state.q.parameters()]
    state, m = make_step(random_actions=True)(state)
    acts = state.buffer.action[:64, 0]
    assert float(acts.min()) >= -1.0 and float(acts.max()) < 1.0
    assert float(acts.std()) > 0.4       # uniform on [-1, 1): std 0.577
    assert state.buffer.size == 64 and state.global_step == 64
    assert any(not torch.equal(a, b.detach())
               for a, b in zip(q0, state.q.parameters()))


# ------------------------------------------------------- learning checks

def test_sac_learns_bandit_optimum():
    cfg = RLConfig(**_bandit_kw(offpolicy_hidden_sizes=(256, 256)))
    init, make_step = sac.make_sac(_BanditEnv(), cfg, collect_steps=2,
                                   grad_steps=10)
    state = init()
    step = make_step(random_actions=False)
    for _ in range(40):
        state, _ = step(state)
    a = float(sac.deterministic_policy(state)(torch.zeros((1, 1)))[0, 0])
    assert abs(a - 0.6) < 0.15, f"SAC converged to {a}, expected ~0.6"


def test_td3_learns_bandit_optimum():
    cfg = RLConfig(**_bandit_kw(offpolicy_hidden_sizes=(256, 256)))
    init, make_step = td3.make_td3(_BanditEnv(), cfg, collect_steps=2,
                                   grad_steps=10, exploration_noise=0.3)
    state = init()
    step = make_step(random_actions=False)
    for _ in range(100):
        state, _ = step(state)
    a = float(td3.deterministic_policy(state)(torch.zeros((1, 1)))[0, 0])
    assert abs(a - 0.6) < 0.15, f"TD3 converged to {a}, expected ~0.6"
