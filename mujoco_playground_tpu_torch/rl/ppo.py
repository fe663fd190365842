"""PPO as an actor-learner on one device: the port of the JAX package's
``rl/ppo.py``.

One iteration is two phases, as ``make_train_fns`` returns them:

  rollout_gae: T steps of the auto-resetting env (kernel K1 on the card,
               one launch per step), one policy forward per step, then one
               batched forward for the bootstrap values and GAE
  update:      PPO epochs x minibatches over the shuffled T*B slab

Semantics follow SB3 PPO (clipped surrogate, value MSE, entropy bonus,
advantage normalization per minibatch, global-norm grad clip, Adam
eps=1e-5, timeout bootstrapping from the pre-reset observations), with the
JAX package's minibatch shuffle: rows move in blocks of
``config.shuffle_block_size`` after a random roll (``make_epoch_shuffle``;
1 is SB3's per-row reshuffle).

Randomness comes from the train state's ``torch.Generator`` (action noise,
shuffles, the staggered episode steps) and the env's own generator (reset
samples).  Neither phase reads a value of the card back to the host: the
metrics stay tensors until the caller reads them.

With an ``EnvShard`` (``parallel/mesh.py``) the iteration is one rank's
part of a data-parallel run over the global batch ``config.num_envs``:
the rank steps its rows of the batch; every draw is made at the global
batch, as one process makes it, and the rank keeps its rows, so the
generators of all ranks stay in step; the rollout slab is all-gathered
after GAE, so the normalization statistics are those of one process, and
every rank runs one process's update on it (the same shuffles, the same
minibatches), so the parameters stay equal on every rank with no gradient
collective.  Without a shard the run is the whole batch
(``EnvShard(config.num_envs)``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from mujoco_playground_tpu_torch.parallel import mesh
from mujoco_playground_tpu_torch.rl import networks
from mujoco_playground_tpu_torch.rl.config import RLConfig

# the fields of a transition the rollout stores, flattened to (T*B, ...)
TRANSITION_FIELDS = ("obs", "action", "logp", "value", "reward",
                     "terminated", "done")


@dataclasses.dataclass
class NormState:
    """Running statistics for SB3 VecNormalize-equivalent normalization,
    updated once per rollout from the raw T*B slab and applied from the
    *next* rollout on (a one-iteration lag: the statistics stay fixed
    within a rollout)."""
    obs_mean: torch.Tensor      # (obs,)
    obs_var: torch.Tensor       # (obs,)
    ret_mean: torch.Tensor      # ()  (tracked like SB3; normalization
    ret_var: torch.Tensor       # ()   uses the variance only)
    count: torch.Tensor         # ()
    env_returns: torch.Tensor   # (B,) running discounted return per env


def init_norm_state(obs_size: int, num_envs: int, device=None) -> NormState:
    def f(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)
    return NormState(obs_mean=f((obs_size,), 0.0), obs_var=f((obs_size,), 1.0),
                     ret_mean=f((), 0.0), ret_var=f((), 1.0),
                     count=f((), 1e-4), env_returns=f((num_envs,), 0.0))


def normalize_obs(norm: NormState, obs):
    return torch.clamp((obs - norm.obs_mean)
                       / torch.sqrt(norm.obs_var + 1e-8), -10.0, 10.0)


def normalize_reward(norm: NormState, reward):
    return torch.clamp(reward / torch.sqrt(norm.ret_var + 1e-8), -10.0, 10.0)


def _update_rms(mean, var, count, batch_mean, batch_var, batch_count):
    """Chan et al. parallel-variance merge (SB3 RunningMeanStd.update)."""
    delta = batch_mean - mean
    tot = count + batch_count
    new_mean = mean + delta * batch_count / tot
    m_a = var * count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta * delta * count * batch_count / tot
    return new_mean, m2 / tot, tot


def update_norm_state(norm: NormState, obs_slab, rewards, done, gamma
                      ) -> NormState:
    """Fold a (T, B, obs) obs slab + (T, B) rewards into the statistics.
    Variances divide by n, as SB3's (and ``jnp.var``) do."""
    T, B = rewards.shape
    n = float(T * B)
    flat = obs_slab.reshape(T * B, -1).float()
    om, ov, _ = _update_rms(norm.obs_mean, norm.obs_var, norm.count,
                            flat.mean(0), flat.var(0, correction=0), n)
    # SB3 VecNormalize order: accumulate and SAMPLE the terminal step's
    # full discounted return, then zero for the next episode
    ret = norm.env_returns
    rets = []
    for t in range(T):
        ret = ret * gamma + rewards[t].float()
        rets.append(ret)
        ret = ret * (1.0 - done[t].float())
    rets = torch.stack(rets)
    rm, rv, cnt = _update_rms(norm.ret_mean, norm.ret_var, norm.count,
                              rets.mean(), rets.var(correction=0), n)
    return NormState(obs_mean=om, obs_var=ov, ret_mean=rm, ret_var=rv,
                     count=cnt, env_returns=ret)


class PPOOptimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=1e-5))``
    over a module's parameters, with optax's rules:

    * the gradients are scaled by ``max_grad_norm / norm`` only where their
      global norm is not below ``max_grad_norm`` (``clip_grad_norm_`` would
      divide by ``norm + 1e-6`` always);
    * with ``updates_total``, the learning rate of update k (counted from
      0) is ``lr * (1 - k / updates_total)``, 0 from ``updates_total`` on:
      the schedule is read at the count *before* the step.

    ``count`` (the schedule's update count) is part of ``state_dict``."""

    def __init__(self, params, learning_rate: float, max_grad_norm: float,
                 updates_total: Optional[int] = None):
        self.params = [p for p in params]
        self.learning_rate = learning_rate
        self.max_grad_norm = max_grad_norm
        self.updates_total = updates_total
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, eps=1e-5)
        self.count = 0

    def lr_at(self, count: int) -> float:
        if not self.updates_total:
            return self.learning_rate
        frac = 1.0 - min(count, self.updates_total) / self.updates_total
        return self.learning_rate * frac

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def clip_grads(self):
        """Scale the gradients in place by the optax global-norm rule."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_grad_norm,
                            torch.ones_like(norm), self.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)

    def step(self):
        self.clip_grads()
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(config: RLConfig, params) -> PPOOptimizer:
    updates_total = None
    if getattr(config, "anneal_lr", False) and config.total_timesteps:
        updates_total = max(1, (config.total_timesteps
                                // (config.num_envs * config.unroll_length))
                            * config.ppo_epochs * config.num_minibatches)
    return PPOOptimizer(params, config.learning_rate, config.max_grad_norm,
                        updates_total)


@dataclasses.dataclass
class TrainState:
    """Everything a run carries from one iteration to the next.
    ``global_step`` is a host int; ``env_generator`` is the env's reset
    generator, saved with the rest so that a resumed run draws the same
    resets as a straight one."""
    network: networks.ActorCritic
    optimizer: PPOOptimizer
    env_states: object
    generator: torch.Generator
    global_step: int
    norm: Optional[NormState] = None
    env_generator: Optional[torch.Generator] = None

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def init_train_state(env, network: networks.ActorCritic, config: RLConfig,
                     generator: torch.Generator,
                     stagger_resets: bool = True,
                     shard: Optional[mesh.EnvShard] = None) -> TrainState:
    """A fresh train state: the optimizer over ``network`` (already on the
    env's device), a batched reset from the env's generator, and, with
    ``stagger_resets``, each env's step counter drawn from ``generator``
    in [0, max_episode_steps): a freshly reset batch would otherwise
    truncate all envs on the same step forever, leaving most rollouts
    without any episode boundary.  With ``shard`` the env states are the
    rank's rows of those of one process (drawn at the global batch), the
    network's parameters are rank 0's, and the norm statistics keep the
    per-env returns of the whole batch."""
    shard = shard or mesh.EnvShard(config.num_envs)
    env_states = mesh.shard_env(env, shard).reset(config.num_envs)
    mesh.broadcast_(list(network.parameters()), shard)
    device = env_states.obs.device
    if stagger_resets:
        env_states = env_states.replace(steps=shard.take(torch.randint(
            0, env.config.max_episode_steps, (config.num_envs,),
            generator=generator, device=device,
            dtype=env_states.steps.dtype)))
    norm = (init_norm_state(env.obs_size, config.num_envs, device)
            if (config.normalize_obs or config.normalize_reward) else None)
    return TrainState(network=network,
                      optimizer=make_optimizer(config, network.parameters()),
                      env_states=env_states, generator=generator,
                      global_step=0, norm=norm,
                      env_generator=env.generator)


def gae(rewards, values, final_values, terminated, done, gamma, lam):
    """Generalized advantage estimation over the time axis (reverse loop).

    Args are (T, B).  ``final_values`` is V(obs after the step, pre-reset),
    the bootstrap target; ``terminated`` cuts the bootstrap (true
    termination), ``done`` cuts the GAE recursion (either termination or
    truncation).
    """
    adv = torch.zeros_like(values[0])
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        delta = (rewards[t] + gamma * final_values[t] * (1.0 - terminated[t])
                 - values[t])
        adv = delta + gamma * lam * (1.0 - done[t]) * adv
        advs[t] = adv
    return torch.stack(advs)


def make_epoch_shuffle(n: int, mb: int, blk: int,
                       generator: Optional[torch.Generator] = None,
                       device=None, perm=None, shift=None) -> Callable:
    """Per-epoch minibatch shuffle: returns ``take(x)`` mapping an (n, ...)
    slab to its (mb, n//mb, ...) minibatch-major shuffled view.

    With ``blk > 1`` dividing both n and the minibatch size, the slab is
    rolled by a random ``shift`` (re-cutting the block boundaries each
    epoch) and its ``blk``-row blocks are taken in a random order ``perm``;
    otherwise (``blk=1`` is SB3's exact per-row reshuffle) ``perm`` orders
    the rows.  Either path emits every row exactly once.  ``perm`` (and,
    for blocks, ``shift``) replace the draws from ``generator`` (perm
    first, then shift).  One gather per slab; nothing is read back to the
    host."""
    mb_size = n // mb
    if blk > 1 and n % blk == 0 and mb_size % blk == 0:
        nb = n // blk
        if perm is None:
            perm = torch.randperm(nb, generator=generator, device=device)
        if shift is None:
            shift = torch.randint(0, n, (), generator=generator,
                                  device=device)
        rows = (perm[:, None] * blk + torch.arange(blk, device=perm.device))
        # jnp.roll(x, shift)[i] == x[(i - shift) mod n]
        idx = torch.remainder(rows.reshape(-1) - shift, n)
    else:
        if perm is None:
            perm = torch.randperm(n, generator=generator, device=device)
        idx = perm[:mb * mb_size]
    idx = idx.reshape(mb, mb_size)
    return lambda x: x[idx]


def ppo_loss(network, config: RLConfig, batch: Dict[str, torch.Tensor],
             advantages, returns):
    """The PPO loss of one minibatch and its parts (policy_loss,
    value_loss, entropy, approx_kl, clip_frac)."""
    mean, log_std, value = network(batch["obs"])
    logp = networks.gaussian_logp(mean, log_std, batch["action"])
    ratio = torch.exp(logp - batch["logp"])
    if config.normalize_advantage:
        advantages = ((advantages - advantages.mean())
                      / (advantages.std(correction=0) + 1e-8))
    pg1 = advantages * ratio
    pg2 = advantages * torch.clamp(ratio, 1.0 - config.clip_range,
                                   1.0 + config.clip_range)
    policy_loss = -torch.minimum(pg1, pg2).mean()
    value_loss = 0.5 * torch.mean((returns - value) ** 2)
    entropy = networks.gaussian_entropy(log_std).mean()
    total = (policy_loss + config.vf_coef * value_loss
             - config.ent_coef * entropy)
    with torch.no_grad():
        aux = dict(policy_loss=policy_loss.detach(),
                   value_loss=value_loss.detach(), entropy=entropy.detach(),
                   approx_kl=torch.mean(batch["logp"] - logp),
                   clip_frac=torch.mean(
                       (torch.abs(ratio - 1.0)
                        > config.clip_range).float()))
    return total, aux


AUX_KEYS = ("policy_loss", "value_loss", "entropy", "approx_kl", "clip_frac")


def minibatch_step(network, optimizer: PPOOptimizer, config: RLConfig,
                   batch, advantages, returns) -> torch.Tensor:
    """One gradient step on one minibatch; returns the (5,) loss parts of
    ``AUX_KEYS`` (computed before the step)."""
    optimizer.zero_grad()
    loss, aux = ppo_loss(network, config, batch, advantages, returns)
    loss.backward()
    optimizer.step()
    return torch.stack([aux[k] for k in AUX_KEYS])


def make_train_fns(env, config: RLConfig):
    """Returns (rollout_gae, update), the two phases of an iteration."""
    step = make_train_step(env, config)
    return step.rollout_gae, step.update


def make_train_step(env, config: RLConfig,
                    shard: Optional[mesh.EnvShard] = None) -> Callable:
    """Returns ``train_step(ts) -> (ts, metrics)``, one whole iteration.

    The callable also exposes ``.rollout_gae`` and ``.update``, the two
    phases (see make_train_fns).  ``ts`` is updated in place (its network,
    optimizer and norm statistics) and returned.  ``shard``: one rank of a
    data-parallel run (module docstring; ``ts`` from ``init_train_state``
    with the same shard).
    """
    shard = shard or mesh.EnvShard(config.num_envs)
    env = mesh.shard_env(env, shard)
    T, B = config.unroll_length, shard.local_batch
    use_obs_norm = config.normalize_obs
    use_rew_norm = config.normalize_reward

    @torch.no_grad()
    def rollout_gae(ts: TrainState, eps=None, fresh=None):
        """Phase 1: collect T x B transitions + advantages/returns.

        One policy forward per step; V(final_obs) for the GAE bootstrap is
        one batched forward over all T*B pre-reset observations after the
        rollout.  With config.normalize_obs the policy consumes scaled
        observations (statistics fixed for the whole rollout), and the
        transitions store the *scaled* obs so the update recomputes
        identical policy inputs; the statistics are then updated from the
        raw slab.

        ``eps`` ((T, B, action) standard normal draws) replaces the action
        noise from ``ts.generator``; ``fresh`` (a callable ``(t, states)``
        giving a ``reset_core`` batch) replaces the env's reset samples of
        step t.  Returns ``(ts, (batch, advantages, returns), metrics)``,
        the batch a dict of ``TRANSITION_FIELDS`` flattened to (T*B, ...).

        B is the shard's; ``eps`` and ``fresh`` give the rank's rows; the
        returned batch and the metrics are those of the whole slab,
        gathered from every rank (T * num_envs rows).
        """
        net, norm = ts.network, ts.norm
        states = ts.env_states
        cols = {k: [] for k in TRANSITION_FIELDS + ("final_obs", "raw_obs")}
        for t in range(T):
            obs = normalize_obs(norm, states.obs) if use_obs_norm \
                else states.obs
            mean, log_std, value = net(obs)
            # the one-process draw at the global batch, the rank's rows
            step_eps = eps[t] if eps is not None else shard.take(torch.randn(
                (config.num_envs,) + mean.shape[1:], generator=ts.generator,
                dtype=mean.dtype, device=mean.device))
            action, logp = networks.sample_action(mean, log_std,
                                                  eps=step_eps)
            cols["raw_obs"].append(states.obs)
            states = env.step_autoreset_batch(
                states, torch.clamp(action, -1.0, 1.0),
                fresh=None if fresh is None else fresh(t, states))
            for k, v in (("obs", obs), ("action", action), ("logp", logp),
                         ("value", value), ("reward", states.reward),
                         ("terminated", states.terminated.float()),
                         ("done", states.done.float()),
                         ("final_obs", states.final_obs)):
                cols[k].append(v)
        tr = {k: torch.stack(v) for k, v in cols.items()}
        fobs = tr["final_obs"].reshape(T * B, -1)
        if use_obs_norm:
            fobs = normalize_obs(norm, fobs)
        _, _, final_values = net(fobs)
        rewards = (normalize_reward(norm, tr["reward"]) if use_rew_norm
                   else tr["reward"])
        advs = gae(rewards, tr["value"], final_values.reshape(T, B),
                   tr["terminated"], tr["done"], config.gamma,
                   config.gae_lambda)
        rets = advs + tr["value"]
        # every rank's slab, (T, num_envs, ...) in the one-process order
        tr = mesh.all_gather_env(
            {**{k: tr[k] for k in TRANSITION_FIELDS + ("raw_obs",)},
             "adv": advs, "ret": rets}, shard, dim=1)
        advs, rets = tr["adv"], tr["ret"]
        n = T * config.num_envs
        batch = {k: tr[k].reshape((n,) + tr[k].shape[2:])
                 for k in TRANSITION_FIELDS}
        if use_obs_norm or use_rew_norm:
            norm = update_norm_state(norm, tr["raw_obs"], tr["reward"],
                                     tr["done"], config.gamma)
        metrics = dict(episodes_finished=tr["done"].sum(),
                       successes=tr["terminated"].sum(),
                       mean_reward=tr["reward"].mean())
        ts = ts.replace(env_states=states, norm=norm)
        return ts, (batch, advs.reshape(n), rets.reshape(n)), metrics

    def update(ts: TrainState, batch_data, shuffles=None):
        """Phase 2: PPO epochs x minibatches.  ``shuffles`` (one
        ``(perm, shift)`` per epoch, ``shift`` None for a per-row
        shuffle) replaces the shuffle draws from ``ts.generator``.
        Returns ``(ts, metrics)``, the metrics the mean of each loss part
        over all minibatches.  ``batch_data`` is the whole slab, as
        ``rollout_gae`` returns it on every rank, so every rank draws the
        same shuffles and takes the same steps."""
        batch, advs, rets = batch_data
        n = advs.shape[0]
        mb = config.num_minibatches
        blk = max(int(getattr(config, "shuffle_block_size", 1)), 1)
        auxs = []
        for epoch in range(config.ppo_epochs):
            perm, shift = (None, None) if shuffles is None else shuffles[epoch]
            take = make_epoch_shuffle(n, mb, blk, ts.generator, advs.device,
                                      perm, shift)
            sb = {k: take(batch[k]) for k in ("obs", "action", "logp")}
            sa, sr = take(advs), take(rets)
            for i in range(mb):
                auxs.append(minibatch_step(
                    ts.network, ts.optimizer, config,
                    {k: v[i] for k, v in sb.items()}, sa[i], sr[i]))
        means = torch.stack(auxs).mean(0)
        metrics = {k: means[j] for j, k in enumerate(AUX_KEYS)}
        return (ts.replace(global_step=ts.global_step
                           + T * config.num_envs), metrics)

    def train_step(ts: TrainState):
        ts, batch_data, roll_metrics = rollout_gae(ts)
        ts, upd_metrics = update(ts, batch_data)
        return ts, {**roll_metrics, **upd_metrics}

    train_step.rollout_gae = rollout_gae
    train_step.update = update
    return train_step
