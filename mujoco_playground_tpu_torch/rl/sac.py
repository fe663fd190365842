"""SAC on one device: the port of the JAX package's ``rl/sac.py``.

Hyperparameters follow the reference trainer (lr 3e-4, buffer 100k,
learning_starts 1000, batch 256, tau 0.005, gamma 0.99) and the algorithm
SB3's SAC: a squashed-Gaussian policy, twin Q critics with a target copy,
and automatic entropy tuning to a target entropy of -dim(A).

One ``train_step`` collects ``collect_steps`` steps of the auto-resetting
env into the device replay buffer (kernel K1 on the card, one launch per
step), then runs ``grad_steps`` updates on sampled minibatches.  The
networks are initialized as flax's default ``Dense`` (``lecun_normal``
weights, zero biases), drawn on the CPU from ``config.seed``.  Randomness
comes from the state's ``torch.Generator`` (actions, minibatch rows, the
target's and the actor's noise) and the env's own (resets); every draw can
be injected instead, so that tests can feed the JAX package's draws.
Nothing is read back to the host: the metrics stay tensors until the
caller reads them.

With an ``EnvShard`` (``parallel/mesh.py``) the learner is one rank of a
data-parallel run with the JAX package's layout: the env batch is
sharded, the networks and the replay buffer replicated.  The rank steps
its rows of the global batch ``config.num_envs``; its collect draws are
made at the global batch and it keeps its rows; each collect step's chunk
is all-gathered and inserted on every rank in the global env order, so
every rank samples the same rows and the gradient steps, replicated,
need no collective.  Without a shard the run is the whole batch
(``EnvShard(config.num_envs)``).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from mujoco_playground_tpu_torch.parallel import mesh
from mujoco_playground_tpu_torch.rl import replay_buffer as rb
from mujoco_playground_tpu_torch.rl.config import RLConfig
from mujoco_playground_tpu_torch.rl.networks import dense_lecun

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def _relu_tower(module: nn.Module, prefix: str, sizes: Sequence[int],
                generator) -> int:
    """Add ``{prefix}dense_{i}`` layers for ``sizes``; returns the depth."""
    for i in range(len(sizes) - 1):
        module.add_module(f"{prefix}dense_{i}",
                          dense_lecun(sizes[i], sizes[i + 1], generator))
    return len(sizes) - 1


def _run_tower(module: nn.Module, prefix: str, depth: int, x):
    for i in range(depth):
        x = torch.relu(getattr(module, f"{prefix}dense_{i}")(x))
    return x


class TanhGaussianActor(nn.Module):
    """``dense_i`` layers with relu, then the ``mean`` and ``log_std``
    heads; ``forward(obs)`` gives ``(mean, log_std)``, ``log_std`` clipped
    to [LOG_STD_MIN, LOG_STD_MAX]."""

    def __init__(self, obs_size: int, action_size: int = 2,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = tuple(hidden)
        self.depth = _relu_tower(self, "", (obs_size,) + hidden, generator)
        self.mean = dense_lecun(hidden[-1], action_size, generator)
        self.log_std = dense_lecun(hidden[-1], action_size, generator)

    def forward(self, obs):
        x = _run_tower(self, "", self.depth, obs)
        return (self.mean(x),
                torch.clamp(self.log_std(x), LOG_STD_MIN, LOG_STD_MAX))


class TwinQ(nn.Module):
    """Two Q towers on ``cat(obs, action)``: ``q1_dense_i`` ... ``q1_out``
    and ``q2_*``; ``forward(obs, action)`` gives ``(q1, q2)``, each (B,)."""

    def __init__(self, obs_size: int, action_size: int = 2,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = tuple(hidden)
        sizes = (obs_size + action_size,) + hidden
        for name in ("q1", "q2"):
            self.depth = _relu_tower(self, f"{name}_", sizes, generator)
            self.add_module(f"{name}_out",
                            dense_lecun(hidden[-1], 1, generator))

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return tuple(
            getattr(self, f"{name}_out")(
                _run_tower(self, f"{name}_", self.depth, x))[..., 0]
            for name in ("q1", "q2"))


def sample_tanh(mean, log_std, generator: Optional[torch.Generator] = None,
                eps=None):
    """A tanh-squashed Gaussian action and its log-density, with the JAX
    package's change-of-variables term ``log(max(1 - a^2, 1e-6))``.
    ``eps`` (standard normal, shaped like ``mean``) replaces the draw from
    ``generator``."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
    action = torch.tanh(mean + torch.exp(log_std) * eps)
    logp = torch.sum(
        -0.5 * eps**2 - log_std - 0.5 * math.log(2 * math.pi)
        - torch.log(torch.clamp_min(1.0 - action**2, 1e-6)), dim=-1)
    return action, logp


def q_target(actor: TanhGaussianActor, q_target_net: TwinQ, log_alpha,
             batch, gamma: float, generator: Optional[torch.Generator] = None,
             eps=None):
    """SB3 SAC's critic target ``r + gamma (1 - term) (min Q' - alpha log
    pi')`` at the next observations, with the next action drawn from the
    current actor (``eps`` as for ``sample_tanh``)."""
    _, _, reward, next_obs, terminated = batch
    mean, log_std = actor(next_obs)
    next_action, next_logp = sample_tanh(mean, log_std, generator, eps)
    tq1, tq2 = q_target_net(next_obs, next_action)
    return reward + gamma * (1.0 - terminated) * (
        torch.minimum(tq1, tq2) - torch.exp(log_alpha) * next_logp)


def alpha_loss(log_alpha, logp, target_entropy: float):
    """Automatic entropy tuning loss ``-E[log_alpha (log pi + H_target)]``;
    its gradient is ``-(mean(logp) + H_target)``."""
    return -torch.mean(log_alpha * (logp + target_entropy).detach())


def twin_q_loss(qnet: TwinQ, batch, target):
    q1, q2 = qnet(batch[0], batch[1])
    return 0.5 * (torch.mean((q1 - target) ** 2)
                  + torch.mean((q2 - target) ** 2))


@contextlib.contextmanager
def frozen(module: nn.Module):
    """The module's parameters take no gradient inside the block, so a
    loss through it reaches only what feeds it."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield module
    finally:
        for p in params:
            p.requires_grad_(True)


def target_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` that takes no gradient (a target network)."""
    target = copy.deepcopy(module)
    target.requires_grad_(False)
    return target


@torch.no_grad()
def polyak_(target: nn.Module, source: nn.Module, tau: float):
    """``target <- (1 - tau) target + tau source``, parameter by
    parameter, in place."""
    t = list(target.parameters())
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, list(source.parameters()), alpha=tau)


def adam_step(optimizer: torch.optim.Optimizer, loss):
    """One Adam step on ``loss`` (``optax.adam``'s defaults: b1 0.9, b2
    0.999, eps 1e-8, no clipping)."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()


@dataclasses.dataclass
class SACState:
    """Everything a SAC run carries from one iteration to the next.
    ``global_step`` is a host int; ``env_generator`` is the env's reset
    generator, saved with the rest so that a resumed run draws the same
    resets as a straight one."""
    actor: TanhGaussianActor
    q: TwinQ
    q_target: TwinQ
    log_alpha: torch.Tensor     # () parameter
    actor_opt: torch.optim.Adam
    q_opt: torch.optim.Adam
    alpha_opt: torch.optim.Adam
    buffer: rb.ReplayBuffer
    env_states: object
    generator: torch.Generator
    global_step: int = 0
    env_generator: Optional[torch.Generator] = None

    # the checkpoint's parts: modules, optimizers, parameter tensors
    MODULES = ("actor", "q", "q_target")
    OPTIMIZERS = ("actor_opt", "q_opt", "alpha_opt")
    TENSORS = ("log_alpha",)

    def replace(self, **kw) -> "SACState":
        return dataclasses.replace(self, **kw)


def collect_fn(env, config: RLConfig, collect_steps: int, policy: Callable,
               random_actions: bool,
               shard: Optional[mesh.EnvShard] = None) -> Callable:
    """Returns ``collect(state, draws=None, fresh=None) -> (state,
    mean_reward)``: ``collect_steps`` auto-reset env steps, each inserted
    into the buffer as one (B, ...) chunk.  ``policy(state, obs, draw)``
    gives the actions; with ``random_actions`` they are uniform in
    [-1, 1).  ``draws`` ((collect_steps, B, action): the uniform actions,
    or the policy's standard-normal draws) replaces the draws from the
    state's generator, and ``fresh`` (a callable ``(t, states)`` giving a
    ``reset_core`` batch) the env's reset samples of step t.

    ``shard`` (module docstring; default the whole batch; ``env`` then
    as ``mesh.shard_env`` gives it): ``draws`` and ``fresh`` give the
    rank's rows; a drawn action or noise is drawn at
    the global batch and the rank keeps its rows; the chunk inserted, and
    the mean reward, are every rank's, gathered."""
    B, A = config.num_envs, env.action_size
    shard = shard or mesh.EnvShard(B)

    @torch.no_grad()
    def collect(state, draws=None, fresh=None):
        states, buffer = state.env_states, state.buffer
        rewards = []
        for t in range(collect_steps):
            obs = states.obs
            # the one-process draw at the global batch, the rank's rows
            draw = draws[t] if draws is not None else shard.take(
                torch.rand((B, A), generator=state.generator,
                           dtype=obs.dtype, device=obs.device) * 2.0 - 1.0
                if random_actions else
                torch.randn((B, A), generator=state.generator,
                            dtype=obs.dtype, device=obs.device))
            action = draw if random_actions else policy(state, obs, draw)
            states = env.step_autoreset_batch(
                states, action,
                fresh=None if fresh is None else fresh(t, states))
            chunk = mesh.all_gather_env(dict(zip(rb.FIELDS, (
                obs, action, states.reward, states.final_obs,
                states.terminated.to(buffer.reward.dtype)))), shard)
            buffer = rb.insert(buffer, *chunk.values())
            rewards.append(chunk["reward"].mean())
        return (state.replace(env_states=states, buffer=buffer),
                torch.stack(rewards).mean())

    return collect


def make_sac(env, config: RLConfig, collect_steps: int = 4,
             grad_steps: int = 4, shard: Optional[mesh.EnvShard] = None):
    """Returns ``(init, make_train_step)`` for SAC on the vectorized env.

    ``init()`` gives a fresh ``SACState`` (its generator on the env's
    device seeded ``config.seed``); ``make_train_step(random_actions=
    False)`` gives ``train_step(state, ...) -> (state, metrics)``.
    ``shard``: one rank of a data-parallel run (module docstring; default
    the whole batch); its ``init`` takes the parameters from rank 0."""
    hidden = tuple(config.offpolicy_hidden_sizes)
    lr = config.sac_learning_rate
    target_entropy = -float(env.action_size)
    B, batch_size = config.num_envs, config.sac_batch_size
    shard = shard or mesh.EnvShard(B)
    env = mesh.shard_env(env, shard)

    def init() -> SACState:
        dev = env.device
        g = torch.Generator().manual_seed(config.seed)
        actor = TanhGaussianActor(env.obs_size, env.action_size, hidden,
                                  g).to(dev)
        q = TwinQ(env.obs_size, env.action_size, hidden, g).to(dev)
        log_alpha = nn.Parameter(torch.zeros((), device=dev))
        state = SACState(
            actor=actor, q=q, q_target=target_copy(q), log_alpha=log_alpha,
            actor_opt=torch.optim.Adam(actor.parameters(), lr=lr),
            q_opt=torch.optim.Adam(q.parameters(), lr=lr),
            alpha_opt=torch.optim.Adam([log_alpha], lr=lr),
            buffer=rb.make_buffer(config.sac_buffer_size, env.obs_size,
                                  env.action_size, device=dev),
            env_states=env.reset(B),
            generator=torch.Generator(device=dev).manual_seed(config.seed),
            env_generator=getattr(env, "generator", None))
        mesh.broadcast_(list(mesh.named_tensors(state).values()), shard)
        return state

    def policy(state, obs, eps):
        mean, log_std = state.actor(obs)
        return sample_tanh(mean, log_std, state.generator, eps)[0]

    def gradient_step(st: SACState, batch, eps_target=None, eps_actor=None):
        """One update on a sampled ``batch``, in the JAX package's order:
        the Q step (its target from the current actor and alpha, no
        gradient), the actor step against the just-updated Q (frozen), the
        alpha step on the actor loss's detached logp, then the target's
        Polyak average.  Returns the (q, actor, alpha) losses."""
        with torch.no_grad():
            target = q_target(st.actor, st.q_target, st.log_alpha, batch,
                              config.gamma, st.generator, eps_target)
        q_loss = twin_q_loss(st.q, batch, target)
        adam_step(st.q_opt, q_loss)

        mean, log_std = st.actor(batch[0])
        action, logp = sample_tanh(mean, log_std, st.generator, eps_actor)
        with frozen(st.q):
            q1, q2 = st.q(batch[0], action)
        alpha = torch.exp(st.log_alpha.detach())
        actor_loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
        adam_step(st.actor_opt, actor_loss)

        a_loss = alpha_loss(st.log_alpha, logp.detach(), target_entropy)
        adam_step(st.alpha_opt, a_loss)
        polyak_(st.q_target, st.q, config.sac_tau)
        return q_loss.detach(), actor_loss.detach(), a_loss.detach()

    def update(st: SACState, idx=None, eps_target=None, eps_actor=None):
        """``grad_steps`` updates, each on a fresh minibatch; ``idx``
        ((grad_steps, batch) rows), ``eps_target`` and ``eps_actor``
        ((grad_steps, batch, action)) replace the draws.  Returns
        ``(state, mean actor loss)``."""
        losses = []
        for k in range(grad_steps):
            batch = rb.sample(st.buffer, batch_size, st.generator,
                              None if idx is None else idx[k])
            losses.append(gradient_step(
                st, batch, None if eps_target is None else eps_target[k],
                None if eps_actor is None else eps_actor[k])[1])
        return st, torch.stack(losses).mean()

    def make_train_step(random_actions: bool = False) -> Callable:
        collect = collect_fn(env, config, collect_steps, policy,
                             random_actions, shard)

        def train_step(state: SACState, collect_draws=None, fresh=None,
                       idx=None, eps_target=None, eps_actor=None):
            """One iteration: collect, then update (the warm-up's too)."""
            state, mean_reward = collect(state, collect_draws, fresh)
            state, actor_loss = update(state, idx, eps_target, eps_actor)
            state = state.replace(
                global_step=state.global_step + collect_steps * B)
            return state, dict(
                mean_reward=mean_reward, actor_loss=actor_loss,
                alpha=torch.exp(state.log_alpha.detach()),
                buffer_size=state.buffer.size)

        train_step.collect = collect
        train_step.update = update
        train_step.gradient_step = gradient_step
        return train_step

    return init, make_train_step


def actor_hidden_of(actor_state: dict) -> tuple:
    """Tower widths of an actor ``state_dict`` (its ``dense_i`` weights),
    so that a checkpoint of any width evaluates."""
    hs = []
    while f"dense_{len(hs)}.weight" in actor_state:
        hs.append(int(actor_state[f"dense_{len(hs)}.weight"].shape[0]))
    return tuple(hs)


def deterministic_policy(state: SACState):
    """The greedy action ``tanh(mean)``."""
    @torch.no_grad()
    def policy_fn(obs):
        mean, _ = state.actor(obs)
        return torch.tanh(mean)
    return policy_fn
