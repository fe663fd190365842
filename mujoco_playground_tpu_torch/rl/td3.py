"""TD3 on one device: the port of the JAX package's ``rl/td3.py``.

Hyperparameters follow the reference trainer and SB3's TD3: a
deterministic tanh policy with Gaussian exploration noise (0.1, actions
clipped to [-1, 1]), twin Q critics (``sac.TwinQ``), target policy
smoothing (noise 0.2 clipped to +-0.5) and delayed policy updates: the
actor and both targets move only on every ``td3_policy_delay``-th critic
update.  The update count is a host int that carries across
``train_step`` calls and checkpoints.  The iteration, the initialization,
the injected draws and the data-parallel layout (``shard``) are SAC's
(``rl/sac.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from mujoco_playground_tpu_torch.parallel import mesh
from mujoco_playground_tpu_torch.rl import replay_buffer as rb
from mujoco_playground_tpu_torch.rl.config import RLConfig
from mujoco_playground_tpu_torch.rl.networks import dense_lecun
from mujoco_playground_tpu_torch.rl.sac import (TwinQ, _relu_tower,
                                                _run_tower, adam_step,
                                                collect_fn, frozen, polyak_,
                                                target_copy, twin_q_loss)


class DeterministicActor(nn.Module):
    """``dense_i`` layers with relu, then ``out`` through tanh."""

    def __init__(self, obs_size: int, action_size: int = 2,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = tuple(hidden)
        self.depth = _relu_tower(self, "", (obs_size,) + hidden, generator)
        self.out = dense_lecun(hidden[-1], action_size, generator)

    def forward(self, obs):
        return torch.tanh(self.out(_run_tower(self, "", self.depth, obs)))


def q_target(actor_target: DeterministicActor, q_target_net: TwinQ,
             config: RLConfig, batch,
             generator: Optional[torch.Generator] = None, eps=None):
    """SB3 TD3's smoothed critic target ``r + gamma (1 - term) min Q'(s',
    clip(pi'(s') + clip(noise)))``.  ``eps`` (standard normal, shaped like
    the actions; the noise is ``td3_policy_noise * eps``) replaces the draw
    from ``generator``."""
    _, action, reward, next_obs, terminated = batch
    if eps is None:
        eps = torch.randn(action.shape, generator=generator,
                          dtype=action.dtype, device=action.device)
    noise = torch.clamp(config.td3_policy_noise * eps,
                        -config.td3_noise_clip, config.td3_noise_clip)
    next_action = torch.clamp(actor_target(next_obs) + noise, -1.0, 1.0)
    tq1, tq2 = q_target_net(next_obs, next_action)
    return reward + config.gamma * (1.0 - terminated) * torch.minimum(tq1,
                                                                      tq2)


@dataclasses.dataclass
class TD3State:
    """Everything a TD3 run carries from one iteration to the next
    (``SACState``'s layout, with the actor's target and the update
    count)."""
    actor: DeterministicActor
    actor_target: DeterministicActor
    q: TwinQ
    q_target: TwinQ
    actor_opt: torch.optim.Adam
    q_opt: torch.optim.Adam
    buffer: rb.ReplayBuffer
    env_states: object
    generator: torch.Generator
    global_step: int = 0
    update_count: int = 0
    env_generator: Optional[torch.Generator] = None

    MODULES = ("actor", "actor_target", "q", "q_target")
    OPTIMIZERS = ("actor_opt", "q_opt")
    TENSORS = ()

    def replace(self, **kw) -> "TD3State":
        return dataclasses.replace(self, **kw)


def make_td3(env, config: RLConfig, collect_steps: int = 4,
             grad_steps: int = 4, exploration_noise: float = 0.1,
             shard: Optional[mesh.EnvShard] = None):
    """Returns ``(init, make_train_step)`` for TD3, as ``sac.make_sac``.
    ``train_step``'s ``collect_draws`` are the exploration noise's standard
    normal draws (uniform actions in the warm-up) and ``eps_target`` the
    smoothing noise's; TD3 has no ``eps_actor``."""
    hidden = tuple(config.offpolicy_hidden_sizes)
    lr = config.td3_learning_rate
    B, batch_size = config.num_envs, config.sac_batch_size
    shard = shard or mesh.EnvShard(B)
    env = mesh.shard_env(env, shard)

    def init() -> TD3State:
        dev = env.device
        g = torch.Generator().manual_seed(config.seed)
        actor = DeterministicActor(env.obs_size, env.action_size, hidden,
                                   g).to(dev)
        q = TwinQ(env.obs_size, env.action_size, hidden, g).to(dev)
        state = TD3State(
            actor=actor, actor_target=target_copy(actor), q=q,
            q_target=target_copy(q),
            actor_opt=torch.optim.Adam(actor.parameters(), lr=lr),
            q_opt=torch.optim.Adam(q.parameters(), lr=lr),
            buffer=rb.make_buffer(config.sac_buffer_size, env.obs_size,
                                  env.action_size, device=dev),
            env_states=env.reset(B),
            generator=torch.Generator(device=dev).manual_seed(config.seed),
            env_generator=getattr(env, "generator", None))
        mesh.broadcast_(list(mesh.named_tensors(state).values()), shard)
        return state

    def policy(state, obs, eps):
        return torch.clamp(state.actor(obs) + exploration_noise * eps,
                           -1.0, 1.0)

    def gradient_step(st: TD3State, batch, eps_target=None):
        """One update on a sampled ``batch``: the Q step, then, on every
        ``td3_policy_delay``-th update (a host ``if`` on the host count),
        the actor step against the just-updated Q (frozen) and the Polyak
        average of both targets.  Returns ``(state, q loss)``."""
        with torch.no_grad():
            target = q_target(st.actor_target, st.q_target, config, batch,
                              st.generator, eps_target)
        q_loss = twin_q_loss(st.q, batch, target)
        adam_step(st.q_opt, q_loss)
        if st.update_count % config.td3_policy_delay == 0:
            with frozen(st.q):
                q1, _ = st.q(batch[0], st.actor(batch[0]))
            adam_step(st.actor_opt, -torch.mean(q1))
            polyak_(st.actor_target, st.actor, config.sac_tau)
            polyak_(st.q_target, st.q, config.sac_tau)
        return st.replace(update_count=st.update_count + 1), q_loss.detach()

    def update(st: TD3State, idx=None, eps_target=None):
        """``grad_steps`` updates; ``idx`` ((grad_steps, batch) rows) and
        ``eps_target`` ((grad_steps, batch, action)) replace the draws.
        Returns ``(state, mean q loss)``."""
        losses = []
        for k in range(grad_steps):
            batch = rb.sample(st.buffer, batch_size, st.generator,
                              None if idx is None else idx[k])
            st, loss = gradient_step(
                st, batch, None if eps_target is None else eps_target[k])
            losses.append(loss)
        return st, torch.stack(losses).mean()

    def make_train_step(random_actions: bool = False) -> Callable:
        collect = collect_fn(env, config, collect_steps, policy,
                             random_actions, shard)

        def train_step(state: TD3State, collect_draws=None, fresh=None,
                       idx=None, eps_target=None):
            state, mean_reward = collect(state, collect_draws, fresh)
            state, _ = update(state, idx, eps_target)
            state = state.replace(
                global_step=state.global_step + collect_steps * B)
            return state, dict(mean_reward=mean_reward,
                               buffer_size=state.buffer.size)

        train_step.collect = collect
        train_step.update = update
        train_step.gradient_step = gradient_step
        return train_step

    return init, make_train_step


def deterministic_policy(state: TD3State):
    """The actor's action, without exploration noise."""
    @torch.no_grad()
    def policy_fn(obs):
        return state.actor(obs)
    return policy_fn

