"""Evaluation harness: the port of the JAX package's ``rl/evaluate.py``.

N episodes run in parallel, one env slot per episode, with no auto-reset:
each slot plays exactly one episode, and masked accumulation stops at its
first ``done``.  Every slot steps ``max_steps`` times (one K1 launch per
step on the card), so the loop reads nothing back until the end.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mujoco_playground_tpu_torch.rl import ppo
from mujoco_playground_tpu_torch.utils import profiler


@torch.no_grad()
def evaluate_agent(env, policy_fn: Callable, num_episodes: int = 10,
                   generator: Optional[torch.Generator] = None,
                   max_steps: Optional[int] = None,
                   core=None) -> Dict[str, float]:
    """policy_fn: obs (B, obs_size) -> action (B, 2) (deterministic).

    The resets draw from ``generator`` (default: a generator on the env's
    device seeded 0), never from the env's own, so that an evaluation
    leaves a training run's stream untouched; ``core`` (a ``reset_core``
    batch of ``num_episodes``, e.g. ``maze_core`` of given draws) replaces
    the draws.  A ``DomainRandomizedEnv`` is bound to its batch: it plays
    one episode per randomized slot."""
    max_steps = max_steps or env.config.max_episode_steps
    if hasattr(env, "num_envs"):
        num_episodes = env.num_envs
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    states = env.reset(num_episodes, generator=generator, core=core)
    dev = states.obs.device
    ret = torch.zeros(num_episodes, dtype=torch.float32, device=dev)
    length = torch.zeros(num_episodes, dtype=torch.int32, device=dev)
    finished = torch.zeros(num_episodes, dtype=torch.bool, device=dev)
    success = torch.zeros(num_episodes, dtype=torch.bool, device=dev)
    for _ in range(max_steps):
        states = env.step_batch(states, policy_fn(states.obs))
        live = ~finished
        ret = ret + states.reward * live
        length = length + live.to(torch.int32)
        success = success | (states.terminated & live)
        finished = finished | states.done
    ret, length = ret.double().cpu(), length.double().cpu()
    success = success.double().cpu()
    return dict(
        mean_return=float(ret.mean()),
        std_return=float(ret.std(correction=0)),
        min_return=float(ret.min()), max_return=float(ret.max()),
        mean_length=float(length.mean()),
        std_length=float(length.std(correction=0)),
        success_rate=float(success.mean()),
    )


def deterministic_policy(network, norm: Optional[ppo.NormState] = None):
    """Greedy (mean) policy, clipped to the action space like the env does.

    ``norm`` applies the same VecNormalize obs scaling the policy trained
    with: pass it for (and ONLY for) policies trained with
    config.normalize_obs.  A reward-only NormState still carries obs
    statistics; feeding scaled obs to a policy trained on raw ones would
    corrupt the eval.  Each call is the span ``rl.policy``.
    """
    @torch.no_grad()
    def policy_fn(obs):
        with profiler.span("rl.policy"):
            if norm is not None:
                obs = ppo.normalize_obs(norm, obs)
            mean, _, _ = network(obs)
            return torch.clamp(mean, -1.0, 1.0)
    return policy_fn


def random_policy(generator: torch.Generator):
    """Uniform random policy in [-1, 1) (the reference's --algo random
    baseline), drawing from ``generator``."""
    def policy_fn(obs):
        return torch.rand(obs.shape[:-1] + (2,), generator=generator,
                          dtype=obs.dtype, device=obs.device) * 2.0 - 1.0
    return policy_fn
