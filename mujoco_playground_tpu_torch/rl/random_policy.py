"""Random-policy baseline: the port of the JAX package's
``rl/random_policy.py``, the "does the env work end to end" check.

Episodes play out in parallel lockstep with auto-reset, in chunks of
``CHUNK_STEPS`` env steps; each chunk's finished returns come back to the
host once, as a (steps, envs) slab with NaN where no episode ended.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

CHUNK_STEPS = 128   # env steps per collection chunk


@torch.no_grad()
def run_random_baseline(env, episodes: int = 1000, num_envs: int = 256,
                        seed: int = 0, log_every: int = 100,
                        verbose: bool = True) -> Dict[str, float]:
    """Play uniform random actions until ``episodes`` episodes have ended;
    returns mean/std/best return over the first ``episodes`` of them.
    Actions draw from a generator seeded ``seed``, resets from the env's
    own.  An episode's return runs on across chunk boundaries."""
    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    states = env.reset(num_envs)
    ep_ret = torch.zeros(num_envs, dtype=torch.float32, device=dev)
    returns = []
    while len(returns) < episodes:
        finished = []
        for _ in range(CHUNK_STEPS):
            acts = torch.rand((num_envs, 2), generator=gen, device=dev) * 2 - 1
            states = env.step_autoreset_batch(states, acts)
            ep_ret = ep_ret + states.reward
            finished.append(torch.where(states.done, ep_ret, torch.nan))
            ep_ret = torch.where(states.done, 0.0, ep_ret)
        vals = torch.stack(finished).cpu().numpy()
        returns.extend(vals[np.isfinite(vals)].tolist())
        if (verbose and len(returns)
                and len(returns) % log_every < CHUNK_STEPS):
            recent = returns[-log_every:]
            print(f"Episodes {len(returns)}: avg return (last "
                  f"{len(recent)}): {np.mean(recent):.2f}")

    returns = np.asarray(returns[:episodes])
    stats = dict(mean_return=float(returns.mean()),
                 std_return=float(returns.std()),
                 best_return=float(returns.max()),
                 episodes=len(returns))
    if verbose:
        print(f"Average return: {stats['mean_return']:.2f} "
              f"± {stats['std_return']:.2f}")
        print(f"Best return: {stats['best_return']:.2f}")
    return stats
