"""Policy/value networks: the reference checkpoint's architecture (the port
of the JAX package's ``rl/networks.py``).

Separate actor and critic towers obs -> 64 -> 64 with tanh, a linear action
head -> 2, a state-independent learned ``log_std`` (2,), and a value head
-> 1.  Initialization matches SB3's MlpPolicy: orthogonal with gain sqrt(2)
on the hidden layers, 0.01 on the action head, 1.0 on the value head,
biases and ``log_std`` zero.  Parameter names follow the flax module tree
(``pi_tower.dense_0``, ..., ``action_head``, ``value_head``, ``log_std``);
``interop.actor_critic_from_flax`` carries flax parameters across.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from mujoco_playground_tpu_torch.utils import profiler

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


def orthogonal_(weight: torch.Tensor, gain: float,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``weight`` (out, in) with a scaled orthogonal matrix drawn from
    ``generator``, as ``torch.nn.init.orthogonal_`` does."""
    rows, cols = weight.shape
    flat = torch.randn((max(rows, cols), min(rows, cols)),
                       generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    with torch.no_grad():
        weight.copy_((gain * q).to(weight.dtype))
    return weight


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Fill ``weight`` (out, in) as flax's default ``Dense`` kernel init,
    ``lecun_normal``, draws it: a normal truncated to +-2 standard
    deviations, scaled to a variance of ``1 / fan_in`` (std
    ``sqrt(1 / fan_in) / 0.8796...``, the truncated unit normal's std
    divided out), drawn from ``generator`` by the inverse CDF."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    u = torch.rand(weight.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    with torch.no_grad():
        weight.copy_((std * z.clamp(-2.0, 2.0)).to(weight.dtype))
    return weight


def dense_lecun(n_in: int, n_out: int,
                generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A ``Linear`` layer initialized as flax's default ``Dense``: a
    ``lecun_normal`` weight and a zero bias (the off-policy learners')."""
    layer = nn.Linear(n_in, n_out)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


def _dense(n_in, n_out, gain, generator):
    layer = nn.Linear(n_in, n_out)
    orthogonal_(layer.weight, gain, generator)
    nn.init.zeros_(layer.bias)
    return layer


class MLPTower(nn.Module):
    """Dense layers ``dense_0, dense_1, ...``, each followed by the
    activation."""

    def __init__(self, in_size: int, features: Sequence[int],
                 activation: str = "tanh",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.depth = len(features)
        sizes = (in_size,) + tuple(features)
        for i in range(self.depth):
            self.add_module(f"dense_{i}", _dense(sizes[i], sizes[i + 1],
                                                 math.sqrt(2.0), generator))

    def forward(self, x):
        act = _ACTIVATIONS[self.activation]
        for i in range(self.depth):
            x = act(getattr(self, f"dense_{i}")(x))
        return x


class ActorCritic(nn.Module):
    """Twin-tower Gaussian actor + value critic (SB3 MlpPolicy layout).

    ``forward(obs)`` gives ``(mean, log_std, value)``: ``log_std`` clipped
    to [LOG_STD_MIN, LOG_STD_MAX] (the stored parameter is not), ``value``
    without its last axis.  The weights are drawn on the CPU from
    ``generator`` (a CPU ``torch.Generator``), so that a run on the card and
    one on the CPU start from the same weights; move the module with
    ``.to(device)``.  The spans ``rl.actor`` and ``rl.critic`` mark the two
    towers with their heads."""

    def __init__(self, obs_size: int, action_size: int = 2,
                 hidden: Sequence[int] = (64, 64), activation: str = "tanh",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = tuple(hidden)
        self.pi_tower = MLPTower(obs_size, hidden, activation, generator)
        self.vf_tower = MLPTower(obs_size, hidden, activation, generator)
        self.action_head = _dense(hidden[-1], action_size, 0.01, generator)
        self.value_head = _dense(hidden[-1], 1, 1.0, generator)
        self.log_std = nn.Parameter(torch.zeros(action_size))

    def forward(self, obs):
        with profiler.span("rl.actor"):
            mean = self.action_head(self.pi_tower(obs))
        with profiler.span("rl.critic"):
            value = self.value_head(self.vf_tower(obs))
        log_std = torch.clamp(self.log_std, LOG_STD_MIN, LOG_STD_MAX)
        return mean, log_std, value[..., 0]


def sample_action(mean, log_std, generator: Optional[torch.Generator] = None,
                  eps=None):
    """A Gaussian action and its log-probability.  ``eps`` (the standard
    normal draws, shaped like ``mean``) replaces the draw from
    ``generator``."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator,
                          dtype=mean.dtype, device=mean.device)
    action = mean + torch.exp(log_std) * eps
    return action, gaussian_logp(mean, log_std, action)


def gaussian_logp(mean, log_std, action):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * math.log(2 * math.pi),
                     dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
