"""Device replay buffer for the off-policy learners (SAC/TD3): the port of
the JAX package's ``rl/replay_buffer.py``.

The buffer is a ring of device tensors.  An insert writes a whole (B, ...)
collection chunk in place; a sample is one batched gather per field, with
nothing read back to the host.  ``ptr`` and ``size`` are host ints: they
follow from the number of inserted rows alone, and ``sample`` needs
``size`` on the host as the bound of its draw.

The ring keeps the JAX buffer's arithmetic, clamp included: an insert
writes through ``dynamic_update_slice``, which clamps its start row to
``capacity - n`` where a chunk would run past the end, while ``ptr`` still
moves to ``(ptr + n) % capacity``.  When ``capacity % n != 0`` the chunk
that wraps overwrites the tail of the one before it, and the first rows
stay stale for one more lap (capacity 40, chunks of 16: the third insert
lands at rows 24-39 and ``ptr`` becomes 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

FIELDS = ("obs", "action", "reward", "next_obs", "terminated")


@dataclasses.dataclass
class ReplayBuffer:
    obs: torch.Tensor         # (capacity, obs_dim)
    action: torch.Tensor      # (capacity, act_dim)
    reward: torch.Tensor      # (capacity,)
    next_obs: torch.Tensor    # (capacity, obs_dim)
    # 1.0 where the transition ended the episode by true termination
    # (timeouts bootstrap, as SB3's handle_timeout_termination does)
    terminated: torch.Tensor  # (capacity,)
    ptr: int = 0              # insert cursor
    size: int = 0             # rows filled

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    def replace(self, **kw) -> "ReplayBuffer":
        return dataclasses.replace(self, **kw)


def make_buffer(capacity: int, obs_dim: int, act_dim: int,
                dtype=torch.float32, device=None) -> ReplayBuffer:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return ReplayBuffer(obs=z(capacity, obs_dim), action=z(capacity, act_dim),
                        reward=z(capacity), next_obs=z(capacity, obs_dim),
                        terminated=z(capacity))


def insert(buf: ReplayBuffer, obs, action, reward, next_obs,
           terminated) -> ReplayBuffer:
    """Write a (B, ...) chunk at the cursor, in place; returns the buffer
    with its cursor and fill moved on.  The start row is clamped to
    ``capacity - B`` as ``jax.lax.dynamic_update_slice`` clamps it."""
    n, capacity = obs.shape[0], buf.capacity
    start = min(buf.ptr, capacity - n)
    rows = slice(start, start + n)
    for name, x in zip(FIELDS, (obs, action, reward, next_obs, terminated)):
        getattr(buf, name)[rows] = x
    return buf.replace(ptr=(buf.ptr + n) % capacity,
                       size=min(buf.size + n, capacity))


def sample(buf: ReplayBuffer, batch_size: int,
           generator: Optional[torch.Generator] = None, idx=None):
    """A uniform sample of ``batch_size`` transitions from the filled rows
    ``[0, max(size, 1))``, as the tuple ``(obs, action, reward, next_obs,
    terminated)``.  ``idx`` (the rows, e.g. another sampler's draws)
    replaces the draw from ``generator``."""
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (batch_size,),
                            generator=generator, device=buf.obs.device)
    else:
        idx = torch.as_tensor(idx, device=buf.obs.device)
    return tuple(getattr(buf, name)[idx] for name in FIELDS)


def state_dict(buf: ReplayBuffer) -> dict:
    return {**{name: getattr(buf, name) for name in FIELDS},
            "ptr": buf.ptr, "size": buf.size}


def load_state_dict(buf: ReplayBuffer, d: dict) -> ReplayBuffer:
    """``buf`` with the rows, cursor and fill of ``d`` (``state_dict``'s
    form), copied into its tensors."""
    for name in FIELDS:
        getattr(buf, name).copy_(d[name])
    return buf.replace(ptr=int(d["ptr"]), size=int(d["size"]))
