"""The env-batch layout of a data-parallel run and its collectives: the port
of the JAX package's ``parallel/mesh.py``.

The one axis is the env batch.  Rank r of W holds the contiguous rows
``[r * B / W, (r + 1) * B / W)`` of the global batch of B envs (its
``EnvShard``); the parameters, the optimizer state, the normalization
statistics and the replay buffer are replicated.  Where JAX's GSPMD
inserts the collectives, the trainers call these by hand (``rl/ppo.py``,
``rl/sac.py``, ``rl/td3.py`` with ``shard=``):

* ``all_gather_env``: the rollout slab or a collect chunk from every rank,
  in the one-process env order (one collective for a dict of fields);
  every rank then runs the same update on the same data, so the learners
  need no gradient collective;
* ``broadcast_``: rank 0's parameters at the start.

The trainers step the env through ``shard_env``, which builds only the
rank's rows of each reset.  A shard with no process group
(``EnvShard(global_batch)``, the trainers' default) is the one-process
run; its collectives are the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

Fields = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EnvShard:
    """One rank's part of a global env batch (by default the whole batch
    of a run with no peers)."""
    global_batch: int
    rank: int = 0
    world_size: int = 1
    group: Optional[object] = None   # the process group (None: no peers)

    def __post_init__(self):
        if self.global_batch % self.world_size:
            raise ValueError(f"a batch of {self.global_batch} envs does not "
                             f"split over {self.world_size} ranks")

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.world_size

    @property
    def rows(self) -> slice:
        """This rank's rows of the global batch."""
        return slice(self.rank * self.local_batch,
                     (self.rank + 1) * self.local_batch)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (a view)."""
        if x.shape[0] != self.global_batch:
            raise ValueError(f"{x.shape[0]} rows are not the global batch "
                             f"of {self.global_batch}")
        return x[self.rows]


def make_mesh(global_batch: int) -> EnvShard:
    """This process's shard of ``global_batch`` envs over the whole process
    group once ``initialize_distributed`` ran; without one, the whole
    batch (world size 1, no collectives)."""
    if not dist.is_initialized():
        return EnvShard(global_batch)
    return EnvShard(global_batch, dist.get_rank(), dist.get_world_size(),
                    dist.group.WORLD)


class ShardedEnv:
    """A rank's view of a batched env (``AckermannEnv``): ``reset`` and the
    auto-reset draw their reset samples at the global batch, as one
    process draws them, and build the rank's rows alone
    (``reset_core(..., rows=shard.rows)``), so every rank's env generator
    moves as one process's does.  Everything else is the env's."""

    def __init__(self, env, shard: EnvShard):
        self.env, self.shard = env, shard

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, num_envs: Optional[int] = None, core=None):
        """The rank's rows of a reset of the global batch (``num_envs``,
        the global batch, is the shard's)."""
        if core is None:
            core = self.env.reset_core(self.shard.global_batch,
                                       rows=self.shard.rows)
        return self.env.reset(core=core)

    def step_autoreset_batch(self, states, actions, fresh=None):
        if fresh is None:
            fresh = self.env.reset_core(self.shard.global_batch,
                                        rows=self.shard.rows)
        return self.env.step_autoreset_batch(states, actions, fresh=fresh)


def shard_env(env, shard: EnvShard):
    """``env`` as the trainers step it on ``shard``: the env itself where
    the shard is the whole batch, else its ``ShardedEnv``."""
    return env if shard.world_size == 1 else ShardedEnv(env, shard)


def _pack(fields: Fields, dim: int):
    """The fields side by side as one (shape[:dim + 1], K) tensor."""
    lead = next(iter(fields.values())).shape[:dim + 1]
    flat = [v.reshape(lead + (-1,)) for v in fields.values()]
    return torch.cat(flat, dim=-1), [f.shape[-1] for f in flat]


def all_gather_env(x: Union[torch.Tensor, Fields], shard: EnvShard,
                   dim: int = 0):
    """Every rank's ``x`` joined along the env axis ``dim``, rank 0's rows
    first: a (T, B/W, ...) slab gathered along dim 1 flattens to the
    one-process order ``t * B + b``.  A dict of tensors of one dtype (equal
    in their dims up to ``dim``) goes through one collective."""
    if shard.group is None:
        return x
    if isinstance(x, dict):
        packed, widths = _pack(x, dim)
        out = all_gather_env(packed, shard, dim)
        parts = out.split(widths, dim=-1)
        # contiguous, so that a reduction over a field sums in the order it
        # does over the field of one process
        return {k: p.reshape(p.shape[:dim + 1] + v.shape[dim + 1:])
                .contiguous() for (k, v), p in zip(x.items(), parts)}
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.world_size)]
    dist.all_gather(parts, x, group=shard.group)
    return torch.cat(parts, dim=dim)


def broadcast_(tensors: Sequence[torch.Tensor], shard: EnvShard):
    """Give every rank rank 0's values of the tensors, in place, through one
    flat bucket."""
    if shard.group is None:
        return
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, group=shard.group, group_src=0)
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))


def named_tensors(state) -> dict:
    """The replicated learner tensors of a train state (a dataclass: PPO's
    ``TrainState``, ``SACState``, ``TD3State``) by name
    (``field.parameter``): every module's state dict and every parameter
    outside a module (SAC's ``log_alpha``), in field order.  The tensors
    share their storage with the modules'."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, nn.Module):
            out.update({f"{f.name}.{k}": t
                        for k, t in v.state_dict().items()})
        elif isinstance(v, nn.Parameter):
            out[f.name] = v.detach()
    return out


def shard_env_states(states, shard: EnvShard):
    """This rank's rows of a global batched ``EnvState`` (every leaf has
    the env axis first).  The trainers do not build the global batch: they
    build the rank's rows alone (``shard_env``); this and
    ``shard_train_state`` keep the JAX package's calls."""
    if isinstance(states, torch.Tensor):
        return shard.take(states).clone()
    return dataclasses.replace(states, **{
        f.name: shard_env_states(getattr(states, f.name), shard)
        for f in dataclasses.fields(states)})


def shard_train_state(ts, shard: EnvShard):
    """A train state built for the global batch, made this rank's: its env
    rows kept, the parameters broadcast from rank 0 (everything else, the
    optimizer, the generators, the norm statistics with their per-env
    returns and the replay buffer, is replicated as built)."""
    broadcast_(list(named_tensors(ts).values()), shard)
    return ts.replace(env_states=shard_env_states(ts.env_states, shard))
