"""Train steps of PPO, SAC and TD3 with the env batch sharded over the ranks
of a process group: the runner behind ``scripts/torch_multihost_train.py``
and ``dryrun_multigpu``, the counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``.

Every rank builds the same env, networks and generators from the global
seed; with a shard it steps only its rows of the global batch
(``rl/ppo.py``, ``rl/sac.py`` and ``rl/td3.py`` with ``shard=``), and the
replicated parameters must stay bitwise equal on every rank, which
``param_sha256`` lets the caller check.
"""
from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from mujoco_playground_tpu_torch.device import resolve_device
from mujoco_playground_tpu_torch.parallel import mesh
from mujoco_playground_tpu_torch.parallel.distributed import (
    initialize_distributed)
from mujoco_playground_tpu_torch.rl import ppo
from mujoco_playground_tpu_torch.rl import replay_buffer as rb
from mujoco_playground_tpu_torch.rl import sac as sac_lib
from mujoco_playground_tpu_torch.rl import td3 as td3_lib
from mujoco_playground_tpu_torch.rl import train as train_lib
from mujoco_playground_tpu_torch.rl.config import RLConfig

ALGOS = ("ppo", "sac", "td3")


def param_sha256(state) -> str:
    """SHA-256 of the learner's tensors' bytes, in ``mesh.named_tensors``
    order."""
    h = hashlib.sha256()
    for t in mesh.named_tensors(state).values():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def algo_config(config: RLConfig, algo: str) -> RLConfig:
    """The config an algo trains with: SAC and TD3 cap the env batch as the
    trainer does (``rl/train.py::OFFPOLICY_MAX_ENVS``)."""
    if algo == "ppo":
        return config
    return dataclasses.replace(
        config, num_envs=min(config.num_envs, train_lib.OFFPOLICY_MAX_ENVS))


def train_run(algo: str, config: RLConfig, iterations: int,
              shard: Optional[mesh.EnvShard] = None, device=None,
              collect_steps: int = 4, grad_steps: int = 4):
    """``iterations`` train steps of ``algo`` on a fresh env built from
    ``config`` (PPO: ``init_train_state`` then ``make_train_step``; SAC
    and TD3: one iteration with uniform actions first, a warm-up as the
    trainer's).  Returns a dict: ``state``, ``metrics`` of the last
    iteration, ``seconds`` of each iteration (host clock, the device
    synchronized), and for SAC and TD3 ``warm_buffer``, a copy of the
    replay buffer after the warm-up."""
    device = resolve_device(device)
    config = algo_config(config, algo)
    env = train_lib.build_env(config, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {"seconds": []}

    def timed(step, state):
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state)
        sync()
        out["seconds"].append(time.perf_counter() - t0)
        return state, metrics

    if algo == "ppo":
        network = train_lib.make_network(config, env)
        generator = torch.Generator(device=device).manual_seed(config.seed)
        state = ppo.init_train_state(env, network, config, generator,
                                     shard=shard)
        step = ppo.make_train_step(env, config, shard)
        for _ in range(iterations):
            state, metrics = timed(step, state)
    else:
        make = sac_lib.make_sac if algo == "sac" else td3_lib.make_td3
        init, make_step = make(env, config, collect_steps=collect_steps,
                               grad_steps=grad_steps, shard=shard)
        state = init()
        warm_step = make_step(random_actions=True)
        state, metrics = warm_step(state)
        buf = state.buffer
        out["warm_buffer"] = buf.replace(**{
            name: getattr(buf, name).clone() for name in rb.FIELDS})
        step = make_step(random_actions=False)
        for _ in range(iterations):
            state, metrics = timed(step, state)
    out.update(state=state, metrics=metrics)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _same_on_every_rank(digest: str, shard: mesh.EnvShard, device) -> bool:
    mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8,
                        device=device)
    return bool((mesh.all_gather_env(mine[None], shard) == mine).all())


def _dryrun_rank(rank: int, world_size: int, init_method: str, device: str,
                 backend: Optional[str]):
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    initialize_distributed(init_method, world_size, rank, backend, dev)
    try:
        # the JAX dry run's configuration (__graft_entry__.py)
        config = RLConfig(env_type="maze", maze_id="umaze",
                          num_envs=4 * world_size, unroll_length=4,
                          num_minibatches=2, ppo_epochs=2,
                          solver_iterations=2, ls_iterations=2,
                          sac_batch_size=64, sac_buffer_size=4096)
        shard = mesh.make_mesh(config.num_envs)
        for algo in ALGOS:
            run = train_run(algo, config, 1 if algo == "ppo" else 0, shard,
                            dev, collect_steps=2, grad_steps=1)
            state = run["state"]
            local = state.env_states.obs.shape[0]
            if local != config.num_envs // world_size:
                raise RuntimeError(f"{algo}: rank {rank} holds {local} envs, "
                                   f"not {config.num_envs // world_size}")
            digest = param_sha256(state)
            if not _same_on_every_rank(digest, shard, dev):
                raise RuntimeError(f"{algo}: the parameters differ across "
                                   f"the ranks")
            if rank == 0:
                print(f"dryrun_multigpu ok [{algo}]: {world_size} ranks x "
                      f"{local} envs on {device}, mean_reward="
                      f"{float(run['metrics']['mean_reward']):.3f}, "
                      f"param_sha256 {digest[:16]}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multigpu(world_size: int, device=None,
                    backend: Optional[str] = None,
                    timeout_s: float = 600.0) -> None:
    """One PPO, one SAC and one TD3 train step (SAC and TD3 collecting with
    uniform actions, as the JAX dry run does) over ``world_size`` ranks,
    one process each, with the env batch sharded: each rank must hold
    B / W envs and the parameters' hash must be equal on every rank.
    Ranks take the cards in turn (``cuda:rank % count``); ``backend``
    ``"gloo"`` lets several ranks share one card.  Raises if a rank
    fails."""
    dev = resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_dryrun_rank,
                         args=(r, world_size, init_method, dev.type, backend))
             for r in range(world_size)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if failed:
        raise RuntimeError(f"dryrun_multigpu: ranks {failed} failed")
