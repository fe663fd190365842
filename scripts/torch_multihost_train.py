"""Multi-process data-parallel train steps of the PyTorch port: the
counterpart of ``scripts/multihost_train.py``.

Each process is one rank of a ``torch.distributed`` group.  Every rank
builds the same global initial state from the global seed and steps only
its rows of the env batch (``mujoco_playground_tpu_torch/parallel/``);
the parameters are replicated, the rollout slab (PPO) or each collect
chunk (SAC, TD3) gathered from every rank, and every rank takes the same
gradient steps on it.  Each algo prints
one JSON line with the parameters' hash, which must be equal on every
rank.  Without ``--world-size`` the script is the one-process run (a
shard of the whole batch, no collectives).

Run one process per rank (here two ranks sharing the CPU through gloo):

    python scripts/torch_multihost_train.py --init-method \\
        tcp://127.0.0.1:29500 --world-size 2 --rank 0 --device cpu \\
        --out /tmp/r0.json

``--device`` defaults to the CUDA card (one rank per card through NCCL);
``--backend gloo`` lets several ranks share one card.  ``--algo`` takes
several of ppo, sac and td3, run one after another, each on a fresh env;
SAC and TD3 run at most 256 envs, as the trainer does, after one
iteration of uniform actions.  ``--dump DIR`` saves each algo's
parameters, this rank's env states and (SAC, TD3) the replay buffer's
filled rows after the warm-up and at the end, as
``DIR/<algo>_rank<r>.pt``.
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mujoco_playground_tpu_torch.device import resolve_device  # noqa: E402
from mujoco_playground_tpu_torch.ops import lidar as k2  # noqa: E402
from mujoco_playground_tpu_torch.ops import step as k1  # noqa: E402
from mujoco_playground_tpu_torch.parallel import dryrun, mesh  # noqa: E402
from mujoco_playground_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_distributed)
from mujoco_playground_tpu_torch.rl import replay_buffer as rb  # noqa: E402
from mujoco_playground_tpu_torch.rl.config import RLConfig  # noqa: E402


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-method", default=None,
                    help="rendezvous, e.g. tcp://host:port (omit for one "
                         "process)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--backend", default=None,
                    help="nccl (default on the card) or gloo (default on "
                         "the CPU; lets ranks share a card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--algo", nargs="+", default=["ppo"],
                    choices=dryrun.ALGOS)
    ap.add_argument("--steps", type=int, default=2,
                    help="train steps (iterations) per algo")
    ap.add_argument("--num-envs", type=int, default=16,
                    help="the global env batch")
    ap.add_argument("--unroll", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--solver-iterations", type=int, default=2)
    ap.add_argument("--ls-iterations", type=int, default=2)
    ap.add_argument("--normalize", action="store_true",
                    help="PPO's running obs and reward normalization")
    ap.add_argument("--progress-reward", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the JSON lines here as well")
    ap.add_argument("--dump", default=None, metavar="DIR")
    return ap


def config_of(args) -> RLConfig:
    return RLConfig(env_type="maze", maze_id="umaze",
                    num_envs=args.num_envs, unroll_length=args.unroll,
                    num_minibatches=args.minibatches, ppo_epochs=args.epochs,
                    solver_iterations=args.solver_iterations,
                    ls_iterations=args.ls_iterations,
                    normalize_obs=args.normalize,
                    normalize_reward=args.normalize,
                    progress_reward=args.progress_reward, seed=args.seed)


def env_state_tensors(states, prefix="") -> dict:
    """The leaves of a batched EnvState by dotted name."""
    if isinstance(states, torch.Tensor):
        return {prefix[:-1]: states}
    out = {}
    for f in dataclasses.fields(states):
        out.update(env_state_tensors(getattr(states, f.name),
                                     f"{prefix}{f.name}."))
    return out


def filled_rows(buf) -> dict:
    """A replay buffer's ``state_dict`` cut to its filled rows (copies: a
    saved view would carry its whole storage)."""
    return {k: v[:buf.size].clone() if isinstance(v, torch.Tensor) else v
            for k, v in rb.state_dict(buf).items()}


def main(argv=None) -> list:
    """Runs each algo; returns the JSON results, one per algo."""
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        if device.index is None:     # one rank per card, in turn
            device = torch.device(
                "cuda", (args.rank or 0) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    distributed = initialize_distributed(args.init_method, args.world_size,
                                         args.rank, args.backend, device)
    config = config_of(args)
    results = []
    try:
        for algo in args.algo:
            cfg = dryrun.algo_config(config, algo)
            shard = mesh.make_mesh(cfg.num_envs)
            k1_0, k2_0 = k1.step_fused.launches, k2.lidar.launches
            run = dryrun.train_run(algo, cfg, args.steps, shard, device)
            state = run["state"]
            result = {
                "algo": algo, "distributed": distributed,
                "world_size": shard.world_size, "rank": shard.rank,
                "global_envs": cfg.num_envs,
                "local_envs": int(state.env_states.obs.shape[0]),
                "param_sha256": dryrun.param_sha256(state),
                "mean_reward": float(run["metrics"]["mean_reward"]),
                "global_step": state.global_step,
                "launches": {"K1": k1.step_fused.launches - k1_0,
                             "K2": k2.lidar.launches - k2_0},
                "seconds_per_iteration": run["seconds"],
                "device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
            }
            print(json.dumps(result), flush=True)
            results.append(result)
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                dump = {"params": mesh.named_tensors(state),
                        "env_states": env_state_tensors(state.env_states),
                        "result": result}
                if "warm_buffer" in run:
                    dump["warm_buffer"] = filled_rows(run["warm_buffer"])
                    dump["buffer"] = filled_rows(state.buffer)
                if algo == "ppo" and state.norm is not None:
                    dump["norm"] = dataclasses.asdict(state.norm)
                torch.save(
                    {k: ({n: (t.detach().cpu()
                              if isinstance(t, torch.Tensor) else t)
                          for n, t in v.items()} if k != "result" else v)
                     for k, v in dump.items()},
                    os.path.join(args.dump, f"{algo}_rank{result['rank']}"
                                 ".pt"))
    finally:
        if distributed:
            dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in results))
    return results


if __name__ == "__main__":
    main()
