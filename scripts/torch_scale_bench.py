"""Data-parallel scaling of the PyTorch port's env throughput: the
counterpart of ``scripts/scale_bench.py``.

Measures env-steps/s of the main path, ``make_ackermann_env("maze",
"umaze", solver_iterations=4, ls_iterations=3)`` stepped by
``step_autoreset_batch`` with uniform random actions (kernel K1 once a
step), at ``--envs-per-gpu`` envs on each rank of the process group:
N ranks step N x envs-per-gpu envs, each rank its own rows (the actions
and resets drawn at the global batch, as one process draws them).  The
rate is N x envs-per-gpu x steps over the slowest rank's time (CUDA
events, after 20 untimed steps: at N=1 the main path's own loop in
``chip_smoke.py``).  Without ``--world-size`` it measures
N=1; the scaling efficiency at N is the N-rank rate over N times the
N=1 rate, from two runs on a machine with N cards.

    python scripts/torch_scale_bench.py --envs-per-gpu 16384 --steps 180
    python scripts/torch_scale_bench.py --envs-per-gpu 16384 \\
        --init-method tcp://127.0.0.1:29500 --world-size 4 --rank 0

Prints one JSON line: the card (``nvidia-smi`` name and power limit), N,
the envs, the rate and the launches of K1 and K2 on this rank.
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mujoco_playground_tpu_torch.device import resolve_device  # noqa: E402
from mujoco_playground_tpu_torch.envs import make_ackermann_env  # noqa: E402
from mujoco_playground_tpu_torch.ops import lidar as k2  # noqa: E402
from mujoco_playground_tpu_torch.ops import step as k1  # noqa: E402
from mujoco_playground_tpu_torch.parallel import mesh  # noqa: E402
from mujoco_playground_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_distributed)


def card_name_and_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


WARMUP = 20     # untimed steps first, as chip_smoke.py's main path


def timed_steps(env, shard, steps: int, gen: torch.Generator):
    """``WARMUP`` + ``steps`` auto-reset steps of the shard's rows with
    uniform random actions drawn at the global batch; returns the seconds
    of the last ``steps`` (CUDA events) and the final states.  At world
    size 1 these are the calls of chip_smoke.py's main path."""
    senv = mesh.shard_env(env, shard)
    B, dev = shard.global_batch, env.device
    states = senv.reset(B)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for i in range(WARMUP + steps):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0.record()
        acts = shard.take(torch.rand((B, 2), generator=gen, device=dev)
                          * 2 - 1)
        states = senv.step_autoreset_batch(states, acts)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / 1e3, states


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--envs-per-gpu", type=int, default=16384)
    p.add_argument("--steps", type=int, default=180)
    p.add_argument("--maze", default="umaze")
    p.add_argument("--init-method", default=None)
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)

    dev = torch.device("cuda", (args.rank or 0)
                       % max(torch.cuda.device_count(), 1))
    resolve_device(dev)             # raises without a card
    torch.cuda.set_device(dev)
    initialize_distributed(args.init_method, args.world_size, args.rank,
                           args.backend, dev)
    n = dist.get_world_size() if dist.is_initialized() else 1
    B = args.envs_per_gpu * n
    shard = mesh.make_mesh(B)
    env = make_ackermann_env("maze", args.maze, solver_iterations=4,
                             ls_iterations=3, device=dev, seed=0)
    k1_0, k2_0 = k1.step_fused.launches, k2.lidar.launches
    s, states = timed_steps(env, shard, args.steps,
                            torch.Generator(device=dev).manual_seed(1))
    seconds = torch.tensor(s, device=dev)
    if dist.is_initialized():
        dist.all_reduce(seconds, op=dist.ReduceOp.MAX)
        dist.destroy_process_group()
    rate = B * args.steps / float(seconds)
    result = {
        "card": card_name_and_limit(), "ranks": n, "envs": B,
        "envs_per_gpu": args.envs_per_gpu, "steps": args.steps,
        "warmup": WARMUP, "env_steps_per_s": rate,
        "launches": {"K1": k1.step_fused.launches - k1_0,
                     "K2": k2.lidar.launches - k2_0},
        "finite": bool(torch.isfinite(states.obs).all()),
    }
    print(json.dumps(result), flush=True)
    if torch.cuda.device_count() < 2:
        print(f"N>=2: not measured; this machine has "
              f"{torch.cuda.device_count()} card(s), and a rate at N>=2 is "
              f"not extrapolated from N=1", flush=True)
    return result


if __name__ == "__main__":
    main()
