"""A/B timings of the data-parallel layer (``mujoco_playground_tpu_torch/
parallel/``) on one card, each pair of runs in alternating order:

* ``iteration``: PPO iterations at the README recipe (4096 envs, 64x64,
  T=32, 10 x 32 minibatches, solver 4/3, running normalization) without a
  process group and as an NCCL group of world size 1 (``make_mesh``):
  seconds per iteration, its rollout and its update (CUDA events); the
  two runs must end bitwise equal;
* ``update``: the PPO update on one gathered slab, two designs: the
  trainers' replicated update (every rank runs one process's update on
  the whole slab; no collective) against a row split with one bucketed
  gradient all-reduce per minibatch (``split_update`` below: each rank's
  loss covers its 1/W of the minibatch's rows, the advantages normalized
  over the whole minibatch first, the gradients and loss parts averaged
  over the ranks before the optimizer step).  In this process as an NCCL
  group of world size 1, and on two gloo ranks sharing the card
  (subprocesses of this script, ``--update-rank``);
* ``bench``: the main path's loop (``chip_smoke.py``: 16384 umaze envs,
  uniform random actions, 180 timed steps after 20) in this process,
  against ``scripts/torch_scale_bench.py`` at N=1 run as a subprocess and
  its ``timed_steps`` in this process.

    python scripts/torch_parallel_ab.py [--pairs 5] [--parts iteration update bench]

Prints the card's name and power limit, then one JSON line per part with
every reading in order.  ``--device cpu`` with small ``--num-envs``,
``--unroll``, ``--minibatches`` and ``--epochs`` rehearses the iteration
and update parts on the CPU (gloo; the bench part needs the card).
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mujoco_playground_tpu_torch.envs import make_ackermann_env  # noqa: E402
from mujoco_playground_tpu_torch.parallel import dryrun, mesh  # noqa: E402
from mujoco_playground_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_distributed)
from mujoco_playground_tpu_torch.rl import networks, ppo  # noqa: E402
from mujoco_playground_tpu_torch.rl import train as train_lib  # noqa: E402
from mujoco_playground_tpu_torch.rl.config import RLConfig  # noqa: E402

BENCH_ENVS = 16384
BENCH_STEPS = 180


def card_name_and_limit(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def recipe(args) -> RLConfig:
    return RLConfig(env_type="maze", maze_id="umaze",
                    num_envs=args.num_envs, unroll_length=args.unroll,
                    num_minibatches=args.minibatches, ppo_epochs=args.epochs,
                    solver_iterations=4, ls_iterations=3,
                    normalize_obs=True, normalize_reward=True, seed=0)


def pair_orders(pairs, a, b):
    """A B, B A, A B, ...: each pair of runs in alternating order."""
    return [(a, b) if k % 2 == 0 else (b, a) for k in range(pairs)]


def summary(readings):
    return {k: {"runs": v, "median": statistics.median(v)}
            for k, v in readings.items()}


# ------------------------------------------------------------- iteration
def iteration_ab(args, dev, card):
    config = recipe(args)
    runs = {}
    for label in ("no group", f"{dist.get_backend().upper()} world size 1"):
        env = train_lib.build_env(config, dev)
        shard = (mesh.make_mesh(config.num_envs) if label != "no group"
                 else None)
        ts = ppo.init_train_state(
            env, train_lib.make_network(config, env), config,
            torch.Generator(device=dev).manual_seed(config.seed),
            shard=shard)
        step = ppo.make_train_step(env, config, shard)
        ts, _ = step(ts)                      # untimed: warms everything
        runs[label] = [ts, step]
    out = {f"{label} {part}": [] for label in runs
           for part in ("s", "rollout_s", "update_s")}
    for order in pair_orders(args.pairs, *runs):
        for label in order:
            ts, step = runs[label]
            sync(dev)
            t0 = time.perf_counter()
            ts, data, _ = step.rollout_gae(ts)
            sync(dev)
            t1 = time.perf_counter()
            ts, _ = step.update(ts, data)
            sync(dev)
            t2 = time.perf_counter()
            runs[label][0] = ts
            out[f"{label} s"].append(t2 - t0)
            out[f"{label} rollout_s"].append(t1 - t0)
            out[f"{label} update_s"].append(t2 - t1)
    a, b = (dryrun.param_sha256(r[0]) for r in runs.values())
    print(json.dumps({"part": "iteration", "card": card,
                      "envs": config.num_envs, "pairs": args.pairs,
                      "bitwise_equal": a == b, **summary(out)}), flush=True)
    if a != b:
        raise SystemExit("iteration: the runs with and without the group "
                         "differ")


# ---------------------------------------------------------------- update
def split_minibatch_step(network, optimizer, config, batch, adv, ret,
                         shard):
    """The row-split design: the rank's 1/W of the minibatch's rows, one
    bucketed all-reduce of the gradients and loss parts."""
    optimizer.zero_grad()
    if config.normalize_advantage:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    per = adv.shape[0] // shard.world_size

    def mine(x):
        return x.narrow(0, shard.rank * per, per)

    loss, aux = ppo.ppo_loss(
        network, dataclasses.replace(config, normalize_advantage=False),
        {k: mine(v) for k, v in batch.items()}, mine(adv), mine(ret))
    loss.backward()
    aux = torch.stack([aux[k] for k in ppo.AUX_KEYS])
    tensors = [p.grad for p in optimizer.params] + [aux]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=shard.group)
    flat.div_(shard.world_size)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])
    optimizer.step()
    return aux


def split_update(ts, data, config, shard):
    batch, advs, rets = data
    n, mb = advs.shape[0], config.num_minibatches
    blk = max(int(config.shuffle_block_size), 1)
    for _ in range(config.ppo_epochs):
        take = ppo.make_epoch_shuffle(n, mb, blk, ts.generator, advs.device)
        sb = {k: take(batch[k]) for k in ("obs", "action", "logp")}
        sa, sr = take(advs), take(rets)
        for i in range(mb):
            split_minibatch_step(ts.network, ts.optimizer, config,
                                 {k: v[i] for k, v in sb.items()}, sa[i],
                                 sr[i], shard)
    return ts


def synthetic_slab(config, obs_size, dev):
    """A slab of the recipe's shapes (T * B rows) from a fixed seed, the
    same on every rank."""
    g = torch.Generator().manual_seed(7)
    n = config.unroll_length * config.num_envs

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    batch = {"obs": randn(n, obs_size), "action": randn(n, 2),
             "logp": randn(n) - 2.0}
    return batch, randn(n) * 2.0 + 0.5, randn(n) * 3.0


def update_ab(args, dev, card, shard):
    config = recipe(args)
    obs_size = make_ackermann_env("maze", "umaze", device="cpu").obs_size
    data = synthetic_slab(config, obs_size, dev)
    replicated = ppo.make_train_step(None, config).update
    states = {}
    for label in ("replicated", "all-reduce"):
        net = networks.ActorCritic(
            obs_size, 2, generator=torch.Generator().manual_seed(0)).to(dev)
        states[label] = ppo.TrainState(
            network=net, optimizer=ppo.make_optimizer(config,
                                                      net.parameters()),
            env_states=None,
            generator=torch.Generator(device=dev).manual_seed(1),
            global_step=0)

    def run(label):
        ts = states[label]
        if label == "replicated":
            return replicated(ts, data)[0]
        return split_update(ts, data, config, shard)

    for label in states:                  # untimed: warms everything
        states[label] = run(label)
    out = {f"{label} {part}": [] for label in states
           for part in ("s", "issue_s")}
    for order in pair_orders(args.pairs, *states):
        for label in order:
            if shard.group is not None:
                dist.barrier(group=shard.group)
            sync(dev)
            t0 = time.perf_counter()
            states[label] = run(label)
            t1 = time.perf_counter()
            sync(dev)
            t2 = time.perf_counter()
            out[f"{label} s"].append(t2 - t0)
            out[f"{label} issue_s"].append(t1 - t0)
    mb = config.ppo_epochs * config.num_minibatches
    print(json.dumps({"part": "update", "card": card,
                      "ranks": shard.world_size, "rank": shard.rank,
                      "backend": dist.get_backend(shard.group),
                      "minibatches": mb, "rows": data[1].shape[0],
                      "pairs": args.pairs, **summary(out)}), flush=True)


def two_gloo_ranks(args, dev):
    """The update A/B on two gloo ranks sharing the card, as subprocesses
    of this script; returns their JSON lines."""
    init = f"tcp://127.0.0.1:{dryrun.free_port()}"
    flags = ["--pairs", str(args.pairs), "--num-envs", str(args.num_envs),
             "--unroll", str(args.unroll), "--minibatches",
             str(args.minibatches), "--epochs", str(args.epochs),
             "--device", dev.type, "--init-method", init]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                              + flags + ["--update-rank", str(r)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=1200)
        if p.returncode != 0:
            raise SystemExit(f"update rank exited {p.returncode}:\n"
                             f"{out[-3000:]}")
        outs.append(out)
    for out in outs:
        print(next(x for x in out.splitlines() if x.startswith("{")),
              flush=True)


# ----------------------------------------------------------------- bench
def bench_ab(args, dev, card):
    spec_path = os.path.join(ROOT, "scripts", "torch_scale_bench.py")
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_scale_bench",
                                                  spec_path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    warm = bench.WARMUP

    def main_path():
        # chip_smoke.py's main-path loop
        states = env.reset(BENCH_ENVS)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        for i in range(warm + BENCH_STEPS):
            if i == warm:
                torch.cuda.synchronize()
                t0.record()
            states = env.step_autoreset_batch(
                states, torch.rand((BENCH_ENVS, 2), generator=gen,
                                   device=dev) * 2 - 1)
        t1.record()
        torch.cuda.synchronize()
        return BENCH_ENVS * BENCH_STEPS / (t0.elapsed_time(t1) / 1e3)

    def in_process():
        s, _ = bench.timed_steps(env, mesh.EnvShard(BENCH_ENVS),
                                 BENCH_STEPS, gen)
        return BENCH_ENVS * BENCH_STEPS / s

    def subprocess_run():
        out = subprocess.run(
            [sys.executable, spec_path, "--envs-per-gpu", str(BENCH_ENVS),
             "--steps", str(BENCH_STEPS)], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
            text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"torch_scale_bench exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
        line = next(x for x in out.stdout.splitlines() if x.startswith("{"))
        return json.loads(line)["env_steps_per_s"]

    runs = {"main path": main_path, "bench in process": in_process,
            "bench subprocess": subprocess_run}
    main_path()                          # untimed: warms the kernels
    out = {k: [] for k in runs}
    for k in range(args.pairs):
        for label in (list(runs) if k % 2 == 0 else list(runs)[::-1]):
            out[label].append(runs[label]())
    print(json.dumps({"part": "bench", "card": card, "envs": BENCH_ENVS,
                      "steps": BENCH_STEPS, "warmup": warm,
                      "unit": "env-steps/s", "pairs": args.pairs,
                      **summary(out)}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=5)
    p.add_argument("--parts", nargs="+",
                   default=["iteration", "update", "bench"],
                   choices=["iteration", "update", "bench"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--unroll", type=int, default=32)
    p.add_argument("--minibatches", type=int, default=32)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--init-method", default=None)
    p.add_argument("--update-rank", type=int, default=None)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu to rehearse)")
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name_and_limit(dev)
    if args.update_rank is not None:      # one gloo rank of the update A/B
        torch.set_num_threads(1)
        initialize_distributed(args.init_method, 2, args.update_rank,
                               backend="gloo", device=dev)
        try:
            update_ab(args, dev, card,
                      mesh.make_mesh(args.num_envs))
        finally:
            dist.destroy_process_group()
        return
    print(f"card: {card}", flush=True)
    if "iteration" in args.parts or "update" in args.parts:
        initialize_distributed(f"tcp://127.0.0.1:{dryrun.free_port()}", 1, 0,
                               device=dev)
        try:
            if "iteration" in args.parts:
                iteration_ab(args, dev, card)
            if "update" in args.parts:
                update_ab(args, dev, card, mesh.make_mesh(args.num_envs))
        finally:
            dist.destroy_process_group()
        if "update" in args.parts:
            two_gloo_ranks(args, dev)
    if "bench" in args.parts and dev.type == "cuda":
        bench_ab(args, dev, card)


if __name__ == "__main__":
    main()
