"""Times the Gym vector env's device-to-host copies on one NVIDIA GPU,
three ways, in one process.

    python3 scripts/torch_gym_host_copies.py [--B 16384] [--steps 200]

Builds the kernels, then drives ``GymVectorAckermannEnv`` over the main
path's env (``make_ackermann_env("maze", "umaze", solver_iterations=4,
ls_iterations=3)``) for ``--steps`` steps of uniform random actions from a
seeded numpy generator, with three ways of copying a step's outputs to
the host:

* ``sync``: each output copied by its own ``.cpu().numpy()`` (a
  synchronization and a pageable copy per array);
* ``pinned``: the wrapper's ``to_host`` (every array copied into fresh
  page-locked memory without blocking, one synchronization);
* ``staged``: page-locked staging buffers kept across steps, copied into
  without blocking, one synchronization, then copied into fresh numpy
  arrays.

Each round reseeds the env, so every round runs the same trajectory; a
short run first checks that every way returns the same bits.  The rounds
run in the order A B C C B A, once with the caller keeping every step's
arrays (as ``chip_smoke.py``'s check does) and once dropping them (as a
training loop that consumes them does).  Per round it prints the ms per
step by host clock over steps 20 to the end, the ms per step spent in the
copies (timed after a synchronize, so the step's kernels are outside
them), the MB copied per step and the copies' rate, then one JSON line
with the card's name and power limit.  Exits non-zero without a CUDA
device or when the ways disagree.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mujoco_playground_tpu_torch.envs import gym_wrapper  # noqa: E402
from mujoco_playground_tpu_torch.envs import make_ackermann_env  # noqa: E402
from mujoco_playground_tpu_torch.ops import build  # noqa: E402

WARMUP = 20


def sync_to_host(s):
    """The vector contract's outputs, one ``.cpu()`` per array."""
    def host(x):
        return x.cpu().numpy()
    done = host(s.done)
    info = {"goal_distance": host(s.goal_distance),
            "collision": host(s.collision)}
    if done.any():
        info["final_obs"] = host(s.final_obs)
        info["_final_obs"] = done
    return (host(s.obs), host(s.reward), host(s.terminated),
            host(s.truncated), info)


class Staged:
    """The vector contract's outputs through page-locked staging buffers
    kept across steps: each array copied into its buffer without blocking,
    one synchronization, then copied into a fresh numpy array."""

    def __init__(self):
        self.buffers = {}

    def _stage(self, tensors):
        host = []
        for i, t in enumerate(tensors):
            key = (i, tuple(t.shape), t.dtype)
            if key not in self.buffers:
                self.buffers[key] = torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
            self.buffers[key].copy_(t, non_blocking=True)
            host.append(self.buffers[key])
        torch.cuda.current_stream().synchronize()
        return [h.numpy().copy() for h in host]

    def __call__(self, s):
        obs, reward, term, trunc, done, gd, col = self._stage(
            [s.obs, s.reward, s.terminated, s.truncated, s.done,
             s.goal_distance, s.collision])
        info = {"goal_distance": gd, "collision": col}
        if done.any():
            info["final_obs"] = self._stage([s.final_obs])[0]
            info["_final_obs"] = done
        return obs, reward, term, trunc, info


def run(venv, actions, to_host, keep):
    """One round: (ms per step, copy ms per step, bytes per step, the
    outputs of every step if ``keep``, else of none: a caller that drops
    each step's arrays, as a training loop that consumes them does)."""
    copy_s = [0.0]

    def timed(s):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = to_host(s)
        copy_s[0] += time.perf_counter() - t if timed.on else 0.0
        return out

    timed.on = False
    venv.to_host = timed
    venv.reset(seed=0)
    outs, nbytes = [], 0
    for i, a in enumerate(actions):
        if i == WARMUP:
            timed.on = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = venv.step(a)
        if i >= WARMUP:
            nbytes += sum(x.nbytes for x in list(out[:4])
                          + list(out[4].values())
                          if isinstance(x, np.ndarray))
        if keep:
            outs.append(out)
        del out
    n = len(actions) - WARMUP
    wall = time.perf_counter() - t0
    return wall / n * 1e3, copy_s[0] / n * 1e3, nbytes / n, outs


def same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a[:4], b[:4])) and all(
        np.array_equal(a[4][k], b[4][k]) for k in a[4] if k in b[4]
        and isinstance(a[4][k], np.ndarray))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_gym_host_copies: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build()
    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3)
    venv = gym_wrapper.GymVectorAckermannEnv(args.B, env=env)
    rng = np.random.default_rng(0)
    actions = [rng.uniform(-1.0, 1.0, (args.B, 2)).astype(np.float32)
               for _ in range(args.steps)]
    ways = {"sync": sync_to_host,
            "pinned": gym_wrapper.GymVectorAckermannEnv.to_host,
            "staged": Staged()}
    # the same bits every way, on a short run that keeps its outputs
    check = {name: run(venv, actions[:WARMUP + 10], fn, True)[3]
             for name, fn in ways.items()}
    if not all(same(a, b) for name in ways for a, b in
               zip(check["sync"], check[name])):
        sys.exit("torch_gym_host_copies: the ways disagree")
    del check
    rows = []
    order = list(ways) + list(ways)[::-1]
    for keep in (True, False):
        for name in order:
            ms, copy_ms, nbytes, outs = run(venv, actions, ways[name], keep)
            del outs
            rows.append(dict(way=name, keep=keep, ms_per_step=ms,
                             copy_ms=copy_ms, mb_per_step=nbytes / 1e6,
                             gb_per_s=nbytes / copy_ms / 1e6))
            print(f"{name}, outputs {'kept' if keep else 'dropped'}: "
                  f"{ms:.4f} ms per step, copies {copy_ms:.4f} ms per step "
                  f"({copy_ms / ms:.3f} of it), {nbytes / 1e6:.2f} MB per "
                  f"step at {nbytes / copy_ms / 1e6:.2f} GB/s ({card})")
    print(json.dumps({"B": args.B, "steps": args.steps, "card": card,
                      "rounds": rows}))


if __name__ == "__main__":
    main()
