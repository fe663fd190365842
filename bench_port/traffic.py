"""The one traffic generator: it reads a traffic file (``traffic/<name>.json``)
and makes, from ``--seed``, everything the window feeds the program.

A traffic file holds:

* ``num_envs``: the lockstep batch;
* ``actions``: ``"uniform"`` (each action uniform in [``low``, ``high``)
  from a seeded generator on the device, bench.py's traffic) or
  ``"policy"`` (the configuration's policy on each step's observation);
* ``spawns``: ``"free_cells"``: every step draws a fresh spawn for each env
  (start and goal cells uniform over the maze's free cells with the goal
  apart from the start, each moved by up to ``cell_noise`` cells), as the
  port's own ``reset_core`` samples; the auto-reset takes it where an
  episode ends;
* ``episode_phase``: ``"uniform"``: each env starts at a step count drawn
  uniformly in [0, ``max_episode_steps``), so episodes end spread over the
  steps, as in a rollout past its first episode, and not all at once.

All draws come from one ``torch.Generator`` on the device seeded with
``--seed``, so the same seed gives the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

ACTION_KINDS = ("uniform", "policy")


class Traffic:
    def __init__(self, spec: dict, env_cfg: dict, free_cells, cell_size,
                 seed: int, device):
        if spec["actions"] not in ACTION_KINDS:
            raise ValueError(f"unknown action kind {spec['actions']!r}")
        if spec["spawns"] != "free_cells" or \
                spec["episode_phase"] != "uniform":
            raise ValueError("unknown spawn or episode-phase kind")
        self.spec, self.B = spec, int(spec["num_envs"])
        self.device = torch.device(device)
        self.free = torch.as_tensor(np.asarray(free_cells),
                                    dtype=torch.float32, device=self.device)
        self.cell_size = float(cell_size)
        self.noise = float(env_cfg["cell_noise"])
        self.max_steps = int(env_cfg["max_episode_steps"])
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed(int(seed))

    def actions(self, obs, policy=None):
        """The step's actions (B, 2)."""
        if self.spec["actions"] == "policy":
            return policy(obs)
        lo, hi = float(self.spec["low"]), float(self.spec["high"])
        return (torch.rand((self.B, 2), generator=self.g, device=self.device)
                * (hi - lo) + lo)

    def spawns(self):
        """(start xy (B, 2), goal xy (B, 2), goal cell (B,) int32)."""
        B, n, g, dev = self.B, self.free.shape[0], self.g, self.device
        gi = torch.randint(0, n, (B,), generator=g, device=dev)
        si = torch.randint(0, n - 1, (B,), generator=g, device=dev)
        si = si + (si >= gi).to(si.dtype)          # uniform over cells != gi
        c = self.noise
        noise = torch.rand((B, 4), generator=g, device=dev) * (2 * c) - c
        return (self.free[si] + noise[:, :2] * self.cell_size,
                self.free[gi] + noise[:, 2:] * self.cell_size,
                gi.to(torch.int32))

    def phases(self):
        """Each env's step count at the start (B,) int32."""
        return torch.randint(0, self.max_steps, (self.B,), generator=self.g,
                             device=self.device, dtype=torch.int32)
