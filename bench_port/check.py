"""How ``correct`` is decided: the program's outputs against the plain
reference (``reference/``), after the window has closed.

The reference follows the program step by step from the program's own
states: for each sampled window step it takes the program's input states,
the step's actions and the benchmark's spawn draws, computes the step
with the auto-reset, and compares every leaf of the program's output.
The start, which that skips, is checked by itself: the program's reset
states against the reference's reset from the same draws.  In a policy
cell the program's actions are compared with the reference policy on the
program's observation.  The reference runs in blocks of rows.

Numbers compared (each against its limit in the configuration file):

* ``reset_gap``: the start states, every float leaf;
* ``physics_gap``: qpos, qvel, the body frames and the warm start;
* ``env_gap``: the observation, the pre-reset observation, reward, goal,
  goal distance, nearest beam, odometry reference, controls and time;
* ``flags_differ``: env steps whose step count, goal cell or done,
  terminated, truncated or collision flag differ (an exact comparison);
* ``action_gap``: the policy's actions (policy cells).

A float gap is taken per env and leaf, as the largest difference over
the leaf's entries against the reference's largest magnitude there (at
least 1), and the number is the largest over envs, leaves and steps.
"""
from __future__ import annotations

import torch

from .reference import policy as ref_policy
from .reference.env import LEAVES, RefEnv

BLOCK = 65536           # reference rows at a time
PHYSICS_LEAVES = ("qpos", "qvel", "xpos", "xquat", "qacc_warmstart")
DISCRETE_LEAVES = ("steps", "goal_cell", "done", "terminated", "truncated",
                   "collision")
ENV_LEAVES = tuple(k for k in LEAVES
                   if k not in PHYSICS_LEAVES + DISCRETE_LEAVES)
NUMBERS = ("reset_gap", "physics_gap", "env_gap", "flags_differ",
           "action_gap")


def leaf_gap(p, r):
    """(B,) gap of one leaf: max |p - r| over the env's entries over
    max(1, max |r|); equal entries (infinities too) give 0, NaN gives
    inf."""
    B = r.shape[0]
    p = p.to(torch.float64).reshape(B, -1)
    r = r.to(torch.float64).reshape(B, -1)
    d = torch.where(p == r, torch.zeros_like(p), (p - r).abs())
    d = torch.nan_to_num(d, nan=float("inf"))
    scale = torch.clamp_min(torch.nan_to_num(r.abs(), posinf=1.0).amax(1),
                            1.0)
    return d.amax(1) / scale


def gaps(prog: dict, ref: dict, leaves) -> torch.Tensor:
    """(B,) largest gap over ``leaves``."""
    return torch.stack([leaf_gap(prog[k], ref[k]) for k in leaves]).amax(0)


def flags(prog: dict, ref: dict) -> torch.Tensor:
    """(B,) bool: any discrete leaf differs."""
    B = ref["done"].shape[0]
    return torch.stack([(prog[k].reshape(B, -1) != ref[k].reshape(B, -1))
                        .any(1) for k in DISCRETE_LEAVES]).any(0)


def reset_gap(prog: dict, ref: dict) -> torch.Tensor:
    """(B,) gap of start states: every float leaf, and 1 where a discrete
    leaf differs."""
    floats = tuple(k for k in LEAVES if k not in DISCRETE_LEAVES)
    g = gaps(prog, ref, floats)
    return torch.where(flags(prog, ref), torch.ones_like(g), g)


def rows(d: dict, a: int, b: int, device) -> dict:
    """Rows a:b of a dict of batch-first leaves, on ``device``."""
    return {k: v[a:b].to(device) for k, v in d.items()}


class Judge:
    """The reference env and policy of one configuration, and the largest
    reading of each number over the checks made."""

    def __init__(self, config: dict, device, dtype=torch.float32,
                 policy_path=None):
        self.ref = RefEnv(config["env"], device, dtype)
        self.device, self.dtype = torch.device(device), dtype
        self.policy = None
        if config.get("policy"):
            net, norm = ref_policy.load_weights(
                policy_path, self.device, dtype)
            self.policy = (net, norm if config["policy"]["normalize"]
                           else None, config["policy"]["activation"])
        self.clear()

    def clear(self):
        self.readings, self.checked, self.bad = {}, 0, 0

    def _draws(self, draws):
        """Spawn draws (start xy, goal xy, goal cell) on the reference's
        device, the coordinates in its precision."""
        start, goal, cell = (t.to(self.device) for t in draws)
        return start.to(self.dtype), goal.to(self.dtype), cell

    def _note(self, name, value):
        self.readings[name] = max(self.readings.get(name, 0.0), float(value))

    @torch.no_grad()
    def reset_outputs(self, draws, phases) -> dict:
        """The reference's start states from the draws (one block of
        rows), at the program's episode phases."""
        r = self.ref.reset(*self._draws(draws))
        r["steps"] = phases.to(self.device)
        return r

    @torch.no_grad()
    def reset(self, draws, phases, prog: dict):
        """The program's start states against the reference's reset."""
        B = phases.shape[0]
        worst = 0.0
        for a in range(0, B, BLOCK):
            b = min(a + BLOCK, B)
            r = self.reset_outputs([t[a:b] for t in draws], phases[a:b])
            worst = max(worst, float(reset_gap(rows(prog, a, b,
                                                    self.device), r).max()))
        self._note("reset_gap", worst)

    @torch.no_grad()
    def outputs(self, p_in: dict, actions, draws) -> dict:
        """The reference's step from the program's input states (one block
        of rows, already on the reference's device)."""
        p_in = {k: (v.to(self.dtype) if v.is_floating_point() else v)
                for k, v in p_in.items()}
        return self.ref.step_autoreset(p_in, actions.to(self.dtype),
                                       self.ref.spawn(*self._draws(draws)))

    @torch.no_grad()
    def action(self, obs):
        net, norm, activation = self.policy
        return ref_policy.action(net, norm, obs.to(self.dtype), activation)

    def compare(self, p: dict, r: dict, act=None, ref_act=None) -> dict:
        """(B,) readings of one block: physics and env gaps, flags, and
        the action gap where there are actions to compare."""
        out = dict(physics_gap=gaps(p, r, PHYSICS_LEAVES),
                   env_gap=gaps(p, r, ENV_LEAVES), flags_differ=flags(p, r))
        if act is not None:
            ag = (act.to(torch.float64) - ref_act.to(torch.float64)).abs()
            out["action_gap"] = torch.nan_to_num(
                ag, nan=float("inf")).amax(1)
        return out

    def note(self, block: dict, limits: dict):
        """Fold one block's readings into the run's; count its env steps
        that fail a limit."""
        bad = block["flags_differ"].clone()
        for name, v in block.items():
            if name == "flags_differ":
                self.readings[name] = (self.readings.get(name, 0)
                                       + int(v.sum()))
                continue
            self._note(name, v.max())
            bad |= v > limits.get(name, -1.0)
        self.checked += bad.shape[0]
        self.bad += int(bad.sum())

    @torch.no_grad()
    def step(self, prog_in: dict, actions, draws, prog_out: dict,
             limits: dict):
        """One sampled step: the reference from the program's input
        states, compared leaf by leaf with the program's output."""
        B = actions.shape[0]
        for a in range(0, B, BLOCK):
            b = min(a + BLOCK, B)
            p_in = rows(prog_in, a, b, self.device)
            act = actions[a:b].to(self.device)
            r = self.outputs(p_in, act, [t[a:b] for t in draws])
            ref_act = None if self.policy is None else \
                self.action(p_in["obs"])
            self.note(self.compare(rows(prog_out, a, b, self.device), r,
                                   None if self.policy is None else act,
                                   ref_act), limits)

    def verdict(self, limits: dict):
        """(correct, failed env steps, [(number, reading, limit)])."""
        rows_ = []
        ok = True
        for name in NUMBERS:
            if name not in self.readings:
                continue
            lim = limits.get(name)
            val = self.readings[name]
            ok = ok and lim is not None and val <= lim
            rows_.append((name, val, lim))
        return ok, self.bad, rows_
