"""The system under test: the port's env and policy, built from a
configuration file.  This is the one module of the harness that imports
``mujoco_playground_tpu_torch``; it takes from the port only the entry
points the window drives (``maze_core``, ``reset``,
``step_autoreset_batch``, the policy's forward) and nothing of its plain
twins."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

CONFIGS = Path(__file__).resolve().parent / "configs"
KERNEL_SOURCES = ("step_kernel.cu", "lidar_kernel.cu")


def build_kernels():
    """nvcc the kernels the window launches (K1, and K2 for the reset's
    scan) into the checkout's ``build/``, or load them from there."""
    from mujoco_playground_tpu_torch.ops import build
    build.build(KERNEL_SOURCES)


def flat(state) -> dict:
    """An ``EnvState`` as the reference's flat dict of leaves."""
    out = {f.name: getattr(state.physics, f.name)
           for f in dataclasses.fields(state.physics)}
    out["ref_position"] = state.odom_ref.position
    out["ref_quat"] = state.odom_ref.quat
    for f in dataclasses.fields(state):
        if f.name not in ("physics", "odom_ref"):
            out[f.name] = getattr(state, f.name)
    return out


class Program:
    """The port's env of one configuration at ``device``, with the
    configuration's policy where it has one."""

    def __init__(self, config: dict, device):
        from mujoco_playground_tpu_torch.envs.make_env import \
            make_ackermann_env
        env_cfg = dict(config["env"])
        maze_id = env_cfg.pop("maze_id")
        self.env = make_ackermann_env("maze", maze_id, device=device,
                                      **env_cfg)
        self.policy = None
        if config.get("policy"):
            self.policy = self._policy(config["policy"])

    def _policy(self, spec: dict):
        from mujoco_playground_tpu_torch.rl import ppo
        from mujoco_playground_tpu_torch.rl.evaluate import \
            deterministic_policy
        from mujoco_playground_tpu_torch.rl.networks import ActorCritic
        d = torch.load(CONFIGS / spec["file"], map_location="cpu",
                       weights_only=True)
        net = ActorCritic(self.env.obs_size, self.env.action_size,
                          hidden=tuple(spec["hidden"]),
                          activation=spec["activation"])
        net.load_state_dict(d["network"])
        net = net.to(self.env.device)
        norm = None
        if spec["normalize"]:
            dev = self.env.device
            n = d["norm"]
            norm = ppo.NormState(
                obs_mean=n["obs_mean"].to(dev), obs_var=n["obs_var"].to(dev),
                ret_mean=n["ret_mean"].to(dev), ret_var=n["ret_var"].to(dev),
                count=n["count"].to(dev),
                env_returns=torch.zeros(1, device=dev))
        return deterministic_policy(net, norm)

    def spawn(self, draws):
        """Fresh states at the benchmark's draws (start xy, goal xy, goal
        cell), without their observation."""
        return self.env.maze_core(*draws)

    def reset(self, draws):
        return self.env.reset(core=self.spawn(draws))

    def act(self, obs):
        return self.policy(obs)

    def step(self, states, actions, fresh):
        return self.env.step_autoreset_batch(states, actions, fresh=fresh)
