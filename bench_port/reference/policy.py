"""The deterministic policy of a PPO checkpoint: observation normalisation,
the actor tower's dense layers with their activation, the action head, the
clip to the action space.  Plain PyTorch on the checkpoint's tensors."""
from __future__ import annotations

import torch

ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


def load_weights(path, device, dtype=torch.float32):
    """The actor's tensors and the observation statistics of a checkpoint
    file (a ``torch.save`` dict with ``network`` and ``norm``)."""
    d = torch.load(path, map_location="cpu", weights_only=True)
    net = {k: v.to(device=device, dtype=dtype) for k, v in d["network"].items()}
    norm = d.get("norm")
    if norm is not None:
        norm = {k: v.to(device=device, dtype=dtype) for k, v in norm.items()
                if k in ("obs_mean", "obs_var")}
    return net, norm


def action(net: dict, norm, obs, activation="tanh"):
    """The policy's mean action on ``obs`` (B, obs_size), clipped to
    [-1, 1]."""
    x = obs
    if norm is not None:
        x = torch.clamp((x - norm["obs_mean"])
                        / torch.sqrt(norm["obs_var"] + 1e-8), -10.0, 10.0)
    act = ACTIVATIONS[activation]
    i = 0
    while f"pi_tower.dense_{i}.weight" in net:
        x = act(x @ net[f"pi_tower.dense_{i}.weight"].T
                + net[f"pi_tower.dense_{i}.bias"])
        i += 1
    mean = x @ net["action_head.weight"].T + net["action_head.bias"]
    return torch.clamp(mean, -1.0, 1.0)
