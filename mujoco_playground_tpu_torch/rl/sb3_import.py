"""Import Stable-Baselines3 checkpoints (PPO/SAC/TD3) onto the port's
networks (port of the JAX package's ``rl/sb3_import.py``).

The reference trains all three algos through SB3 (src/rl/train.py:108-121)
and ships trained PPO checkpoints (rl_logs/ppo/*.zip — a zip of torch
state_dicts).  These loaders map ``policy.pth``'s weights onto the port's
modules (the architectures match by construction), so reference-trained
policies can be evaluated, and fine-tuned, in the port.  Both files are
read with ``torch.load(weights_only=True)``; SB3 itself is not needed.

SB3 PPO MlpPolicy state_dict keys -> :class:`rl.networks.ActorCritic`:
  mlp_extractor.policy_net.{0,2}.{weight,bias}   -> pi_tower.dense_{0,1}
  mlp_extractor.value_net.{0,2}.{weight,bias}    -> vf_tower.dense_{0,1}
  action_net.{weight,bias}                       -> action_head
  value_net.{weight,bias}                        -> value_head
  log_std                                        -> log_std

SB3 SAC MlpPolicy (sac/policies.py Actor + ContinuousCritic):
  actor.latent_pi.{0,2,...}.{weight,bias}        -> sac.TanhGaussianActor
  actor.mu / actor.log_std                          dense_i / mean / log_std
  critic.qf{0,1}.{0,2,4}.{weight,bias}           -> sac.TwinQ q{1,2}_*
  critic_target.qf{0,1}...                       -> target TwinQ
  (log entropy coefficient lives in pytorch_variables.pth: log_ent_coef)

SB3 TD3 MlpPolicy (td3/policies.py Actor = Sequential(..., Tanh)):
  actor.mu.{0,2,4}.{weight,bias}                 -> td3.DeterministicActor
  actor_target.mu...                                dense_{0,1} / out
  critic{,_target}.qf{0,1}...                    -> td3 TwinQ twins

Torch ``Linear`` weights are (out, in) on both sides: no transpose.  Each
loader returns ``state_dict``s on ``device`` (``None`` = the CUDA card) for
the modules' ``load_state_dict``.
"""
from __future__ import annotations

import io
import zipfile
from typing import Any, Dict

import torch

from mujoco_playground_tpu_torch.device import resolve_device


def _load_policy_state_dict(path: str, member: str = "policy.pth",
                            device=None) -> Dict[str, Any]:
    """A zip member's (or a bare ``.pth`` file's) state_dict on
    ``device``; an empty dict when the zip has no such member."""
    device = resolve_device(device)
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            if member not in zf.namelist():
                return {}
            with zf.open(member) as f:
                buf = io.BytesIO(f.read())
        return torch.load(buf, map_location=device, weights_only=True)
    return torch.load(path, map_location=device, weights_only=True)


def _copy(out: dict, name: str, sd: dict, key: str):
    """``out[name.weight]``, ``out[name.bias]`` from SB3's ``key.*``."""
    out[f"{name}.weight"] = sd[f"{key}.weight"]
    out[f"{name}.bias"] = sd[f"{key}.bias"]


def _seq_layers(out: dict, sd: dict, prefix: str, name: str = "") -> int:
    """SB3 Sequential Linear layers (stride-2 keys skip the activations)
    -> ``{name}dense_0``, ``{name}dense_1``, ...; returns the count."""
    i = 0
    while f"{prefix}.{2 * i}.weight" in sd:
        _copy(out, f"{name}dense_{i}", sd, f"{prefix}.{2 * i}")
        i += 1
    return i


def load_sb3_ppo_params(path: str, device=None) -> Dict[str, Any]:
    """SB3 PPO checkpoint (.zip) -> ``{"params": state_dict}`` for
    :class:`rl.networks.ActorCritic` (the JAX loader's return key)."""
    sd = _load_policy_state_dict(path, device=device)
    out = {}
    _seq_layers(out, sd, "mlp_extractor.policy_net", "pi_tower.")
    _seq_layers(out, sd, "mlp_extractor.value_net", "vf_tower.")
    _copy(out, "action_head", sd, "action_net")
    _copy(out, "value_head", sd, "value_net")
    out["log_std"] = sd["log_std"]
    return {"params": out}


def _twinq(sd: dict, prefix: str) -> dict:
    """SB3 ContinuousCritic (critic.qf0/qf1 Sequentials) -> TwinQ."""
    out = {}
    for qf, ours in (("qf0", "q1"), ("qf1", "q2")):
        n = _seq_layers(out, sd, f"{prefix}.{qf}", f"{ours}_")
        # the last Linear is the Q head, named "{ours}_out" in ours
        for part in ("weight", "bias"):
            out[f"{ours}_out.{part}"] = out.pop(
                f"{ours}_dense_{n - 1}.{part}")
    return out


def _hidden_of(sd: dict, name: str = "") -> tuple:
    n = 0
    while f"{name}dense_{n}.bias" in sd:
        n += 1
    return tuple(int(sd[f"{name}dense_{i}.bias"].shape[0]) for i in range(n))


def load_sb3_sac_params(path: str, device=None) -> Dict[str, Any]:
    """SB3 SAC checkpoint (.zip) -> state_dicts for
    :class:`rl.sac.TanhGaussianActor` / :class:`rl.sac.TwinQ`.

    Returns ``{"actor", "q", "q_target", "log_alpha", "hidden"}`` —
    ``hidden`` is the inferred tower width tuple (SB3 SAC default (256, 256))
    for constructing matching modules; ``log_alpha`` is the trained entropy
    coefficient (a 0-d tensor) if the zip carries one (auto ent_coef), else
    None.
    """
    sd = _load_policy_state_dict(path, device=device)
    actor = {}
    _seq_layers(actor, sd, "actor.latent_pi")
    _copy(actor, "mean", sd, "actor.mu")
    _copy(actor, "log_std", sd, "actor.log_std")
    out = {
        "actor": actor,
        "q": _twinq(sd, "critic"),
        "q_target": _twinq(sd, "critic_target"),
        "hidden": _hidden_of(actor),
        "log_alpha": None,
    }
    pv = _load_policy_state_dict(path, "pytorch_variables.pth", device)
    if "log_ent_coef" in pv:
        out["log_alpha"] = pv["log_ent_coef"].reshape(())
    return out


def load_sb3_td3_params(path: str, device=None) -> Dict[str, Any]:
    """SB3 TD3 checkpoint (.zip) -> state_dicts for
    :class:`rl.td3.DeterministicActor` / :class:`rl.td3.TwinQ` twins.

    Returns ``{"actor", "actor_target", "q", "q_target", "hidden"}``
    (SB3 TD3 default hidden is (400, 300)).
    """
    sd = _load_policy_state_dict(path, device=device)

    def actor(prefix):
        layers = {}
        n = _seq_layers(layers, sd, prefix)
        # the last Sequential Linear is the tanh head, named "out" in ours
        for part in ("weight", "bias"):
            layers[f"out.{part}"] = layers.pop(f"dense_{n - 1}.{part}")
        return layers

    a = actor("actor.mu")
    return {
        "actor": a,
        "actor_target": actor("actor_target.mu"),
        "q": _twinq(sd, "critic"),
        "q_target": _twinq(sd, "critic_target"),
        "hidden": _hidden_of(a),
    }
