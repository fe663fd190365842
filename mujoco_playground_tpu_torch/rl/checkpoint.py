"""Checkpoint/resume with ``torch.save``: the whole train state.

The port of the JAX package's ``rl/checkpoint.py``.  One file per save,
``<dir>/step_{step:010d}.pt``, holds, for PPO, the network's parameters,
the optimizer's state with its schedule count, the env states, the
normalization statistics, and the trainer's and the env's generator
states, so that a resumed run reproduces the straight run.  For SAC and
TD3 (a state with ``MODULES``, ``OPTIMIZERS`` and ``TENSORS``) it holds
the networks and their targets, every optimizer, ``log_alpha``, the
replay buffer with its cursor and fill, the env states, both generators,
the step and TD3's update count (~65 MB at the default buffer of
100,000 rows of 79-wide observations).  The file is a dict of tensors and
plain values (``torch.load(..., weights_only=True)`` reads it).  The step
count comes from the file name: the host's count is authoritative
(``checkpoint_step``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from mujoco_playground_tpu_torch.rl import replay_buffer as rb

_SAVED_THIS_PROCESS = set()
_SUFFIX = ".pt"


def _to_dict(tree):
    """A dataclass tree of tensors as nested dicts (tensors as they are)."""
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    return {f.name: _to_dict(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _from_dict(template, d, device):
    """``template`` with the leaves of ``d`` (on ``device``); leaves absent
    from ``d`` keep the template's values (fields added after the
    checkpoint was written)."""
    if isinstance(template, torch.Tensor):
        return d.to(device) if d is not None else template
    return dataclasses.replace(template, **{
        f.name: _from_dict(getattr(template, f.name), d.get(f.name), device)
        for f in dataclasses.fields(template) if f.name in d})


def _is_offpolicy(ts) -> bool:
    return hasattr(ts, "MODULES")


def _offpolicy_state_dict(st) -> dict:
    d = {name: getattr(st, name).state_dict()
         for name in st.MODULES + st.OPTIMIZERS}
    d.update({name: getattr(st, name).detach() for name in st.TENSORS})
    d.update(buffer=rb.state_dict(st.buffer),
             env_states=_to_dict(st.env_states),
             generator=st.generator.get_state(),
             env_generator=(None if st.env_generator is None
                            else st.env_generator.get_state()),
             global_step=int(st.global_step))
    if hasattr(st, "update_count"):
        d["update_count"] = int(st.update_count)
    return d


def _load_offpolicy(st, d: dict, generators: bool = True):
    for name in st.MODULES + st.OPTIMIZERS:
        getattr(st, name).load_state_dict(d[name])
    with torch.no_grad():
        for name in st.TENSORS:
            getattr(st, name).copy_(d[name])
    if generators:
        st.generator.set_state(d["generator"])
        if st.env_generator is not None and d["env_generator"] is not None:
            st.env_generator.set_state(d["env_generator"])
    kw = {"update_count": int(d["update_count"])} \
        if "update_count" in d else {}
    return st.replace(
        buffer=rb.load_state_dict(st.buffer, d["buffer"]),
        env_states=_from_dict(st.env_states, d["env_states"],
                              st.buffer.obs.device),
        global_step=int(d["global_step"]), **kw)


def state_dict(ts) -> dict:
    """The train state as a dict of tensors and plain values."""
    if _is_offpolicy(ts):
        return _offpolicy_state_dict(ts)
    return {
        "network": ts.network.state_dict(),
        "optimizer": ts.optimizer.state_dict(),
        "env_states": _to_dict(ts.env_states),
        "norm": _to_dict(ts.norm),
        "generator": ts.generator.get_state(),
        "env_generator": (None if ts.env_generator is None
                          else ts.env_generator.get_state()),
        "global_step": int(ts.global_step),
    }


def save_checkpoint(path: str, train_state, step: int) -> str:
    """Save the train state as ``path/step_{step:010d}.pt``; returns the
    file's path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"step_{step:010d}{_SUFFIX}")
    if target in _SAVED_THIS_PROCESS:
        # Idempotent per step WITHIN a run: the end-of-training save can
        # land on the same global_step as the last periodic save.
        return target
    if os.path.exists(target):
        # Leftover from a PREVIOUS run in the same log dir: keeping its
        # stale weights would corrupt a later resume.
        os.remove(target)
    tmp = target + ".tmp"
    torch.save(state_dict(train_state), tmp)
    os.replace(tmp, target)
    _SAVED_THIS_PROCESS.add(target)
    return target


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    entries = sorted(e for e in os.listdir(path)
                     if e.startswith("step_") and e.endswith(_SUFFIX))
    return os.path.join(path, entries[-1]) if entries else None


def checkpoint_step(path: str) -> Optional[int]:
    """Env-step count from a checkpoint's name (``.../step_NNN.pt``; a
    JAX package checkpoint directory ``.../step_NNN`` parses too).  The
    authoritative step counter for resume: the host's count, beyond int32.
    """
    name = os.path.basename(os.path.normpath(path))
    if name.endswith(_SUFFIX):
        name = name[:-len(_SUFFIX)]
    if name.startswith("step_"):
        try:
            return int(name[5:])
        except ValueError:
            return None
    return None


def load_state_dict(ts, d: dict, generators: bool = True):
    """``ts`` with the state of ``d`` (``state_dict``'s form): its network
    and optimizer are loaded in place and, with ``generators``, its
    generators' states are set; returns the train state.  Env-state and
    norm fields absent from ``d`` keep ``ts``'s values."""
    if _is_offpolicy(ts):
        return _load_offpolicy(ts, d, generators)
    device = ts.env_states.obs.device
    ts.network.load_state_dict(d["network"])
    ts.optimizer.load_state_dict(d["optimizer"])
    if generators:
        ts.generator.set_state(d["generator"])
        if ts.env_generator is not None and d["env_generator"] is not None:
            ts.env_generator.set_state(d["env_generator"])
    norm = ts.norm
    if norm is not None and d["norm"] is not None:
        norm = _from_dict(norm, d["norm"], device)
    return ts.replace(
        env_states=_from_dict(ts.env_states, d["env_states"], device),
        norm=norm, global_step=int(d["global_step"]))


def restore_policy(target: str, template):
    """``template`` with the policy of a saved checkpoint: its network, its
    norm statistics (leaves absent from the file keep the template's) and
    its step count.  Reads what an evaluation needs and nothing else, so a
    policy-only file (``interop.ppo_checkpoint_from_flax``) restores too;
    the optimizer, env states and generators stay the template's.  For
    SAC and TD3 it reads the networks the file holds
    (``interop.offpolicy_checkpoint_from_flax`` writes the actor, the
    critics and their targets), ``log_alpha`` and the step, and no
    buffer."""
    d = torch.load(target, map_location="cpu", weights_only=True)
    if _is_offpolicy(template):
        for name in template.MODULES:
            if name in d:
                getattr(template, name).load_state_dict(d[name])
        with torch.no_grad():
            for name in template.TENSORS:
                if name in d:
                    getattr(template, name).copy_(d[name])
        return template.replace(global_step=int(d["global_step"]))
    template.network.load_state_dict(d["network"])
    norm = template.norm
    if norm is not None and d.get("norm") is not None:
        norm = _from_dict(norm, d["norm"], template.env_states.obs.device)
    return template.replace(norm=norm, global_step=int(d["global_step"]))


def restore_checkpoint(target: str, template):
    """Restore a saved train state into ``template`` (a train state of the
    same configuration, e.g. a fresh ``init_train_state``), generators
    included; returns the train state."""
    return load_state_dict(template, torch.load(
        target, map_location="cpu", weights_only=True))
