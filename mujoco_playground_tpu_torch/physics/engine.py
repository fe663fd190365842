"""Batched physics step: the fused gate of the JAX package's
``physics/engine.py`` ``step_batch``.

Every step goes through kernel K1 (``ops/step.py``): on a CUDA device the
kernel, on the CPU its plain twin.  The staged step (per-stage collision,
constraint assembly and the standalone Newton kernel) is not ported yet.
"""
from __future__ import annotations

from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.physics.model import Model
from mujoco_playground_tpu_torch.physics.state import State


def step_batch(model: Model, states: State, with_env: tuple = None,
               env_in=None, with_fresh: tuple = None,
               ws_compare: bool = False):
    """One step of a batch of states (leaves carry a leading env axis).

    ``with_env`` (the env constants, see ``ops.step.env_plain``) fuses the
    lidar, observation and reward: pass ``env_in (B, 5)`` (``(B, 7)`` with
    ``with_fresh``) and the return is ``(states', env_slab (B, rows))``.
    ``ws_compare`` picks the Newton start by primal cost (MuJoCo's
    ``mj_warmstart``); the default starts from the warm start as the fused
    TPU step does.
    """
    B = states.qpos.shape[0]

    def rows(t):
        return t.reshape(B, -1).T.contiguous()

    outs = k1.step_fused(
        model, rows(states.qpos), rows(states.qvel), rows(states.ctrl),
        rows(states.qacc_warmstart),
        env_in=None if env_in is None else rows(env_in),
        env_statics=with_env, fresh_statics=with_fresh,
        ws_compare=ws_compare)
    qpos, qvel, xpos, xquat, qacc = outs[:5]
    new = states.replace(
        qpos=qpos.T, qvel=qvel.T, time=states.time + model.timestep,
        xpos=xpos.T.reshape(B, model.nbody, 3),
        xquat=xquat.T.reshape(B, model.nbody, 4), qacc_warmstart=qacc.T)
    if with_env is not None:
        return new, outs[5].T
    return new
