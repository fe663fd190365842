"""Carry the committed SAC and TD3 policies from the JAX package's Orbax
checkpoints to policy-only checkpoints of the PyTorch port, with the
episodes their EVAL.json was scored on.

    JAX_PLATFORMS=cpu python scripts/torch_convert_offpolicy.py

Restores ``rl_logs/offpolicy/{sac,td3}/params_final`` (the parameters-only
states ``scripts/strip_offpolicy_ckpts.py`` writes: the actor, the
critics, their targets, SAC's ``log_alpha`` and the step) on the CPU with
``orbax.checkpoint``, flattens them to numpy and writes, through
``interop.offpolicy_checkpoint_from_flax``,
``rl_logs/offpolicy/<algo>_torch/step_<step:010d>.pt`` with the step of
``params_final``'s ``global_step``; ``python -m
mujoco_playground_tpu_torch.rl.train --algo <algo> --eval-only --log-dir
rl_logs/offpolicy --maze umaze --progress-reward 3`` reads it.  Beside
them, ``rl_logs/offpolicy/eval_seed0.npz`` holds the 256 episodes of
EVAL.json's protocol (JAX ``evaluate_agent``'s default eval seed 0): each
episode's spawn xy, goal xy and goal cell as the JAX package's
``reset_core`` draws them from ``jax.random.split(PRNGKey(0), 256)`` in
``make_ackermann_env("maze", "umaze", progress_reward_scale=3.0)``, drawn
with x64 off as the evaluation ran; ``AckermannEnv.maze_core`` places the
port's episodes there.  The Orbax directories stay as they are.  This
script needs JAX and Orbax; the port itself reads only what it writes.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from mujoco_playground_tpu_torch import interop  # noqa: E402
from mujoco_playground_tpu_torch.rl.train import ckpt_subdir  # noqa: E402
from torch_convert_solved import eval_draws  # noqa: E402

RUN = os.path.join(ROOT, "rl_logs", "offpolicy")
ALGOS = ("sac", "td3")
EPISODES = 256                # rl_logs/offpolicy/EVAL.json's protocol
PROGRESS_REWARD = 3.0
EVAL_DRAWS = "eval_seed0.npz"


def restore_leaves(algo):
    """The ``params_final`` state of ``algo`` as a dict of numpy leaves."""
    state = ocp.StandardCheckpointer().restore(
        os.path.join(RUN, algo, "params_final"))
    return jax.tree_util.tree_map(np.asarray, state)


def port_path(algo, step):
    return os.path.join(RUN, ckpt_subdir(algo), f"step_{step:010d}.pt")


def main():
    from mujoco_playground_tpu.envs import make_ackermann_env
    for algo in ALGOS:
        leaves = restore_leaves(algo)
        ckpt = interop.offpolicy_checkpoint_from_flax(leaves)
        out = port_path(algo, ckpt["global_step"])
        os.makedirs(os.path.dirname(out), exist_ok=True)
        torch.save(ckpt, out)
        print(f"{algo}: -> {os.path.relpath(out, ROOT)} "
              f"({os.path.getsize(out)} bytes)")
    jenv = make_ackermann_env("maze", "umaze",
                              progress_reward_scale=PROGRESS_REWARD,
                              solver_iterations=4, ls_iterations=3)
    with jax.enable_x64(False):
        draws = eval_draws(jenv, 0.0, EPISODES)
    npz = os.path.join(RUN, EVAL_DRAWS)
    np.savez(npz, **draws)
    print(f"-> {os.path.relpath(npz, ROOT)} ({os.path.getsize(npz)} bytes)")


if __name__ == "__main__":
    main()
