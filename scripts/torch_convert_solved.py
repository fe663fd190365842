"""Carry the committed solved PPO policies from the JAX package's Orbax
checkpoints to policy-only checkpoints of the PyTorch port, with the
episodes their EVAL.json was scored on.

    JAX_PLATFORMS=cpu python scripts/torch_convert_solved.py

Restores each checkpoint on the CPU with ``orbax.checkpoint``, flattens
its ``params`` and ``norm`` to numpy and writes, through
``interop.ppo_checkpoint_from_flax``, the port's checkpoint at
``<run>/ppo_torch/step_<step:010d>.pt`` (``ppo_torch`` is the port
trainer's checkpoint directory), which ``python -m
mujoco_playground_tpu_torch.rl.train --eval-only --log-dir <run> ...``
reads.  Beside it, ``eval_seed0.npz`` holds the 512 episodes of EVAL.json's
protocol (eval seed 0): each episode's spawn xy, goal xy and goal cell as
the JAX package's ``reset_core`` draws them from
``jax.random.split(PRNGKey(0), 512)``, the spawn yaw under the run's
heading noise, and (``solved``) the 512 actions of EVAL.json's random
baseline, one uniform draw from ``PRNGKey(123)`` that it holds on every
step (``scripts/solved_eval.py``).  ``AckermannEnv.maze_core`` places the
port's episodes at these draws.  The Orbax directories stay as they are.
This script needs JAX and Orbax; the port itself reads only what it
writes.
"""
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from mujoco_playground_tpu_torch import interop  # noqa: E402
from mujoco_playground_tpu_torch.rl.checkpoint import \
    checkpoint_step  # noqa: E402
from mujoco_playground_tpu_torch.rl.train import CKPT_SUBDIR  # noqa: E402

# the committed solved runs: their checkpoints (rl_logs/*/EVAL.json), spawn
# heading noise and maze
SOLVED = (("rl_logs/solved/ppo/step_1500119040", 0.0, "PointMaze_UMaze-v3"),
          ("rl_logs/solved_randyaw/ppo/step_3000107008", 3.14159265,
           "PointMaze_UMaze-v3"),
          ("rl_logs/solved_medium/ppo/step_3000107008", 0.0,
           "PointMaze_Medium-v3"))
EPISODES, EVAL_SEED, RANDOM_KEY = 512, 0, 123
# the scripted expert's arenas (PARITY.md's calibration): name, maze, spawn
# heading noise; its episodes come from PRNGKey(SCRIPTED_SEED)
SCRIPTED = (("umaze", "PointMaze_UMaze-v3", 0.0),
            ("umaze_heading", "PointMaze_UMaze-v3", 3.14159265),
            ("medium", "PointMaze_Medium-v3", 0.0))
SCRIPTED_SEED = 7
SCRIPTED_DIR = "rl_logs/scripted_torch"


def restore_policy_leaves(path):
    """(params, norm) of an Orbax PPO checkpoint as nested dicts of
    numpy arrays."""
    state = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(state["params"]), to_np(state["norm"])


def port_path(path):
    """``<run>/ppo/step_N`` -> ``<run>/ppo_torch/step_<N:010d>.pt``."""
    run = os.path.dirname(os.path.dirname(os.path.normpath(path)))
    return os.path.join(run, CKPT_SUBDIR,
                        f"step_{checkpoint_step(path):010d}.pt")


def eval_draws(jenv, heading_noise, episodes=EPISODES, seed=EVAL_SEED):
    """The episodes of EVAL.json's protocol as numpy: the JAX env's
    ``reset_core`` of each key of ``split(PRNGKey(seed), episodes)``,
    read back as spawn xy, goal xy (world) and goal cell, and the spawn yaw
    each key draws (its split replayed, as ``reset_core`` draws it) under
    ``heading_noise``.  Run with x64 off, as the evaluation was (under x64
    ``randint`` draws other bits)."""
    import jax.numpy as jnp
    keys = jax.random.split(jax.random.PRNGKey(seed), episodes)
    core = jax.jit(jax.vmap(jenv.reset_core))(keys)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    out = dict(
        start_xy=np.asarray(core.physics.qpos[:, :2], np.float32),
        goal_xy=(f64(core.goal) + f64(core.physics.xpos[:, 1, :2])
                 ).astype(np.float32),
        goal_cell=np.asarray(core.goal_cell, np.int32))
    if heading_noise:
        lim = heading_noise
        out["yaw"] = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(jax.random.split(k, 5)[4], (),
                                         jnp.float32, -lim, lim))(keys))
    return out


def random_baseline_actions():
    """EVAL.json's random baseline: one (EPISODES, 2) uniform draw in
    [-1, 1) from ``PRNGKey(RANDOM_KEY)``, the same on every step."""
    import jax.numpy as jnp
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(RANDOM_KEY),
                                         (EPISODES, 2), jnp.float32,
                                         minval=-1.0, maxval=1.0))


def main():
    from mujoco_playground_tpu.envs import make_ackermann_env
    jenvs = {}

    def jenv_of(maze):
        if maze not in jenvs:
            jenvs[maze] = make_ackermann_env("maze", maze,
                                             solver_iterations=4,
                                             ls_iterations=3)
        return jenvs[maze]

    for rel, heading_noise, maze in SOLVED:
        src = os.path.join(ROOT, rel)
        params, norm = restore_policy_leaves(src)
        out = port_path(src)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        torch.save(interop.ppo_checkpoint_from_flax(
            params, norm, checkpoint_step(src)), out)
        draws = eval_draws(jenv_of(maze), heading_noise)
        with open(os.path.join(os.path.dirname(os.path.dirname(src)),
                               "EVAL.json")) as f:
            if "random_baseline" in json.load(f):
                draws["random_actions"] = random_baseline_actions()
        npz = os.path.join(os.path.dirname(out), "eval_seed0.npz")
        np.savez(npz, **draws)
        print(f"{rel} -> {os.path.relpath(out, ROOT)} "
              f"({os.path.getsize(out)} bytes), {os.path.relpath(npz, ROOT)} "
              f"({os.path.getsize(npz)} bytes)")
    os.makedirs(os.path.join(ROOT, SCRIPTED_DIR), exist_ok=True)
    for name, maze, heading_noise in SCRIPTED:
        npz = os.path.join(ROOT, SCRIPTED_DIR,
                           f"scripted_seed{SCRIPTED_SEED}_{name}.npz")
        np.savez(npz, **eval_draws(jenv_of(maze), heading_noise,
                                   seed=SCRIPTED_SEED))
        print(f"scripted {name} -> {os.path.relpath(npz, ROOT)} "
              f"({os.path.getsize(npz)} bytes)")


if __name__ == "__main__":
    main()
