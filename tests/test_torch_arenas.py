"""The port's other arenas against the JAX package on the CPU.

* ``PointMaze_Medium``: every leaf of the port's ``Model`` equals the JAX
  ``Model``'s (the tolerances of ``test_torch_model.py``).
* ``maze_flat``: the lidar twin's float32 scan of 104 frames (8 envs, the
  reset and 12 auto-reset steps of random actions, the robot dropping
  onto the floor among the 38 boxes) held per beam against a float64
  scan, JAX's ``raycast.lidar`` on a float64 model.  The lidar origin sits
  just under the boxes' top faces, so beams graze them and float32 is
  ill-conditioned there: a beam may miss the float64 reading by 1e-6 plus
  4 times the float64 scan's own move when its inputs move by one float32
  ulp (the largest move of 4 random draws; measured: errors up to 2.0e-3
  m, at most 2.1 times that move).  No-hit beams agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (assert_model_matches, jax_model_arrays,
                           one_torch_thread, rows)  # noqa: F401
from mujoco_playground_tpu.physics import raycast
from mujoco_playground_tpu.physics.model import make_model as jax_make_model
from mujoco_playground_tpu.spec import ackermann_robot_v2 as jax_robot
from mujoco_playground_tpu.spec.scene import maze_flat_scene as jax_flat
from mujoco_playground_tpu.spec.scene import pointmaze_scene as jax_pointmaze
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.physics.model import make_model
from mujoco_playground_tpu_torch.spec import (ackermann_robot_v2,
                                              pointmaze_scene)

KW = dict(solver_iterations=4, ls_iterations=3)
B = 8


def test_pointmaze_medium_model_matches_jax():
    jm = jax_make_model(jax_robot(), jax_pointmaze("PointMaze_Medium-v3"),
                        dtype=jnp.float32, **KW)
    port = make_model(ackermann_robot_v2(),
                      pointmaze_scene("PointMaze_Medium-v3"), device="cpu",
                      **KW)
    assert port.scene_box_pos.shape[0] > 10   # the medium maze's walls
    assert_model_matches(port, jax_model_arrays(jm))


def test_maze_flat_lidar_per_beam_against_float64():
    env = make_ackermann_env("maze_flat", device="cpu", **KW)
    s = env.reset(B, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    xpos, xquat = [s.physics.xpos], [s.physics.xquat]
    for _ in range(12):
        s = env.step_autoreset_batch(
            s, torch.rand((B, 2), generator=g) * 2 - 1)
        xpos.append(s.physics.xpos)
        xquat.append(s.physics.xquat)
    xpos, xquat = torch.cat(xpos).numpy(), torch.cat(xquat).numpy()
    got = k2.lidar(env.model, torch.from_numpy(rows(xpos)),
                   torch.from_numpy(rows(xquat))).T.numpy()

    jm = jax_make_model(jax_robot(), jax_flat(), dtype=jnp.float64, **KW)
    scan = jax.jit(jax.vmap(lambda p, q: raycast.lidar(jm, p, q)))
    x64, q64 = xpos.astype(np.float64), xquat.astype(np.float64)
    want = np.asarray(scan(x64, q64))
    rng = np.random.default_rng(0)
    moved = np.zeros_like(want)
    for _ in range(4):
        nudged = [a + rng.choice([-1.0, 1.0], a.shape) * np.spacing(a32)
                  for a, a32 in ((x64, xpos), (q64, xquat))]
        moved = np.maximum(moved, np.abs(np.asarray(scan(*nudged)) - want))

    err = np.abs(got - want)
    bad = np.argwhere(err > 1e-6 + 4 * moved)
    assert not len(bad), [(tuple(i), err[tuple(i)], moved[tuple(i)])
                          for i in bad[:5]]
    np.testing.assert_array_equal(got < 0, want < 0)
    # the frames hold grazing beams, and the rest are tight
    assert moved.max() > 1e-4
    assert (err <= 1e-5).mean() > 0.95
