"""The port's model compiler against the JAX package's ``make_model``.

Every leaf of the port's ``Model`` equals the JAX ``Model``'s for the umaze
arena and the open floor, in float32: atol 1e-6, and rtol 1e-5 on the two
invweight0 leaves.  ``model_from_arrays`` carries a JAX model across
unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_model_matches, jax_model_arrays
from mujoco_playground_tpu.physics.model import make_model as jax_make_model
from mujoco_playground_tpu.spec import ackermann_robot_v2 as jax_robot
from mujoco_playground_tpu.spec import open_floor_scene as jax_open_floor
from mujoco_playground_tpu.spec import pointmaze_scene as jax_pointmaze
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.physics.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       make_model)
from mujoco_playground_tpu_torch.spec import (ackermann_robot_v2,
                                              open_floor_scene,
                                              pointmaze_scene)


@pytest.mark.parametrize("arena", ["umaze", "open_floor"])
def test_make_model_matches_jax(arena):
    if arena == "umaze":
        jscene, scene = jax_pointmaze("umaze"), pointmaze_scene("umaze")
    else:
        jscene, scene = jax_open_floor(), open_floor_scene()
    jm = jax_make_model(jax_robot(), jscene, dtype=jnp.float32,
                        solver_iterations=4, ls_iterations=3)
    port = make_model(ackermann_robot_v2(), scene, solver_iterations=4,
                      ls_iterations=3, device="cpu")
    assert_model_matches(port, jax_model_arrays(jm))


def test_model_from_arrays_round_trip():
    jm = jax_make_model(jax_robot(), jax_pointmaze("umaze"),
                        dtype=jnp.float32, solver_iterations=4,
                        ls_iterations=3)
    arrays = jax_model_arrays(jm)
    port = interop.model_from_arrays(arrays, device="cpu")
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      arrays[name], err_msg=name)
        assert getattr(port, name).dtype == torch.float32
    for name in STATIC_FIELDS:
        assert getattr(port, name) == arrays[name], name


def test_unported_compat_manifolds_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_model(ackermann_robot_v2(), pointmaze_scene("umaze"),
                   compat_flat_manifold=True, device="cpu")
