"""The port's model compiler against the JAX package's ``make_model``.

Every leaf of the port's ``Model`` equals the JAX ``Model``'s for the umaze
arena and the open floor, in float32: atol 1e-6, and rtol 1e-5 on the two
invweight0 leaves; the static fields (the hull faces and compat flags
among them) exactly, with the compat manifolds on and off.
``model_from_arrays`` carries a JAX model across unchanged.  The field
ranks that tell a randomized leaf (``FIELD_NDIM``), and the compat
manifolds stepping under domain randomization.
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
from mujoco_playground_tpu_torch.envs import randomize_model
from mujoco_playground_tpu_torch.physics import engine
from mujoco_playground_tpu_torch.physics.model import (ARRAY_FIELDS,
                                                       FIELD_NDIM,
                                                       STATIC_FIELDS,
                                                       env_count, env_leaf,
                                                       make_model,
                                                       randomized_fields)
from mujoco_playground_tpu_torch.physics.state import State, make_state
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


def test_compat_model_matches_jax():
    kw = dict(solver_iterations=4, ls_iterations=3, compat_flat_manifold=True,
              compat_wheel_patch=True)
    jm = jax_make_model(jax_robot(), jax_pointmaze("umaze"),
                        dtype=jnp.float32, **kw)
    port = make_model(ackermann_robot_v2(), pointmaze_scene("umaze"),
                      device="cpu", **kw)
    assert_model_matches(port, jax_model_arrays(jm))
    assert len(port.chassis_hull_faces[0]) == 60


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


def test_field_ranks():
    """``FIELD_NDIM`` gives every array field's rank in one env's model
    (a randomized leaf has one more), on the umaze and open-floor models
    and a randomized one."""
    for scene in (pointmaze_scene("umaze"), open_floor_scene()):
        model = make_model(ackermann_robot_v2(), scene, device="cpu")
        assert set(FIELD_NDIM) == set(ARRAY_FIELDS)
        for name in ARRAY_FIELDS:
            assert getattr(model, name).dim() == FIELD_NDIM[name], name
        assert randomized_fields(model) == () and env_count(model) == 1
    models = randomize_model(model, torch.Generator().manual_seed(0), 3)
    names = randomized_fields(models)
    assert set(names) == set(engine.batched_field_dict(models, model))
    assert env_count(models) == 3
    assert env_leaf(models, "plane_z", 3).shape == (3,)
    assert env_leaf(models, "jnt_range", 3).shape == (3,) + \
        model.jnt_range.shape
    with pytest.raises(ValueError, match="envs"):
        env_leaf(models, "plane_z", 4)


def test_compat_manifolds_with_domain_randomization_step():
    """The compat manifolds compile and step (the staged step), and domain
    randomization on top of one takes the staged DR fallback: each env
    collides with its own friction, so identical states part.
    (``test_torch_staged_dr.py`` holds the same against JAX.)"""
    model = make_model(ackermann_robot_v2(), pointmaze_scene("umaze"),
                       compat_flat_manifold=True, solver_iterations=4,
                       ls_iterations=3, device="cpu")
    assert model.compat_flat_manifold and not model.compat_wheel_patch
    assert len(model.chassis_hull_faces) == 2
    states = _batch(make_state(model), 2)
    states = states.replace(ctrl=torch.tensor([[0.3, 20.0, 20.0]] * 2))
    plain = engine.step_batch(model, states)
    assert torch.equal(plain.qvel[0], plain.qvel[1])
    models = randomize_model(model, torch.Generator().manual_seed(0), 2)
    for _ in range(3):
        states = engine.step_batch(models, states, base_model=model)
    assert bool(torch.isfinite(states.qvel).all())
    assert float((states.qvel[0] - states.qvel[1]).abs().max()) > 1e-4


def _batch(state, n):
    return State(**{f: getattr(state, f).expand(
        (n,) + getattr(state, f).shape).clone()
        for f in State.__dataclass_fields__})
