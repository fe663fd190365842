"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: both sides get the same numpy inputs, in float32."""
import dataclasses

import numpy as np

from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.physics.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS)

# the two invweight0 leaves come from a matrix inverse, which the port takes
# in float64 on the host and JAX in float32
RTOL_FIELDS = ("body_invweight0", "dof_invweight0")


def jax_model_arrays(jm):
    """The JAX Model's fields by name: arrays as float32 numpy, the static
    topology as it is."""
    out = {}
    for f in dataclasses.fields(jm):
        v = getattr(jm, f.name)
        out[f.name] = (np.asarray(v, np.float32) if hasattr(v, "shape")
                       else v)
    return out


def assert_model_matches(port, jax_arrays):
    """Every leaf of a port Model against the JAX Model's: atol 1e-6, plus
    rtol 1e-5 on the invweight0 leaves."""
    for name in STATIC_FIELDS:
        assert getattr(port, name) == jax_arrays[name], name
    for name in ARRAY_FIELDS:
        got = getattr(port, name).cpu().numpy()
        want = jax_arrays[name]
        assert got.dtype == np.float32, name
        assert got.shape == want.shape, name
        np.testing.assert_allclose(
            got, want, atol=1e-6, rtol=1e-5 if name in RTOL_FIELDS else 0,
            err_msg=name)


def jax_env_state_arrays(state):
    """A JAX EnvState's leaves as numpy, keyed like the port's
    ``interop.ENV_STATE_FIELDS``."""
    out = {}
    for name in interop.ENV_STATE_FIELDS:
        v = state
        for part in name.split("."):
            v = getattr(v, part)
        out[name] = np.asarray(v)
    return out


def rows(a):
    """(B, ...) numpy -> batch-last (rows, B) float32, contiguous."""
    a = np.asarray(a, np.float32)
    return np.ascontiguousarray(a.reshape(a.shape[0], -1).T)


def assert_angles_close(got, want, atol):
    """Angles compared through sin and cos: a wrap to [-pi, pi) and
    arctan2(sin, cos) may differ by 2 pi at +-pi."""
    np.testing.assert_allclose(np.sin(got), np.sin(want), atol=atol)
    np.testing.assert_allclose(np.cos(got), np.cos(want), atol=atol)
