"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: both sides get the same numpy inputs, in float32."""
import dataclasses

import numpy as np
import pytest
import torch

from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.physics.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS)

# the two invweight0 leaves come from a matrix inverse, which the port takes
# in float64 on the host and JAX in float32
RTOL_FIELDS = ("body_invweight0", "dof_invweight0")
ANGLE = 78   # the goal-angle column of an observation


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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work in a parity test is many tiny ops: one thread
    runs them as fast and leaves the other test workers their cores.
    Autouse in the modules that import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def obs_close(got, want, atol, compass_atol=None):
    """Observations of an Ackermann env: every column at ``atol``, the goal
    angle (column 78) through sin and cos, and the compass columns (79-80,
    when present) at ``compass_atol`` (default ``atol``)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got[:, :ANGLE], want[:, :ANGLE], atol=atol)
    assert_angles_close(got[:, ANGLE], want[:, ANGLE], atol)
    if want.shape[-1] > ANGLE + 1:
        np.testing.assert_allclose(
            got[:, ANGLE + 1:], want[:, ANGLE + 1:],
            atol=atol if compass_atol is None else compass_atol)


def truncate_half(jstates, max_steps):
    """JAX states with the even envs one step from truncation."""
    import jax.numpy as jnp
    B = jstates.steps.shape[0]
    return jstates.replace(steps=jnp.where(
        jnp.arange(B) % 2 == 0, max_steps - 1, 0).astype(jstates.steps.dtype))


def autoreset_rollout(jenv, jstep, pstep, jstates, n_steps, seed, check):
    """``n_steps`` of JAX's and the port's ``step_autoreset_batch`` from
    the same states (``jstates`` carried across) with the same numpy
    actions and JAX's own ``reset_core`` samples injected as the port's
    ``fresh``; ``check(pstates, jstates)`` after each step.  Returns the
    number of episodes that ended."""
    import jax
    import jax.numpy as jnp
    B = jstates.steps.shape[0]
    pstates = interop.env_state_from_arrays(jax_env_state_arrays(jstates),
                                            "cpu")
    jfresh_of = jax.jit(lambda rng: jax.vmap(jenv.reset_core)(
        jax.vmap(jax.random.split)(rng)[:, 1]))
    rng = np.random.default_rng(seed)
    n_done = 0
    for _ in range(n_steps):
        actions = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        fresh = interop.env_state_from_arrays(
            jax_env_state_arrays(jfresh_of(jstates.rng)), "cpu")
        jstates = jstep(jstates, jnp.asarray(actions))
        pstates = pstep(pstates, torch.from_numpy(actions), fresh=fresh)
        np.testing.assert_array_equal(pstates.done.numpy(),
                                      np.asarray(jstates.done))
        check(pstates, jstates)
        n_done += int(pstates.done.sum())
    return n_done


def force_warmstart_pick(monkeypatch):
    """Make the port's fused step (K1's twin on the CPU) make MuJoCo's
    warm-start pick, as the JAX package's CPU step (the staged step) does:
    ``ws_compare=True`` on every K1 call, with ``check_variant`` (which
    admits only the flag sets compiled into K1) bypassed.  The fused TPU
    step and K1 skip the pick; after a contact-set change the two starts
    part by ~1e-4 in qpos, so env parity over more than a few steps
    compares like with like."""
    from mujoco_playground_tpu_torch.ops import step as k1
    step_fused = k1.step_fused
    monkeypatch.setattr(k1, "check_variant", lambda *a, **kw: None)
    monkeypatch.setattr(k1, "step_fused", lambda *a, **kw: step_fused(
        *a, **{**kw, "ws_compare": True}))


def jax_offpolicy_leaves(jstate):
    """A JAX ``SACState``/``TD3State``'s parameter trees, ``log_alpha`` and
    ``global_step`` as numpy, by field name (what
    ``interop.offpolicy_checkpoint_from_flax`` takes)."""
    import jax
    return {f.name: jax.tree_util.tree_map(np.asarray,
                                           getattr(jstate, f.name))
            for f in dataclasses.fields(jstate)
            if f.name.endswith("_params")
            or f.name in ("log_alpha", "global_step")}


def carry_offpolicy_params(pstate, jstate):
    """The JAX state's networks and ``log_alpha`` into the port state's."""
    d = interop.offpolicy_checkpoint_from_flax(jax_offpolicy_leaves(jstate))
    for name in pstate.MODULES:
        getattr(pstate, name).load_state_dict(d[name])
    with torch.no_grad():
        for name in pstate.TENSORS:
            getattr(pstate, name).copy_(d[name])
