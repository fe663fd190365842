"""The port's Ackermann env as a whole against the JAX package's, on the CPU
at B=8, fed the same states, actions and reset samples.

* The settle template (3 steps at B=1 with the two-sided warm-start pick)
  against JAX ``env._template``: qpos and xpos at 1e-6.
* ``reset`` with JAX's ``reset_core`` sample injected against JAX ``reset``:
  obs at 1e-5 (the goal angle through sin and cos).
* 10 steps of ``step_autoreset_batch`` from identical carried-across states
  and numpy actions, half the envs truncating on the first step, with JAX's
  own ``reset_core`` samples injected, against JAX's CPU
  ``step_autoreset_batch``: obs, final_obs and reward at 1e-4, ``done``
  exact, qpos at 1e-5.  The JAX CPU path is the staged step, which makes
  MuJoCo's warm-start pick, while the port's main path starts Newton from
  the warm start as the fused TPU step does; on these inputs the two agree
  to 6e-8 in qpos and 7e-7 in obs (measured), since the pick only matters
  after contact-set changes.
* The torch generator's reset distribution: start cell != goal cell, and
  start and goal within +-0.25 cell of their cells.
* The reference-compat knobs and a randomization outside DR_SUPPORTED
  construct and step (their parity with JAX: ``test_torch_compat_knobs.py``,
  ``test_torch_staged_dr.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_angles_close, assert_model_matches,
                           jax_env_state_arrays, jax_model_arrays)
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import (make_ackermann_env,
                                              randomize_model)
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.physics import engine

B = 8
ANGLE = 78   # the goal-angle column of the observation


@pytest.fixture(scope="module")
def envs():
    jenv = jax_make_env("maze", "umaze", solver_iterations=4, ls_iterations=3)
    penv = make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, device="cpu", seed=0)
    arrays = jax_model_arrays(jenv.model)
    assert_model_matches(penv.model, arrays)
    penv.model = interop.model_from_arrays(arrays, device="cpu")
    return jenv, penv


def _port_state(jstate):
    return interop.env_state_from_arrays(jax_env_state_arrays(jstate), "cpu")


def _obs_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    cols = [c for c in range(want.shape[-1]) if c != ANGLE]
    np.testing.assert_allclose(got[:, cols], want[:, cols], atol=atol)
    assert_angles_close(got[:, ANGLE], want[:, ANGLE], atol)


def test_settle_template_matches_jax(envs):
    jenv, penv = envs
    t = penv._template
    np.testing.assert_allclose(t.qpos.numpy(),
                               np.asarray(jenv._template.qpos, np.float32),
                               atol=1e-6)
    np.testing.assert_allclose(t.xpos.numpy(),
                               np.asarray(jenv._template.xpos, np.float32),
                               atol=1e-6)


def test_reset_with_injected_sample_matches_jax(envs):
    jenv, penv = envs
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    want = jax.jit(jax.vmap(jenv.reset))(keys)
    core = _port_state(jax.jit(jax.vmap(jenv.reset_core))(keys))
    got = penv.reset(core=core)
    _obs_close(got.obs.numpy(), want.obs, 1e-5)
    np.testing.assert_array_equal(got.collision.numpy(),
                                  np.asarray(want.collision))
    np.testing.assert_allclose(got.goal_distance.numpy(),
                               np.asarray(want.goal_distance), atol=1e-6)


def test_autoreset_rollout_matches_jax(envs):
    jenv, penv = envs
    jstates = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(6), B))
    steps = jnp.where(jnp.arange(B) % 2 == 0,
                      jenv.config.max_episode_steps - 1, 0
                      ).astype(jstates.steps.dtype)
    jstates = jstates.replace(steps=steps)
    pstates = _port_state(jstates)
    jstep = jax.jit(jenv.step_autoreset_batch)
    jfresh_of = jax.jit(lambda rng: jax.vmap(jenv.reset_core)(
        jax.vmap(jax.random.split)(rng)[:, 1]))
    rng = np.random.default_rng(1)
    n_done = 0
    for _ in range(10):
        actions = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        fresh = _port_state(jfresh_of(jstates.rng))
        jstates = jstep(jstates, jnp.asarray(actions))
        pstates = penv.step_autoreset_batch(pstates, torch.from_numpy(actions),
                                            fresh=fresh)
        np.testing.assert_array_equal(pstates.done.numpy(),
                                      np.asarray(jstates.done))
        _obs_close(pstates.final_obs.numpy(), jstates.final_obs, 1e-4)
        _obs_close(pstates.obs.numpy(), jstates.obs, 1e-4)
        np.testing.assert_allclose(pstates.reward.numpy(),
                                   np.asarray(jstates.reward), atol=1e-4)
        q, jq = pstates.physics.qpos.numpy(), np.asarray(jstates.physics.qpos)
        np.testing.assert_allclose(q, jq, atol=1e-5)
        np.testing.assert_array_equal(pstates.steps.numpy(),
                                      np.asarray(jstates.steps))
        n_done += int(pstates.done.sum())
    assert n_done >= B // 2   # the reset branch was exercised


def test_reset_distribution_from_the_generator(envs):
    _, penv = envs
    n = 4096
    core = penv.reset_core(n)
    cells = penv._free_cells.numpy()
    size = penv.scene.cell_size
    start = core.physics.xpos[:, 1, :2].numpy()
    goal_world = core.goal.numpy() + start

    def cell_of(xy):
        d = np.abs(xy[:, None, :] - cells[None]) / size
        inside = (d <= 0.25 + 1e-5).all(-1)
        assert (inside.sum(-1) == 1).all(), "a point outside +-0.25 cell"
        return inside.argmax(-1)

    si, gi = cell_of(start), cell_of(goal_world)
    np.testing.assert_array_equal(gi, core.goal_cell.numpy())
    assert (si != gi).all()
    assert set(si.tolist()) == set(range(len(cells)))
    # the noise fills its square: both ends of +-0.25 cell are reached
    off = (start - cells[si]) / size
    assert off.min() < -0.24 and off.max() > 0.24


def test_env_state_arrays_round_trip(envs):
    jenv, _ = envs
    jstate = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(8), B))
    want = jax_env_state_arrays(jstate)
    got = interop.env_state_to_arrays(_port_state(jstate))
    assert set(got) == set(want) == set(interop.ENV_STATE_FIELDS)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("knob", [
    dict(reference_delayed_obs=True), dict(physics_substeps=2)])
def test_compat_configurations_step(knob):
    """The reference-compat knobs construct and step: under delayed obs
    the step's observation is that of the pre-step physics; two substeps
    advance the physics by two timesteps.  (``test_torch_compat_knobs.py``
    and ``test_torch_compat_substeps.py`` hold them against JAX.)"""
    penv = make_ackermann_env("maze", "umaze", device="cpu", seed=2,
                              solver_iterations=4, ls_iterations=3, **knob)
    st = penv.reset(2)
    new = penv.step_batch(st, torch.tensor([[0.5, 0.2], [0.8, -0.4]]))
    h = float(penv.model.timestep)
    n = knob.get("physics_substeps", 1)
    np.testing.assert_allclose(new.physics.time.numpy(), n * h, rtol=1e-6)
    assert not torch.equal(new.physics.qpos, st.physics.qpos)
    moved = penv._observe_batch(new.physics, st.odom_ref, st.goal)[0]
    before = penv._observe_batch(st.physics, st.odom_ref, st.goal)[0]
    if knob.get("reference_delayed_obs"):
        np.testing.assert_array_equal(new.obs.numpy(), before.numpy())
    else:
        np.testing.assert_allclose(new.obs.numpy(), moved.numpy(),
                                   atol=1e-5)
    nxt = penv.step_autoreset_batch(new, torch.zeros((2, 2)))
    assert bool(torch.isfinite(nxt.obs).all())


@pytest.mark.parametrize("knob", [
    dict(spawn_heading_noise=3.14), dict(goal_compass=True),
    dict(geodesic_reward_scale=1.0)])
def test_solved_task_knobs_construct(knob):
    """The solved-task knobs are ported (``test_torch_geodesic.py``,
    ``test_torch_spawn_heading.py``): only the compass widens the obs."""
    env = make_ackermann_env("simple", device="cpu", **knob)
    assert env.obs_size == (81 if "goal_compass" in knob else 79)
    assert env.reset(2).obs.shape == (2, env.obs_size)


def test_domain_randomization_outside_dr_supported_steps(envs,
                                                        monkeypatch):
    """A randomized leaf outside DR_SUPPORTED (here the joint ranges) takes
    the staged DR fallback: K3 (its twin here), never K1 or K1e, and the
    observation through K2 with each env's floor.
    (``test_torch_staged_dr.py`` holds the step against JAX.)"""
    _, penv = envs
    st = penv.reset(2)
    models = randomize_model(penv.model, torch.Generator().manual_seed(0), 2)
    models = dataclasses.replace(
        models, jnt_range=penv.model.jnt_range.expand(2, -1, -1) * 0.5)
    calls = []
    for mod, name in ((k1, "step_fused"), (k2, "lidar"),
                      (engine, "newton_solve")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **kw:
                            calls.append(_n) or _f(*a, **kw))
    new = penv.step_autoreset_batch(st, torch.zeros((2, 2)), models=models,
                                    base_model=penv.model)
    assert calls == ["newton_solve", "lidar", "lidar"], calls
    assert bool(torch.isfinite(new.obs).all())
