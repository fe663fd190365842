"""The port's geodesic shaping and goal compass against the JAX package on
the CPU (umaze, B=8, the same numpy inputs on both sides).

* ``build_fields`` / ``build_grad_fields``: bitwise equal to JAX's.
* ``sample`` / ``sample_vec`` on 256 seeded points, grid nodes on the
  border and points that clamp: within 1e-6 relative.
* ``_compass_from``: within 1e-5, with the zero-gradient fallback and the
  open floor (no field: the straight-line goal direction).
* The fused step (K1's twin) with ``geodesic_reward_scale=10`` and the
  compass, from JAX's reset states, against the step of JAX's CPU
  ``step_autoreset_batch`` (no env done): the reward is the faithful
  reward plus ``10 * (phi_prev - phi_new)`` within 2e-5 (a difference of
  two float32 potentials of a few metres), and within 2e-5 of JAX's step;
  obs and final_obs 81 wide, within 1e-4 of JAX's (the compass within
  1e-5).
* Three auto-reset steps against JAX's ``step_autoreset_batch``, half the
  envs truncating on the first, JAX's ``reset_core`` samples injected:
  the fresh observation's compass comes from the fused spawn scan's path.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (autoreset_rollout, jax_env_state_arrays,
                           jax_model_arrays, obs_close, one_torch_thread,
                           truncate_half)  # noqa: F401
from mujoco_playground_tpu.envs import geodesic as jgeo
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.envs.ackermann_env import \
    AckermannEnv as JaxAckermannEnv
from mujoco_playground_tpu.spec.scene import pointmaze_scene as jax_pointmaze
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import geodesic, make_ackermann_env
from mujoco_playground_tpu_torch.envs.ackermann_env import (GEO_RES,
                                                            AckermannEnv)
from mujoco_playground_tpu_torch.spec.scene import pointmaze_scene

B = 8
SCALE = 10.0
KW = dict(solver_iterations=4, ls_iterations=3)


@pytest.fixture(scope="module")
def fields():
    """(JAX, port) umaze fields with their origins, built once."""
    return (jgeo.build_fields(jax_pointmaze("umaze"), GEO_RES),
            geodesic.build_fields(pointmaze_scene("umaze"), GEO_RES))


@pytest.fixture(scope="module")
def envs():
    """The JAX and port umaze envs with the shaping and the compass (the
    port's model carried across), and the port's env without them."""
    knobs = dict(geodesic_reward_scale=SCALE, goal_compass=True, **KW)
    jenv = jax_make_env("maze", "umaze", **knobs)
    penv = make_ackermann_env("maze", "umaze", device="cpu", **knobs)
    plain = make_ackermann_env("maze", "umaze", device="cpu", **KW)
    penv.model = plain.model = interop.model_from_arrays(
        jax_model_arrays(jenv.model), device="cpu")
    return jenv, penv, plain, jax.jit(jenv.step_autoreset_batch)


def test_fields_bitwise_equal_jax(fields):
    (jf, jo), (pf, po) = fields
    assert pf.dtype == jf.dtype == np.float32 and pf.shape == jf.shape
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(geodesic.build_grad_fields(pf, GEO_RES),
                                  jgeo.build_grad_fields(jf, GEO_RES))
    occ, origin = geodesic.rasterize_walls(pointmaze_scene("umaze"), GEO_RES)
    jocc, jorigin = jgeo.rasterize_walls(jax_pointmaze("umaze"), GEO_RES)
    np.testing.assert_array_equal(occ, jocc)
    np.testing.assert_array_equal(origin, jorigin)


def _points(origin, shape, n=256, seed=0):
    """n world points over the grid and 0.5 m beyond it (those clamp), with
    the four corner nodes and nodes on each border among them."""
    H, W = shape
    rng = np.random.default_rng(seed)
    lo, hi = origin - 0.5, origin + np.array([W - 1, H - 1]) * GEO_RES + 0.5
    xy = rng.uniform(lo, hi, (n, 2))
    border = np.array([[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1],
                       [W // 2, 0], [0, H // 2], [W - 1, H // 3],
                       [W // 3, H - 1]], np.float64)
    xy[:len(border)] = origin + border * GEO_RES
    cells = rng.integers(0, 7, n)
    return xy.astype(np.float32), cells.astype(np.int32)


def test_sample_and_sample_vec_match_jax(fields):
    (jf, jo), _ = fields
    pack = np.concatenate([jf[..., None], jgeo.build_grad_fields(jf, GEO_RES)],
                          axis=-1)
    xy, cells = _points(jo, jf.shape[1:])
    assert ((xy < jo) | (xy > jo + np.array(jf.shape[:0:-1]) * GEO_RES)).any()
    want = np.asarray(jgeo.sample(jnp.asarray(jf), jnp.asarray(jo), GEO_RES,
                                  jnp.asarray(cells), jnp.asarray(xy)))
    got = geodesic.sample(torch.from_numpy(jf), torch.from_numpy(jo), GEO_RES,
                          torch.from_numpy(cells), torch.from_numpy(xy))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jgeo.sample_vec(jnp.asarray(pack), jnp.asarray(jo),
                                      GEO_RES, jnp.asarray(cells),
                                      jnp.asarray(xy)))
    got = geodesic.sample_vec(torch.from_numpy(pack), torch.from_numpy(jo),
                              GEO_RES, torch.from_numpy(cells),
                              torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # channel 0 of the pack is the potential itself
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(
        jgeo.sample(jnp.asarray(jf), jnp.asarray(jo), GEO_RES,
                    jnp.asarray(cells), jnp.asarray(xy))), rtol=1e-6,
        atol=1e-6)


def test_compass_from_matches_jax():
    rng = np.random.default_rng(3)
    grad = rng.normal(size=(64, 2)).astype(np.float32)
    grad[:8] *= 1e-5                       # vanishing: the goal direction
    heading = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    goal_vec = rng.normal(size=(64, 2)).astype(np.float32)
    jself = types.SimpleNamespace(dtype=jnp.float32)
    pself = types.SimpleNamespace(dtype=torch.float32)
    for g in (grad, None):                 # None: the open floor
        want = np.asarray(JaxAckermannEnv._compass_from(
            jself, None if g is None else jnp.asarray(g),
            jnp.asarray(heading), jnp.asarray(goal_vec)))
        got = AckermannEnv._compass_from(
            pself, None if g is None else torch.from_numpy(g),
            torch.from_numpy(heading), torch.from_numpy(goal_vec))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                                   atol=1e-5)


def test_open_floor_compass_is_the_goal_direction():
    env = make_ackermann_env("simple", device="cpu", goal_compass=True, **KW)
    assert env.obs_size == 81 and env._geo_pack is None
    s = env.reset(4)
    ang = s.obs[:, 78].numpy()
    np.testing.assert_allclose(s.obs[:, 79:81].numpy(),
                               np.stack([np.cos(ang), np.sin(ang)], -1),
                               atol=1e-5)


def test_fused_step_reward_and_obs_match_jax(envs, fields):
    """The port's step_batch against the step of JAX's auto-reset step (no
    env is done: its reward and final_obs are the step's)."""
    jenv, penv, plain, jstep = envs
    (jf, jo), _ = fields
    assert penv.obs_size == jenv.obs_size == 81
    jstates = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(11), B))
    pstates = interop.env_state_from_arrays(jax_env_state_arrays(jstates),
                                            "cpu")
    actions = np.random.default_rng(4).uniform(-1, 1, (B, 2)).astype(
        np.float32)
    jnext = jstep(jstates, jnp.asarray(actions))
    assert not np.asarray(jnext.done).any()
    got = penv.step_batch(pstates, torch.from_numpy(actions))
    faithful = plain.step_batch(pstates.replace(obs=pstates.obs[:, :79]),
                                torch.from_numpy(actions)).reward.numpy()
    phi = lambda s: np.asarray(jgeo.sample(  # noqa: E731
        jnp.asarray(jf), jnp.asarray(jo), GEO_RES,
        jnp.asarray(s.goal_cell.numpy()),
        jnp.asarray(s.physics.xpos[:, 1, :2].numpy())))
    delta = SCALE * (phi(pstates) - phi(got))
    assert np.abs(delta).max() > 1e-3      # the shaping moved the reward
    np.testing.assert_allclose(got.reward.numpy(), faithful + delta,
                               atol=2e-5)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(jnext.reward),
                               atol=2e-5)
    assert got.obs.shape == got.final_obs.shape == (B, 81)
    obs_close(got.obs.numpy(), jnext.final_obs, 1e-4, compass_atol=1e-5)
    obs_close(got.final_obs.numpy(), jnext.final_obs, 1e-4, compass_atol=1e-5)


def test_autoreset_with_compass_matches_jax(envs):
    jenv, penv, _, jstep = envs
    jstates = truncate_half(jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(6), B)),
        jenv.config.max_episode_steps)

    def check(p, j):
        assert p.obs.shape == p.final_obs.shape == (B, 81)
        obs_close(p.final_obs.numpy(), j.final_obs, 1e-4, compass_atol=1e-5)
        obs_close(p.obs.numpy(), j.obs, 1e-4, compass_atol=1e-5)
        np.testing.assert_allclose(p.reward.numpy(), np.asarray(j.reward),
                                   atol=2e-5)

    n_done = autoreset_rollout(jenv, jstep, penv.step_autoreset_batch,
                               jstates, 3, 1, check)
    assert n_done >= B // 2   # the fresh observation's path was exercised
