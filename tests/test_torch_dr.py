"""Domain randomization in the port (path A: kernel K1e's twin) against the
JAX package on the CPU, at B=8, with the same numpy-made inputs on both
sides: randomized leaves come from JAX ``randomize_model`` and are carried
across (``interop.randomized_model_from_arrays``); seeds are not matched.

* ``randomize_model``: env-axis shapes, every scale inside its range, and
  the log-uniform spread (mean and standard deviation of the log scale
  within 4 standard errors at 4096 envs).
* ``pack_dr_params`` equals JAX's on the same leaves, exactly.
* The DR twin's physics step with the two-sided warm-start pick against
  JAX ``engine.step_batch(models, s, base_model=m)`` (the staged DR path on
  the CPU), each step from JAX's state: qpos 1e-6, qvel 1e-4 (the
  tolerances at which ``test_domain_randomization.py`` holds JAX's own
  fused and staged DR steps).
* A 5-step ``DomainRandomizedEnv.step_autoreset_batch`` rollout with JAX's
  ``reset_core`` samples injected, floor offsets of +-2 cm: obs, final_obs
  and reward 1e-4, ``done`` exact, qpos 1e-5 (the tolerances of
  ``test_torch_env.py``'s rollout; the port's env step starts Newton from
  the warm start as the fused TPU step does, JAX's CPU path makes the pick).
* The lidar twin with a per-env floor height against JAX ``lidar_rows``
  with a plane_z lane, 1e-6.
* Unrandomized leaves (every scale 1, no floor offset) give the non-DR
  twin's contact set exactly and its outputs within float32 rounding
  (measured over 3 steps: qpos 5e-10, qvel 2.5e-7, qacc 2.4e-4 where |qacc|
  reaches ~1e3, env slab 1.2e-7), not bit for bit: the non-DR twin folds
  sums of static parameters (the total mass in the mass matrix) in float64
  while the lanes sum in float32.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_angles_close, jax_env_state_arrays,
                           jax_model_arrays, rows)
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.envs.domain_randomization import \
    DomainRandomizedEnv as JaxDREnv
from mujoco_playground_tpu.envs.domain_randomization import \
    RandomizationConfig as JaxConfig
from mujoco_playground_tpu.envs.domain_randomization import \
    randomize_model as jax_randomize
from mujoco_playground_tpu.ops import lidar_pallas, step_pallas
from mujoco_playground_tpu.physics import engine as jax_engine
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import (DomainRandomizedEnv,
                                              RandomizationConfig,
                                              make_ackermann_env,
                                              randomize_model)
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.physics import engine

B = 8
ANGLE = 78
WIDE = dict(floor_z_offset=(-0.02, 0.02))


@pytest.fixture(scope="module")
def envs():
    jenv = jax_make_env("maze", "umaze", solver_iterations=4, ls_iterations=3)
    penv = make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, device="cpu", seed=0)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    return jenv, penv


def _leaves(jmodels, jbase):
    """The randomized leaves of a JAX model as float32 numpy."""
    return {name: np.asarray(leaf, np.float32) for name, leaf in
            jax_engine.batched_field_dict(jmodels, jbase).items()}


def _port_models(jmodels, jbase, penv):
    return interop.randomized_model_from_arrays(penv.model,
                                                _leaves(jmodels, jbase))


def test_randomize_model_ranges_and_spread(envs):
    _, penv = envs
    cfg = RandomizationConfig()
    n = 4096
    models = randomize_model(penv.model, torch.Generator().manual_seed(0), n,
                             cfg)
    base = penv.model
    ranges = dict(wheel_friction=cfg.friction_scale,
                  body_mass=cfg.mass_scale, body_inertia=cfg.mass_scale,
                  dof_damping=cfg.damping_scale,
                  dof_frictionloss=cfg.frictionloss_scale,
                  dof_armature=cfg.armature_scale,
                  actuator_gain=cfg.actuator_gain_scale,
                  actuator_bias=cfg.actuator_gain_scale)
    names = sorted(engine.batched_field_dict(models, base))
    assert names == sorted(list(ranges) + ["plane_z"])
    assert set(names) == set(k1.DR_SUPPORTED)
    for name, (lo, hi) in ranges.items():
        leaf, b = getattr(models, name), getattr(base, name)
        assert leaf.shape == (n,) + b.shape, name
        nz = b != 0
        scale = (leaf[:, nz] / b[nz]).double()
        # one scale per env, shared by every entry of the leaf
        assert float((scale - scale[:, :1]).abs().max()) < 1e-5, name
        s = scale[:, 0]
        assert float(s.min()) >= lo * (1 - 1e-6), name
        assert float(s.max()) <= hi * (1 + 1e-6), name
        u = (torch.log(s) - math.log(lo)) / (math.log(hi) - math.log(lo))
        se = (1 / 12) ** 0.5 / n ** 0.5
        assert abs(float(u.mean()) - 0.5) < 4 * se, name
        assert abs(float(u.std()) - (1 / 12) ** 0.5) < 0.02, name
    off = (models.plane_z - base.plane_z).double()
    lo, hi = cfg.floor_z_offset
    assert models.plane_z.shape == (n,)
    assert float(off.min()) >= lo - 1e-7 and float(off.max()) <= hi + 1e-7
    u = (off - lo) / (hi - lo)
    assert abs(float(u.mean()) - 0.5) < 4 * (1 / 12) ** 0.5 / n ** 0.5


def test_pack_dr_params_matches_jax(envs):
    jenv, penv = envs
    jmodels = jax_randomize(jenv.model, jax.random.PRNGKey(3), B)
    want = np.asarray(step_pallas.pack_dr_params(jmodels,
                                                 step_pallas.DR_SUPPORTED))
    got = k1.pack_dr_params(_port_models(jmodels, jenv.model, penv),
                            k1.DR_SUPPORTED)
    assert got.shape == (85, B) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert k1.DR_SUPPORTED == step_pallas.DR_SUPPORTED
    # the engine packs the same rows for K1e
    np.testing.assert_array_equal(
        engine.dr_params(_port_models(jmodels, jenv.model, penv), penv.model,
                         B).numpy(), want.astype(np.float32))


def _ctrl(B_):
    return np.tile(np.asarray([[0.3, 10.0, 10.0]], np.float32), (B_, 1))


def test_dr_twin_physics_matches_staged_dr_step(envs):
    jenv, penv = envs
    jm = jenv.model
    jmodels = jax_randomize(jm, jax.random.PRNGKey(7), B, JaxConfig(**WIDE))
    params = engine.dr_params(_port_models(jmodels, jm, penv), penv.model, B)
    states = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(0), B))
    phys = states.physics.replace(ctrl=jnp.asarray(_ctrl(B)))
    jstep = jax.jit(lambda s: jax_engine.step_batch(jmodels, s,
                                                    base_model=jm))
    for _ in range(3):
        ref = jstep(phys)
        q, v, xpos, xquat, qacc = k1.step_plain(
            penv.model, torch.from_numpy(rows(phys.qpos)),
            torch.from_numpy(rows(phys.qvel)),
            torch.from_numpy(rows(phys.ctrl)),
            torch.from_numpy(rows(phys.qacc_warmstart)), ws_compare=True,
            dr_params=params)
        np.testing.assert_allclose(q.numpy(), rows(ref.qpos), atol=1e-6)
        np.testing.assert_allclose(v.numpy(), rows(ref.qvel), atol=1e-4)
        np.testing.assert_allclose(xpos.numpy(), rows(ref.xpos), atol=1e-6)
        phys = ref
    # the per-env parameters reached the step: identical controls, spread
    # velocities
    assert float(np.std(np.asarray(ref.qvel), axis=0).max()) > 1e-3


def _obs_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    cols = [c for c in range(want.shape[-1]) if c != ANGLE]
    np.testing.assert_allclose(got[:, cols], want[:, cols], atol=atol)
    assert_angles_close(got[:, ANGLE], want[:, ANGLE], atol)


def test_dr_env_autoreset_rollout_matches_jax(envs):
    jenv, penv = envs
    jdr = JaxDREnv(jenv, B, jax.random.PRNGKey(5), JaxConfig(**WIDE))
    pdr = DomainRandomizedEnv(penv, B, torch.Generator().manual_seed(0),
                              RandomizationConfig(**WIDE))
    pdr.models = _port_models(jdr.models, jenv.model, penv)
    jstates = jax.jit(jax.vmap(jdr.reset))(
        jax.random.split(jax.random.PRNGKey(6), B))
    steps = jnp.where(jnp.arange(B) % 2 == 0,
                      jenv.config.max_episode_steps - 1, 0
                      ).astype(jstates.steps.dtype)
    jstates = jstates.replace(steps=steps)
    pstates = interop.env_state_from_arrays(jax_env_state_arrays(jstates),
                                            "cpu")
    jstep = jax.jit(jdr.step_autoreset_batch)
    jfresh_of = jax.jit(lambda rng: jax.vmap(jenv.reset_core)(
        jax.vmap(jax.random.split)(rng)[:, 1]))
    rng = np.random.default_rng(2)
    n_done = 0
    for _ in range(5):
        actions = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        fresh = interop.env_state_from_arrays(
            jax_env_state_arrays(jfresh_of(jstates.rng)), "cpu")
        jstates = jstep(jstates, jnp.asarray(actions))
        pstates = pdr.step_autoreset_batch(pstates, torch.from_numpy(actions),
                                           fresh=fresh)
        np.testing.assert_array_equal(pstates.done.numpy(),
                                      np.asarray(jstates.done))
        _obs_close(pstates.final_obs.numpy(), jstates.final_obs, 1e-4)
        _obs_close(pstates.obs.numpy(), jstates.obs, 1e-4)
        np.testing.assert_allclose(pstates.reward.numpy(),
                                   np.asarray(jstates.reward), atol=1e-4)
        np.testing.assert_allclose(pstates.physics.qpos.numpy(),
                                   np.asarray(jstates.physics.qpos),
                                   atol=1e-5)
        n_done += int(pstates.done.sum())
    assert n_done >= B // 2   # the reset branch was exercised


def test_lidar_rows_take_per_env_plane_z_lane():
    """The nose-down chassis (beams 30 degrees below horizontal) sees the
    floor; each env's floor height must reach its own readings."""
    jenv = jax_make_env("simple", solver_iterations=2, ls_iterations=2)
    penv = make_ackermann_env("simple", solver_iterations=2, ls_iterations=2,
                              device="cpu")
    jstat = lidar_pallas.lidar_statics(jenv.model)
    pstat = k2.lidar_statics(penv.model)
    b = jstat[0][0]
    n = 4
    half = np.deg2rad(30.0) / 2
    quat = [float(np.cos(half)), 0.0, float(np.sin(half)), 0.0]
    lane = np.asarray([0.0, -0.05, -0.1, -0.2], np.float32)
    f32 = jnp.float32
    jrows = lidar_pallas.lidar_rows(
        *(jstat[:5] + (jnp.asarray(lane),) + jstat[6:]),
        {b: [jnp.zeros((n,), f32), jnp.zeros((n,), f32),
             jnp.full((n,), 0.2, f32)]},
        {b: [jnp.full((n,), q, f32) for q in quat]})
    prows = k2.lidar_rows(
        *(pstat[:5] + (torch.from_numpy(lane),) + pstat[6:]),
        {b: [torch.zeros(n), torch.zeros(n), torch.full((n,), 0.2)]},
        {b: [torch.full((n,), q) for q in quat]})
    got, want = torch.stack(prows).numpy(), np.asarray(jrows)
    np.testing.assert_allclose(got, want, atol=1e-6)
    hit_all = (got >= 0).all(axis=1)
    assert hit_all.any() and got[hit_all].std(axis=1).max() > 1e-3


def test_unrandomized_leaves_give_the_plain_step(envs):
    jenv, penv = envs
    tight = RandomizationConfig(
        friction_scale=(1.0, 1.0), mass_scale=(1.0, 1.0),
        damping_scale=(1.0, 1.0), frictionloss_scale=(1.0, 1.0),
        armature_scale=(1.0, 1.0), actuator_gain_scale=(1.0, 1.0),
        floor_z_offset=(0.0, 0.0))
    models = randomize_model(penv.model, torch.Generator().manual_seed(1), B,
                             tight)
    for name in k1.DR_SUPPORTED:
        base = getattr(penv.model, name)
        assert torch.equal(getattr(models, name),
                           base.expand((B,) + base.shape)), name
    params = engine.dr_params(models, penv.model, B)
    st = penv.reset(B)
    fresh = penv.reset_core(B)
    g = torch.Generator().manual_seed(4)
    q, v = rows(st.physics.qpos), rows(st.physics.qvel)
    q, v = torch.from_numpy(q), torch.from_numpy(v)
    ws = torch.from_numpy(rows(st.physics.qacc_warmstart))
    env_in = torch.from_numpy(rows(torch.cat(
        [st.odom_ref.position[:, :2], st.goal, st.prev_goal_distance[:, None],
         fresh.physics.xpos[:, 1, :2]], -1)))
    for _ in range(3):
        ctrl = torch.rand((3, B), generator=g) * 2 - 1
        args = (penv.model, q, v, ctrl, ws, env_in, penv._env_statics(),
                penv._fresh_statics(), False)
        want = k1.step_plain(*args)
        got = k1.step_plain(*args, dr_params=params)
        np.testing.assert_array_equal(k1.contact_activity(
            penv.model, q, params).numpy(),
            k1.contact_activity(penv.model, q).numpy())
        for name, a, b, atol in zip(
                ("qpos", "qvel", "xpos", "xquat", "qacc", "slab"), got, want,
                (1e-6, 1e-5, 1e-6, 1e-6, 1e-2, 1e-5)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol,
                                       rtol=1e-5, err_msg=name)
        q, v, ws = want[0], want[1], want[4]
