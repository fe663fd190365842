"""The port's per-env step against the JAX package's per-env functions on
the CPU (umaze, solver 4/3), one env at a time as the JAX functions take
them, with the same states carried across (``interop`` takes one env's
leaves as well as a batch's).

* ``engine.forward`` and ``engine.step`` on 8 wall poses (wheels and hulls
  against maze walls, ``envs/poses.py``) and 8 reset states: qacc atol
  2e-3 plus rtol 1e-4 (|qacc| reaches ~1e3 on the wheel dofs; the two
  sides sum in other orders), the joint and contact forces 1e-3 plus 1e-4
  relative, qfrc_constraint 2e-3 plus 1e-4 relative; the stepped qpos and
  xpos 1e-6, qvel 1e-4.  Both make MuJoCo's warm-start pick (measured on
  these inputs: qacc 2.2e-4, qvel 2.1e-6, qpos 5.6e-9).
* ``AckermannEnv.step`` and ``step_autoreset`` (the latter with JAX's own
  fresh draw injected, the env one step from truncation) from the same
  states for 4 steps: obs 1e-5 (the goal angle through sin and cos),
  reward 1e-5, qpos 1e-6, ``done`` exact.
* ``raycast.lidar`` with ``include_robot_geoms`` (and without, and on a
  slice of the sites) against JAX's on the reset and wall frames, 1e-6.
* The port's staged DR batch (``engine.step_batch`` with a randomized
  model) against its own per-env step on each env's own model, as
  ``test_domain_randomization.py::test_dr_fast_path_matches_per_env_vmap``
  holds the JAX package's: the compat manifolds with the default
  randomization and per-env joint ranges, in float64, 1e-10 in qpos and
  1e-8 in qvel (float64 rounding of sums in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_angles_close, jax_env_state_arrays,
                           jax_model_arrays, one_torch_thread)  # noqa: F401
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.physics import engine as jax_engine
from mujoco_playground_tpu.physics import raycast as jax_raycast
from mujoco_playground_tpu.physics.state import State as JaxState
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import (make_ackermann_env,
                                              randomize_model)
from mujoco_playground_tpu_torch.envs.poses import wall_poses
from mujoco_playground_tpu_torch.physics import engine, raycast
from mujoco_playground_tpu_torch.physics.state import State

B = 8
SOLVER = dict(solver_iterations=4, ls_iterations=3)
ANGLE = 78


@pytest.fixture(scope="module")
def envs():
    jenv = jax_make_env("maze", "umaze", **SOLVER)
    penv = make_ackermann_env("maze", "umaze", device="cpu", seed=1,
                              **SOLVER)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    return jenv, penv


@pytest.fixture(scope="module")
def physics(envs):
    """8 wall poses and 8 reset states, as (port State, JAX State) pairs of
    one env each."""
    jenv, penv = envs
    wall = wall_poses(penv, B, torch.Generator().manual_seed(3))
    reset = penv.reset(B).physics
    out = []
    for batch in (wall, reset):
        for i in range(B):
            one = State(**{f.name: getattr(batch, f.name)[i].clone()
                           for f in dataclasses.fields(State)})
            jone = JaxState(**{f.name: jnp.asarray(
                getattr(one, f.name).numpy())
                for f in dataclasses.fields(State)})
            out.append((one, jone))
    return out


def _close(got, want, atol, rtol=0.0, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


def test_forward_and_step_match_jax(envs, physics):
    jenv, penv = envs
    jforward = jax.jit(lambda s: jax_engine.forward(jenv.model, s))
    jstep = jax.jit(lambda s: jax_engine.step(jenv.model, s))
    n_active = 0
    for one, jone in physics:
        ctrl = torch.tensor([0.3, 12.0, -8.0])
        one, jone = one.replace(ctrl=ctrl), jone.replace(
            ctrl=jnp.asarray(ctrl.numpy()))
        qacc, aux = engine.forward(penv.model, one)
        jqacc, jaux = jforward(jone)
        _close(qacc, jqacc, 2e-3, 1e-4, "qacc")
        for k in range(2):
            _close(aux["efc_force"][k], jaux["efc_force"][k], 1e-3, 1e-4,
                   f"efc_force[{k}]")
        _close(aux["qfrc_constraint"], jaux["qfrc_constraint"], 2e-3, 1e-4,
               "qfrc_constraint")
        _close(aux["qacc_smooth"], jaux["qacc_smooth"], 1e-3, 1e-5,
               "qacc_smooth")
        _close(aux["contacts"].dist, jaux["contacts"].dist, 2e-6, 0, "dist")
        n_active += int((aux["contacts"].dist < 0).sum())
        new, jnew = engine.step(penv.model, one), jstep(jone)
        _close(new.qpos, jnew.qpos, 1e-6, 0, "qpos")
        _close(new.xpos, jnew.xpos, 1e-6, 0, "xpos")
        _close(new.qvel, jnew.qvel, 1e-4, 0, "qvel")
    assert n_active >= 4 * len(physics)


def _port_state(jstate):
    return interop.env_state_from_arrays(jax_env_state_arrays(jstate), "cpu")


def _obs_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    cols = [c for c in range(want.shape[-1]) if c != ANGLE]
    _close(got[cols], want[cols], atol)
    assert_angles_close(got[ANGLE], want[ANGLE], atol)


def test_env_step_and_step_autoreset_match_jax(envs):
    jenv, penv = envs
    jstep = jax.jit(jenv.step)
    jauto = jax.jit(jenv.step_autoreset)
    jfresh = jax.jit(lambda rng: jenv.reset_core(jax.random.split(rng)[1]))
    rng = np.random.default_rng(7)
    js = jenv.reset(jax.random.PRNGKey(5))
    js = js.replace(steps=jnp.asarray(jenv.config.max_episode_steps - 2,
                                      jnp.int32))
    for i in range(4):
        a = rng.uniform(-1, 1, 2).astype(np.float32)
        ps = _port_state(js)
        assert ps.obs.shape == (penv.obs_size,)
        got = penv.step(ps, torch.from_numpy(a))
        want = jstep(js, jnp.asarray(a))
        _obs_close(got.obs, want.obs, 1e-5)
        _close(got.reward, want.reward, 1e-5, 0, "reward")
        _close(got.physics.qpos, want.physics.qpos, 1e-6, 0, "qpos")
        fresh = _port_state(jfresh(js.rng))
        got = penv.step_autoreset(ps, torch.from_numpy(a), fresh=fresh)
        js = jauto(js, jnp.asarray(a))
        assert bool(got.done) == bool(js.done)
        assert int(got.steps) == int(js.steps)
        _obs_close(got.obs, js.obs, 1e-5)
        _obs_close(got.final_obs, js.final_obs, 1e-5)
        _close(got.physics.qpos, js.physics.qpos, 1e-6, 0, "qpos")
    # the second step truncated and the continuation is a fresh episode
    assert int(js.steps) == 2


@pytest.mark.parametrize("robot", [True, False])
def test_lidar_matches_jax(envs, physics, robot):
    jenv, penv = envs
    jlidar = jax.jit(lambda p, q: jax_raycast.lidar(
        jenv.model, p, q, include_robot_geoms=robot))
    for one, jone in physics:
        got = raycast.lidar(penv.model, one.xpos, one.xquat,
                            include_robot_geoms=robot)
        _close(got, jlidar(jone.xpos, jone.xquat), 1e-6, 0, "lidar")
        part = raycast.lidar(penv.model, one.xpos, one.xquat,
                             site_slice=slice(10, 20),
                             include_robot_geoms=robot)
        np.testing.assert_array_equal(part.numpy(), got[10:20].numpy())


def test_staged_dr_batch_matches_per_env_step():
    env = make_ackermann_env("maze", "umaze", device="cpu", seed=2,
                             dtype=torch.float64, reference_flat_manifold=True,
                             reference_wheel_patch=True, **SOLVER)
    base = env.model
    models = randomize_model(base, torch.Generator().manual_seed(4), B)
    # per-env joint ranges, the limited joints' shifted so that q = 0 lies
    # outside some envs'
    rng = base.jnt_range.expand((B,) + base.jnt_range.shape).clone()
    for d in base.limited_dofs:
        rng[:, base.dof_jnt[d]] += torch.linspace(
            -0.7, 0.7, B, dtype=torch.float64)[:, None]
    models = dataclasses.replace(models, jnt_range=rng)
    ph = wall_poses(env, B, torch.Generator().manual_seed(6),
                    sink=(0.005, 0.01))
    lo = torch.tensor([-0.6, -30.0, -30.0], dtype=torch.float64)
    u = torch.rand((B, 3), generator=torch.Generator().manual_seed(8),
                   dtype=torch.float64)
    ph = ph.replace(qvel=ph.qvel.double(), ctrl=lo - 2 * lo * u)
    fast = engine.step_batch(models, ph, base_model=base)
    leaves = engine.batched_field_dict(models, base)
    assert "jnt_range" in leaves and "wheel_friction" in leaves
    for i in range(B):
        m_env = dataclasses.replace(base, **{k: v[i] for k, v in
                                             leaves.items()})
        slow = engine.step(m_env, State(**{
            f.name: getattr(ph, f.name)[i] for f in dataclasses.fields(
                State)}))
        _close(fast.qpos[i], slow.qpos, 1e-10, 0, f"qpos env {i}")
        _close(fast.qvel[i], slow.qvel, 1e-8, 1e-10, f"qvel env {i}")
