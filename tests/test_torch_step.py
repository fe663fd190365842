"""The plain twins of kernels K1 (``ops/step.py``) and K2 (``ops/lidar.py``)
against the JAX package on the CPU, at B=8.

* ``step_plain(..., ws_compare=True)`` against JAX ``step_batch`` (the
  staged XLA step, which makes MuJoCo's two-sided warm-start pick) for 5
  chained steps from reset states with random actions: qpos, xpos and xquat
  at atol 1e-6, qvel at 1e-5, qacc at atol 1e-3 plus rtol 1e-4.  The
  qacc error of one env scales with the largest accelerations in the solve,
  not with its own: wheel dofs reach |qacc| ~ 4e3 in some envs, and a
  difference of 1e-7 relative to that (float32 rounding in the two sides'
  different summation orders) is 4e-4 on an entry of 0.65.
* The fused twin (env rows and the fresh-spawn scan) against JAX
  ``env.step_batch`` on the inputs of ``tests/test_fused_gate.py``.  With
  ``ws_compare=True`` (the pick the JAX CPU path makes) at that test's
  tolerances: qpos 1e-6, obs and reward 1e-5, goal distance 1e-6, flags
  exact; the fresh-spawn scan against ``raycast.lidar`` at the fresh pose,
  1e-5.  With ``ws_compare=False`` (the fused TPU step's start) qpos is held
  at 1e-4 and obs, reward and goal distance at 1e-4: on these inputs the
  JAX package's own fused and staged steps differ by 2.4e-5 on the wheel
  spin angles, because only the staged step makes the warm-start pick.  The
  ``ws_compare=False`` twin is held tightly against the JAX kernel itself
  in the slow test at the end.
* ``lidar_plain`` against ``raycast.lidar``, 1e-5.

Both sides run on the same float32 inputs; the port runs on the JAX model
carried across with ``interop.model_from_arrays``, after checking that its
own ``make_model`` gives the same leaves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_angles_close, assert_model_matches,
                           jax_model_arrays, rows)
from mujoco_playground_tpu.envs import make_ackermann_env
from mujoco_playground_tpu.physics import raycast
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.core.controller import \
    bicycle_cmd_vel_to_controls
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.physics.model import make_model
from mujoco_playground_tpu_torch.spec import (ackermann_robot_v2,
                                              pointmaze_scene)

B = 8
NS = 72


@pytest.fixture(scope="module")
def setup():
    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3)
    states = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(3), B))
    arrays = jax_model_arrays(env.model)
    own = make_model(ackermann_robot_v2(), pointmaze_scene("umaze"),
                     solver_iterations=4, ls_iterations=3, device="cpu")
    assert_model_matches(own, arrays)
    model = interop.model_from_arrays(arrays, device="cpu")
    return env, jax.jit(env.step_batch), states, model


def _t(a):
    return torch.from_numpy(rows(a))


def _ctrl(actions, env):
    a = torch.tensor(np.asarray(actions, np.float32))
    cfg = env.config
    return bicycle_cmd_vel_to_controls(a[:, 0] * cfg.max_linear_velocity,
                                       a[:, 1] * cfg.max_angular_velocity)


def _env_statics(env):
    return env._env_statics()


def test_step_plain_ws_compare_matches_staged_step(setup):
    env, jstep, states, model = setup
    rng = np.random.default_rng(0)
    phys = states.physics
    q, v = _t(phys.qpos), _t(phys.qvel)
    ws = _t(phys.qacc_warmstart)
    for _ in range(5):
        actions = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        ctrl = _ctrl(actions, env)
        states = jstep(states, jnp.asarray(actions))
        ref = states.physics
        np.testing.assert_allclose(ctrl.numpy(), np.asarray(ref.ctrl),
                                   atol=1e-5, rtol=1e-6)
        q, v, xpos, xquat, ws = k1.step_plain(
            model, q, v, ctrl.T.contiguous(), ws, ws_compare=True)
        np.testing.assert_allclose(q.numpy(), rows(ref.qpos), atol=1e-6)
        np.testing.assert_allclose(v.numpy(), rows(ref.qvel), atol=1e-5)
        np.testing.assert_allclose(xpos.numpy(), rows(ref.xpos), atol=1e-6)
        np.testing.assert_allclose(xquat.numpy(), rows(ref.xquat),
                                   atol=1e-6)
        np.testing.assert_allclose(ws.numpy(), rows(ref.qacc_warmstart),
                                   atol=1e-3, rtol=1e-4)


def _env_in(states, fresh_xy):
    return np.concatenate([
        np.asarray(states.odom_ref.position[:, :2], np.float32),
        np.asarray(states.goal, np.float32),
        np.asarray(states.prev_goal_distance, np.float32)[:, None],
        np.asarray(fresh_xy, np.float32)], axis=-1)


def _fresh_statics(env):
    t = env._template
    return (tuple(tuple(float(v) for v in r) for r in np.asarray(t.xpos)),
            tuple(tuple(float(v) for v in r) for r in np.asarray(t.xquat)),
            (float(t.qpos[0]), float(t.qpos[1])))


def _check_slab(slab, want_obs, want_reward, want_gd, want_coll, want_term,
                atol_obs=1e-5, atol_gd=1e-6):
    ns = NS
    np.testing.assert_allclose(slab[:ns + 6].T, want_obs[:, :ns + 6],
                               atol=atol_obs)
    assert_angles_close(slab[ns + 6], want_obs[:, ns + 6], atol_obs)
    np.testing.assert_allclose(slab[ns + 7], want_reward, atol=atol_obs)
    np.testing.assert_allclose(slab[ns + 8], want_gd, atol=atol_gd)
    np.testing.assert_array_equal(slab[ns + 10] > 0.5, want_coll)
    np.testing.assert_array_equal(slab[ns + 11] > 0.5, want_term)


@pytest.mark.parametrize("ws_compare", [True, False])
def test_fused_twin_matches_env_step_batch(setup, ws_compare):
    env, jstep, states, model = setup
    actions = jax.random.uniform(jax.random.PRNGKey(7), (B, 2), jnp.float32,
                                 -1.0, 1.0)
    fresh = jax.vmap(env.reset_core)(
        jax.random.split(jax.random.PRNGKey(11), B))
    fresh_xy = np.asarray(fresh.physics.xpos[:, 1, :2], np.float32)
    ref = jstep(states, actions)

    phys = states.physics
    outs = k1.step_plain(
        model, _t(phys.qpos), _t(phys.qvel),
        _ctrl(actions, env).T.contiguous(), _t(phys.qacc_warmstart),
        env_in=_t(_env_in(states, fresh_xy)), env_statics=_env_statics(env),
        fresh_statics=_fresh_statics(env), ws_compare=ws_compare)
    tol = (dict(qpos=1e-6, obs=1e-5, gd=1e-6) if ws_compare
           else dict(qpos=1e-4, obs=1e-4, gd=1e-4))
    np.testing.assert_allclose(outs[0].numpy(), rows(ref.physics.qpos),
                               atol=tol["qpos"])
    slab = outs[5].numpy()
    assert slab.shape == (2 * NS + 12, B)
    _check_slab(slab, np.asarray(ref.obs), np.asarray(ref.reward),
                np.asarray(ref.goal_distance), np.asarray(ref.collision),
                np.asarray(ref.terminated), tol["obs"], tol["gd"])
    # the fresh-spawn scan against the raycast at the fresh pose
    want = jax.vmap(lambda xp, xq: raycast.lidar(env.model, xp, xq))(
        fresh.physics.xpos, fresh.physics.xquat)
    np.testing.assert_allclose(slab[NS + 12:].T, np.asarray(want), atol=1e-5)
    assert (np.asarray(want) > 0).any()


def test_lidar_plain_matches_raycast(setup):
    env, jstep, states, model = setup
    p = states.physics
    # spin the frames about the chassis so beams meet walls at new angles
    ang = np.linspace(0, 2 * np.pi, B, endpoint=False, dtype=np.float32)
    qz = np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)], -1)
    xquat = np.asarray(p.xquat, np.float32).copy()
    w1, v1 = qz[:, :1], qz[:, 1:]
    w2, v2 = xquat[:, 1, :1], xquat[:, 1, 1:]
    xquat[:, 1, :1] = w1 * w2 - np.sum(v1 * v2, -1, keepdims=True)
    xquat[:, 1, 1:] = w1 * v2 + w2 * v1 + np.cross(v1, v2)
    xpos = np.asarray(p.xpos, np.float32)
    want = np.asarray(jax.vmap(lambda xp, xq: raycast.lidar(
        env.model, xp, xq))(jnp.asarray(xpos), jnp.asarray(xquat)))
    got = k2.lidar(model, _t(xpos), _t(xquat))
    assert got.shape == (NS, B)
    np.testing.assert_allclose(got.numpy().T, want, atol=1e-5)
    assert (want > 0).any()
    assert got is not None and k2.lidar.launches == 0   # the CPU twin ran


@pytest.mark.slow
def test_fused_twin_matches_pallas_kernel_interpret(setup):
    """The fused twin against the JAX kernel itself (interpret mode)."""
    from mujoco_playground_tpu.ops import step_pallas
    env, jstep, states, model = setup
    actions = jax.random.uniform(jax.random.PRNGKey(7), (B, 2), jnp.float32,
                                 -1.0, 1.0)
    fresh = jax.vmap(env.reset_core)(
        jax.random.split(jax.random.PRNGKey(11), B))
    fresh_xy = np.asarray(fresh.physics.xpos[:, 1, :2], np.float32)
    env_in = _env_in(states, fresh_xy)
    ctrl = _ctrl(actions, env)
    phys = states.physics
    fn = step_pallas.build_step_fn(
        env.model, 4, 3, block_b=B, interpret=True,
        with_env=_env_statics(env), with_fresh=env._fresh_statics())
    jq, jv, jxp, jxq, jqacc, jslab = fn(
        phys.qpos, phys.qvel, jnp.asarray(ctrl.numpy()),
        jnp.asarray(env_in), warmstart=phys.qacc_warmstart)
    outs = k1.step_plain(
        model, _t(phys.qpos), _t(phys.qvel), ctrl.T.contiguous(),
        _t(phys.qacc_warmstart), env_in=_t(env_in),
        env_statics=_env_statics(env), fresh_statics=_fresh_statics(env),
        ws_compare=False)
    np.testing.assert_allclose(outs[0].numpy(), rows(jq), atol=1e-6)
    np.testing.assert_allclose(outs[1].numpy(), rows(jv), atol=1e-5)
    np.testing.assert_allclose(outs[2].numpy(), rows(jxp), atol=1e-6)
    np.testing.assert_allclose(outs[3].numpy(), rows(jxq), atol=1e-6)
    np.testing.assert_allclose(outs[4].numpy(), rows(jqacc), atol=1e-4,
                               rtol=1e-4)
    jslab = np.asarray(jslab, np.float32).T
    slab = outs[5].numpy()
    np.testing.assert_allclose(slab[:NS + 6], jslab[:NS + 6], atol=1e-5)
    assert_angles_close(slab[NS + 6], jslab[NS + 6], 1e-5)
    np.testing.assert_allclose(slab[NS + 7:], jslab[NS + 7:], atol=1e-5)
