"""The port's random spawn heading (``spawn_heading_noise``) against the JAX
package on the CPU (umaze with the solved-task knobs: heading noise pi,
geodesic shaping 10 and the compass; B=8).

* ``rotate_spawn`` fed the yaw JAX's ``reset_core`` drew (its own key
  split replayed), and ``maze_core`` with it at JAX's spawn and goal, on
  JAX's settle template, against JAX's reset state: qpos, qvel, xpos,
  xquat and the goal within 1e-6.
* The port's reset: the observed heading is each spawn's yaw, the yaws
  cover the circle, the compass is a unit vector.
* Three auto-reset steps against JAX's ``step_autoreset_batch`` with JAX's
  ``reset_core`` samples injected, half the envs truncating on the first:
  the merged state observed through K2's twin; obs and final_obs within
  1e-4 (the compass 1e-5), reward within 2e-5, ``done`` exact, qpos 1e-5.
  The port's twin makes MuJoCo's warm-start pick here, as JAX's CPU step
  does (``force_warmstart_pick``): one rotated spawn meets a contact-set
  change on these inputs, where the fused step without the pick parts
  from JAX's by 3e-4 in qpos (measured; 6e-8 with the pick).
* Under heading noise K1 never gets the fused spawn scan (it bakes the
  template's heading): every K1 call of the auto-reset has no fresh
  statics, K2 runs once a step, and a reset env's observed heading is its
  rotated spawn's.
* Domain randomization with heading noise steps: K1e without the fused
  spawn scan, then K2 with each env's floor on the merged state.
"""
import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (autoreset_rollout, force_warmstart_pick,
                           jax_model_arrays, obs_close, one_torch_thread,
                           truncate_half)  # noqa: F401
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import (DomainRandomizedEnv,
                                              make_ackermann_env)
from mujoco_playground_tpu_torch.envs.ackermann_env import rotate_spawn
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.physics.mathutil import quat_to_yaw
from mujoco_playground_tpu_torch.physics.state import State

B = 8
LIM = math.pi
KNOBS = dict(spawn_heading_noise=LIM, geodesic_reward_scale=10.0,
             goal_compass=True, solver_iterations=4, ls_iterations=3)
HEADING = 74   # the heading column of an observation


@pytest.fixture(scope="module")
def envs():
    jenv = jax_make_env("maze", "umaze", **KNOBS)
    penv = make_ackermann_env("maze", "umaze", device="cpu", **KNOBS)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    return jenv, penv


def _jax_yaw_draws(keys, dtype=jnp.float32):
    """The spawn yaws JAX's ``reset_core`` draws from each key."""
    def one(key):
        k_yaw = jax.random.split(key, 5)[4]
        return jax.random.uniform(k_yaw, (), dtype, -LIM, LIM)
    return np.asarray(jax.vmap(one)(keys))


def test_rotation_matches_jax_reset_core(envs):
    jenv, penv = envs
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = jax.jit(jax.vmap(jenv.reset_core))(keys)
    th = torch.tensor(_jax_yaw_draws(keys))
    tpl = State(**{f.name: torch.tensor(np.asarray(
        getattr(jenv._template, f.name), np.float32))
        for f in dataclasses.fields(State)})
    got = rotate_spawn(tpl, th)
    yaw = quat_to_yaw(got.xquat[:, 1]).numpy()
    turn = np.angle(np.exp(1j * (yaw - jenv._heading0 - th.numpy())))
    np.testing.assert_allclose(turn, 0.0, atol=1e-5)
    # placed at JAX's spawn and goal through maze_core, on JAX's template
    env = copy.copy(penv)
    env._template = tpl
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    start_xy = t(want.physics.qpos[:, :2])
    goal_xy = t(np.asarray(want.goal, np.float64)
                + np.asarray(want.physics.xpos[:, 1, :2], np.float64))
    got = env.maze_core(start_xy, goal_xy, t(want.goal_cell), th)
    for name in ("qpos", "qvel", "xpos", "xquat"):
        np.testing.assert_allclose(getattr(got.physics, name).numpy(),
                                   np.asarray(getattr(want.physics, name)),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.goal.numpy(), np.asarray(want.goal),
                               atol=1e-6)
    np.testing.assert_array_equal(got.goal_cell.numpy(),
                                  np.asarray(want.goal_cell))


def test_reset_spawns_at_random_headings(envs):
    _, penv = envs
    s = penv.reset(64, generator=torch.Generator().manual_seed(5))
    yaw = quat_to_yaw(s.physics.xquat[:, 1]).numpy()
    np.testing.assert_allclose(s.obs[:, HEADING].numpy(), yaw, atol=1e-6)
    assert np.ptp(yaw) > 5.5
    assert s.obs.shape == (64, 81)
    np.testing.assert_allclose(s.obs[:, 79:81].norm(dim=-1).numpy(), 1.0,
                               atol=1e-5)


def test_autoreset_with_heading_noise_matches_jax(envs, monkeypatch):
    jenv, penv = envs
    force_warmstart_pick(monkeypatch)
    jstates = truncate_half(jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(6), B)),
        jenv.config.max_episode_steps)

    def check(p, j):
        assert p.obs.shape == p.final_obs.shape == (B, 81)
        obs_close(p.final_obs.numpy(), j.final_obs, 1e-4, compass_atol=1e-5)
        obs_close(p.obs.numpy(), j.obs, 1e-4, compass_atol=1e-5)
        np.testing.assert_allclose(p.reward.numpy(), np.asarray(j.reward),
                                   atol=2e-5)
        np.testing.assert_allclose(p.physics.qpos.numpy(),
                                   np.asarray(j.physics.qpos), atol=1e-5)

    n_done = autoreset_rollout(jenv, jax.jit(jenv.step_autoreset_batch),
                               penv.step_autoreset_batch, jstates, 3, 2,
                               check)
    assert n_done >= B // 2


def test_heading_noise_never_takes_the_fused_spawn_scan(envs, monkeypatch):
    _, penv = envs
    calls = []
    step_fused, lidar = k1.step_fused, k2.lidar

    def spy_step(*a, **kw):
        calls.append(("K1", kw.get("fresh_statics")))
        return step_fused(*a, **kw)

    def spy_lidar(*a, **kw):
        calls.append(("K2", None))
        return lidar(*a, **kw)

    monkeypatch.setattr(k1, "step_fused", spy_step)
    monkeypatch.setattr(k2, "lidar", spy_lidar)
    s = penv.reset(B, generator=torch.Generator().manual_seed(1))
    s = s.replace(steps=torch.where(torch.arange(B) % 2 == 0,
                                    penv.config.max_episode_steps - 1, 0
                                    ).to(s.steps.dtype))
    del calls[:]
    actions = torch.zeros((B, 2))
    s = penv.step_autoreset_batch(s, actions)
    # the even envs were reset: their observation is the merged state's,
    # at the rotated spawn's heading (a template-baked scan would observe
    # the template's)
    assert s.done.tolist() == [True, False] * (B // 2)
    yaw = quat_to_yaw(s.physics.xquat[:, 1])
    np.testing.assert_allclose(s.obs[:, HEADING].numpy(), yaw.numpy(),
                               atol=1e-6)
    turned = np.angle(np.exp(1j * (yaw[::2].numpy() - penv._heading0)))
    assert np.abs(turned).max() > 0.5
    s = penv.step_autoreset_batch(s, actions)
    assert calls == [("K1", None), ("K2", None)] * 2, calls


def test_domain_randomization_with_heading_noise_steps(envs, monkeypatch):
    """DR with heading noise: K1e without the fused spawn scan, then the
    merged state observed through K2 with each env's floor; a reset env's
    observed heading is its rotated spawn's.  (``test_torch_dr_observe.py``
    holds the same against JAX.)"""
    _, penv = envs
    dr = DomainRandomizedEnv(penv, 4, torch.Generator().manual_seed(0))
    calls = []
    step_fused, lidar = k1.step_fused, k2.lidar
    monkeypatch.setattr(k1, "step_fused", lambda *a, **kw: calls.append(
        ("K1e" if kw.get("dr_params") is not None else "K1",
         kw.get("fresh_statics"))) or step_fused(*a, **kw))
    monkeypatch.setattr(k2, "lidar", lambda *a, **kw: calls.append(
        ("K2", None if len(a) < 4 else a[3])) or lidar(*a, **kw))
    s = dr.reset()
    s = s.replace(steps=torch.full_like(s.steps,
                                        penv.config.max_episode_steps - 1))
    calls.clear()
    s = dr.step_autoreset_batch(s, torch.zeros((4, 2)))
    assert [c[0] for c in calls] == ["K1e", "K2"] and calls[0][1] is None
    assert calls[1][1] is dr.models.plane_z
    assert bool(s.done.all()) and bool(torch.isfinite(s.obs).all())
    yaw = quat_to_yaw(s.physics.xquat[:, 1])
    np.testing.assert_allclose(s.obs[:, HEADING].numpy(), yaw.numpy(),
                               atol=1e-6)
