"""The per-env observation under domain randomization against the JAX
package on the CPU (umaze, B=8, solver 4/3), on randomized leaves drawn by
JAX ``randomize_model`` and carried across; every randomized leaf differs
across envs.  (``test_torch_staged_dr.py`` holds the staged DR step; the
two files share its helpers.)

* ``DomainRandomizedEnv`` with ``spawn_heading_noise`` against JAX's over
  4 auto-reset steps, half the envs truncating first, with JAX's
  ``reset_core`` samples injected: K1e's twin without the fused spawn scan
  (forced to the pick, as JAX's CPU step makes it), then the merged state
  observed through K2's twin with each env's floor height; obs and
  final_obs 1e-4, reward 2e-5, qpos 1e-5, ``done`` exact.
* K2's twin with a per-env floor against JAX ``raycast.lidar`` under
  ``base_model.replace(plane_z=...)`` env by env, on frames pitched 8
  degrees down so that beams meet the floor: 1e-6 plus 2e-5 relative.  A
  beam that meets the floor at 8 degrees reads its height over the floor
  divided by the sine of its pitch, so the float32 rounding of the origin
  grows ~7x; the two scans build origin and direction by other formulas
  (measured: 8.9e-6 at 0.77 m, 5.0e-6 relative).  The env's scan of a
  batch with randomized scene boxes (the plain raycast, batched over each
  env's leaves) against JAX's per-env raycast on the same frames: the
  same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (autoreset_rollout, force_warmstart_pick,
                           obs_close, one_torch_thread,
                           truncate_half)  # noqa: F401
from mujoco_playground_tpu.envs.domain_randomization import \
    DomainRandomizedEnv as JaxDREnv
from mujoco_playground_tpu.envs.domain_randomization import \
    randomize_model as jax_randomize
from mujoco_playground_tpu.physics import raycast as jax_raycast
from mujoco_playground_tpu_torch.envs import DomainRandomizedEnv
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.physics import batchlast, mathutil
from test_torch_staged_dr import B, _envs, _port_models

SCAN_TOL = dict(atol=1e-6, rtol=2e-5)


def test_dr_with_heading_noise_autoreset_matches_jax(monkeypatch):
    knobs = dict(spawn_heading_noise=3.14159265)
    jenv, penv = _envs(**knobs)
    jdr = JaxDREnv(jenv, B, jax.random.PRNGKey(5))
    pdr = DomainRandomizedEnv(penv, B, torch.Generator().manual_seed(0))
    pdr.models = _port_models(jdr.models, jenv.model, penv)
    force_warmstart_pick(monkeypatch)
    floors = []
    lidar = k2.lidar
    monkeypatch.setattr(k2, "lidar", lambda *a, **kw: floors.append(
        a[3] if len(a) > 3 else kw.get("plane_z")) or lidar(*a, **kw))
    jstates = truncate_half(jax.jit(jax.vmap(jdr.reset))(
        jax.random.split(jax.random.PRNGKey(6), B)),
        jenv.config.max_episode_steps)

    def check(pstates, jstates):
        obs_close(pstates.obs.numpy(), np.asarray(jstates.obs), 1e-4)
        obs_close(pstates.final_obs.numpy(), np.asarray(jstates.final_obs),
                  1e-4)
        np.testing.assert_allclose(pstates.reward.numpy(),
                                   np.asarray(jstates.reward), atol=2e-5)
        np.testing.assert_allclose(pstates.physics.qpos.numpy(),
                                   np.asarray(jstates.physics.qpos),
                                   atol=1e-5)

    n_done = autoreset_rollout(
        jenv, jax.jit(jdr.step_autoreset_batch),
        lambda s, a, fresh: pdr.step_autoreset_batch(s, a, fresh=fresh),
        jstates, 4, seed=3, check=check)
    assert n_done >= B // 2
    # one K2 a step, on each env's own floor
    assert len(floors) == 4
    for z in floors:
        np.testing.assert_array_equal(z.numpy(), pdr.models.plane_z.numpy())


def test_per_env_floor_scan_matches_jax():
    jenv, penv = _envs()
    jm = jenv.model
    jmodels = jax_randomize(jm, jax.random.PRNGKey(9), B)
    jmodels = jmodels.replace(plane_z=jm.plane_z + jnp.linspace(
        -0.03, 0.03, B, dtype=jnp.float32))
    pmodels = _port_models(jmodels, jm, penv)
    states = penv.reset(B).physics
    # pitched 8 degrees down, so that beams meet the floor
    half = np.deg2rad(8.0) / 2
    pitch = torch.tensor([np.cos(half), 0.0, np.sin(half), 0.0],
                         dtype=torch.float32)
    qpos = states.qpos.clone()
    qpos[:, 3:7] = mathutil.quat_mul(qpos[:, 3:7], pitch.expand(B, 4))
    xpos, xquat = batchlast.fk_bl(penv.model, qpos.T)
    xpos = torch.stack([x.T for x in xpos], 1)
    xquat = torch.stack([x.T for x in xquat], 1)
    want = np.stack([np.asarray(jax_raycast.lidar(
        jm.replace(plane_z=jmodels.plane_z[i]), jnp.asarray(xpos[i].numpy()),
        jnp.asarray(xquat[i].numpy()))) for i in range(B)])
    got = k2.lidar(penv.model, xpos.reshape(B, -1).T.contiguous(),
                   xquat.reshape(B, -1).T.contiguous(), pmodels.plane_z).T
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)
    assert (want > 0).sum() > B * 10    # beams on the floor
    # the floor reached the scan: the same frames on the base floor differ
    base = k2.lidar(penv.model, xpos.reshape(B, -1).T.contiguous(),
                    xquat.reshape(B, -1).T.contiguous()).T
    assert float((base - got).abs().max()) > 1e-3
    # a randomized scene box routes the env's scan to the plain raycast,
    # batched over each env's leaves
    boxes = np.asarray(jm.scene_box_pos)[None] + np.linspace(
        -0.1, 0.1, B, dtype=np.float32)[:, None, None]
    jmodels = jmodels.replace(scene_box_pos=jnp.asarray(boxes))
    pmodels = _port_models(jmodels, jm, penv)
    want = np.stack([np.asarray(jax_raycast.lidar(
        jm.replace(plane_z=jmodels.plane_z[i],
                   scene_box_pos=jmodels.scene_box_pos[i]),
        jnp.asarray(xpos[i].numpy()), jnp.asarray(xquat[i].numpy())))
        for i in range(B)])
    got = penv._scan_batch(states.replace(xpos=xpos, xquat=xquat), pmodels,
                           penv.model)
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)
