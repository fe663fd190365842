"""The stages of the staged step (path B: kernel K3's twin and the modules
around it) against the JAX package on the CPU, with the same float32 inputs
on both sides (the whole step and the compat env are in
``test_torch_staged_step.py``).

* ``cholesky_bl``/``cho_solve_bl`` on random SPD stacks, and
  ``crba_bias_bl`` on umaze states: 1e-5 relative to each output's scale.
* ``collide`` for the default manifold, the flat manifold and the wheel
  patch (48/48/72 slots on the umaze arena, 40/40/52 on the wall scene of
  ``test_compat_manifolds.py``, rebuilt here), on poses spread over the
  arena, tilted, on a wall and flipped flat: positions, frames and
  distances 2e-6, the slot statics exactly.
* ``make_efc`` on JAX's contacts: 1e-5 plus 1e-5 relative.
* ``solve_batched`` (the K3 twin) against JAX ``solve_batched``: qacc atol
  1e-3 plus rtol 1e-4, as the K1 twin's qacc (wheel dofs reach |qacc| ~
  1e3 and the two sides sum in different orders); ``final_forces`` at the
  solution against JAX's forces.
* (slow) the K3 twin against ``newton_solve_pallas(..., interpret=True)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_model_arrays
from mujoco_playground_tpu.physics import batchlast as jbl
from mujoco_playground_tpu.physics import collision as jcol
from mujoco_playground_tpu.physics import constraint as jcon
from mujoco_playground_tpu.physics import kinematics as jkin
from mujoco_playground_tpu.physics import linalg_small as jlin
from mujoco_playground_tpu.physics import solver_batched as jsol
from mujoco_playground_tpu.physics.model import make_model as jax_make_model
from mujoco_playground_tpu.spec import ackermann_robot_v2 as jax_robot
from mujoco_playground_tpu.spec import pointmaze_scene as jax_pointmaze
from mujoco_playground_tpu.spec.scene import SceneSpec as JaxScene
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.physics import (batchlast, collision,
                                                 constraint, linalg_small,
                                                 solver_batched)

B = 8
MANIFOLDS = {"default": (False, False), "flat": (True, False),
             "patch": (False, True)}


def _wall_scene():
    return JaxScene(name="wall", floor_z=-10.0,
                    box_pos=np.array([[0.5, 0.0, 0.0]]),
                    box_size=np.array([[0.1, 1.0, 10.0]]))


def _models(scene, flat, patch):
    jm = jax_make_model(jax_robot(), scene, dtype=jnp.float32,
                        solver_iterations=4, ls_iterations=3,
                        compat_flat_manifold=flat, compat_wheel_patch=patch)
    return jm, interop.model_from_arrays(jax_model_arrays(jm), device="cpu")


@pytest.fixture(scope="module")
def umaze():
    return {k: _models(jax_pointmaze("umaze"), *v)
            for k, v in MANIFOLDS.items()}


@pytest.fixture(scope="module")
def wall():
    return {k: _models(_wall_scene(), *v) for k, v in MANIFOLDS.items()}


def _poses(jm, wall_scene):
    """B poses: spread over the arena (umaze) or along the wall, yawed,
    tilted, and two flipped flat (chassis upside down at rest height)."""
    rng = np.random.default_rng(0)
    q = np.tile(np.asarray(jm.qpos0, np.float32), (2 * B, 1))
    floor = float(jm.plane_z)
    if wall_scene:
        q[:, 0] = 0.26 + 0.01 * rng.uniform(-1, 1, 2 * B)
        q[:, 1] = rng.uniform(-0.3, 0.3, 2 * B)
        q[:, 2] = 0.0
        yaw = rng.uniform(-0.3, 0.3, 2 * B)
    else:
        q[:, :2] = rng.uniform(-1.4, 1.4, (2 * B, 2))
        q[:, 2] = floor + 0.045
        yaw = rng.uniform(-np.pi, np.pi, 2 * B)
    tilt = rng.uniform(-0.6, 0.6, (2 * B, 2))
    half = 0.5 * np.sqrt(yaw ** 2 + (tilt ** 2).sum(1))
    axis = np.stack([tilt[:, 0], tilt[:, 1], yaw], 1)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    q[:, 3] = np.cos(half)
    q[:, 4:7] = np.sin(half)[:, None] * axis
    q[:2, 2] = (floor if not wall_scene else 0.0) + 0.05
    q[:2, 3:7] = [0.0, 1.0, 0.0, 0.0]
    q[:, 7:] = rng.uniform(-0.3, 0.3, (2 * B, q.shape[1] - 7))
    qj = jnp.asarray(q)
    xpos, xquat = jax.vmap(lambda x: jkin.fk(jm, x))(qj)
    return q, np.asarray(xpos, np.float32), np.asarray(xquat, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_cholesky_and_solve_bl_match_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(12, 12, B)).astype(np.float32)
    spd = np.einsum("ikB,jkB->ijB", A, A) + 12 * np.eye(12)[:, :, None]
    spd = spd.astype(np.float32)
    b = rng.normal(size=(12, B)).astype(np.float32)
    jL = jlin.cholesky_bl(jnp.asarray(spd))
    L = linalg_small.cholesky_bl(_t(spd))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-5,
                               atol=1e-5)
    x = linalg_small.cho_solve_bl(L, _t(b))
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jlin.cho_solve_bl(jL, jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.einsum("ijB,jB->iB", spd, x.numpy()), b,
                               atol=1e-4)


def test_crba_bias_bl_matches_jax(umaze):
    jm, pm = umaze["default"]
    q, xpos, xquat = _poses(jm, False)
    qvel = np.random.default_rng(2).normal(size=(2 * B, 12)).astype(
        np.float32)
    jout = jbl.crba_bias_bl(jm, [jnp.asarray(xpos[:, b].T)
                                 for b in range(jm.nbody)],
                            [jnp.asarray(xquat[:, b].T)
                             for b in range(jm.nbody)],
                            jnp.asarray(qvel.T), np.asarray(jm.gravity))
    pout = batchlast.crba_bias_bl(pm, [_t(xpos[:, b].T)
                                       for b in range(pm.nbody)],
                                  [_t(xquat[:, b].T)
                                   for b in range(pm.nbody)],
                                  _t(qvel.T), pm.gravity)
    for name, got, want in zip(("M", "bias", "S", "anchor"), pout, jout):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                   err_msg=name)


def _jax_contacts(jm, xpos, xquat):
    return jax.vmap(lambda p, r: jcol.collide(jm, p, r))(
        jnp.asarray(xpos), jnp.asarray(xquat))


@pytest.mark.parametrize("arena,manifold,slots", [
    ("umaze", "default", 48), ("umaze", "flat", 48), ("umaze", "patch", 72),
    ("wall", "default", 40), ("wall", "flat", 40), ("wall", "patch", 52)])
def test_collide_matches_jax(umaze, wall, arena, manifold, slots):
    jm, pm = (umaze if arena == "umaze" else wall)[manifold]
    _, xpos, xquat = _poses(jm, arena == "wall")
    want = _jax_contacts(jm, xpos, xquat)
    got = collision.collide(pm, _t(xpos), _t(xquat))
    assert got.dist.shape == (2 * B, slots) == want.dist.shape
    np.testing.assert_array_equal(got.body, np.asarray(want.body))
    for name in ("dist", "pos", "frame"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=2e-6, err_msg=name)
    for name in ("friction", "solref", "solimp", "diag_approx"):
        np.testing.assert_array_equal(
            np.broadcast_to(getattr(got, name).numpy(),
                            np.asarray(getattr(want, name)).shape),
            np.asarray(getattr(want, name), np.float32), err_msg=name)
    # the poses reach every kind of contact: wheels and hulls on the plane
    # or on boxes
    assert (np.asarray(want.dist) < 0).sum() >= 8


def _port_contacts(c):
    a = lambda x: _t(np.asarray(x))
    return collision.Contacts(
        pos=a(c.pos), frame=a(c.frame), dist=a(c.dist),
        friction=a(c.friction[0]), solref=a(c.solref[0]),
        solimp=a(c.solimp[0]), diag_approx=a(c.diag_approx[0]),
        body=np.asarray(c.body))


def _system(jm, arena_wall):
    """JAX's contacts, rows and smooth dynamics of the test poses."""
    q, xpos, xquat = _poses(jm, arena_wall)
    qvel = 0.1 * np.random.default_rng(3).normal(size=(2 * B, 12)).astype(
        np.float32)
    M, bias, S, anchor = jbl.crba_bias_bl(
        jm, [jnp.asarray(xpos[:, b].T) for b in range(jm.nbody)],
        [jnp.asarray(xquat[:, b].T) for b in range(jm.nbody)],
        jnp.asarray(qvel.T), np.asarray(jm.gravity))
    S_env, anchor_env = jnp.moveaxis(S, -1, 0), anchor.T
    c = _jax_contacts(jm, xpos, xquat)
    mask = jnp.asarray(jkin.ancestor_mask(jm), jnp.float32)
    efc = jax.vmap(lambda qq, vv, s, an, cc: jcon.make_efc(
        jm, qq, vv, s, mask, an, cc))(jnp.asarray(q), jnp.asarray(qvel),
                                      S_env, anchor_env, c)
    return q, qvel, M, bias, S_env, anchor_env, c, efc


@pytest.mark.parametrize("manifold", ["default", "patch"])
def test_make_efc_matches_jax(wall, manifold):
    jm, pm = wall[manifold]
    q, qvel, _, _, S, anchor, c, want = _system(jm, True)
    got = constraint.make_efc(pm, _t(q), _t(qvel), _t(S), _t(anchor),
                              _port_contacts(c))
    for name in ("j_dof1", "j_dof2", "j_kind"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    for name in ("j_coef1", "j_coef2", "j_aref", "j_R", "j_floss",
                 "j_active", "c_Jn", "c_Jt1", "c_Jt2", "c_aref", "c_R",
                 "c_mu", "c_active"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert float(np.asarray(want.c_active).sum()) >= 2 * B


def _port_efc(e):
    a = lambda x: _t(np.asarray(x))
    return constraint.Efc(
        j_dof1=np.asarray(e.j_dof1), j_dof2=np.asarray(e.j_dof2),
        j_kind=np.asarray(e.j_kind), j_coef1=a(e.j_coef1),
        j_coef2=a(e.j_coef2), j_aref=a(e.j_aref), j_R=a(e.j_R),
        j_floss=a(e.j_floss), j_active=a(e.j_active), c_Jn=a(e.c_Jn),
        c_Jt1=a(e.c_Jt1), c_Jt2=a(e.c_Jt2), c_aref=a(e.c_aref),
        c_R=a(e.c_R), c_mu=a(e.c_mu), c_active=a(e.c_active))


def test_solve_batched_matches_jax(wall):
    jm, pm = wall["patch"]
    _, _, M, bias, _, _, _, efc = _system(jm, True)
    Menv = jnp.moveaxis(M, -1, 0)
    rng = np.random.default_rng(4)
    a_s = rng.normal(size=(2 * B, 12)).astype(np.float32)
    ws = (a_s + 0.1 * rng.normal(size=a_s.shape)).astype(np.float32)
    want, (wfj, wf4, wqfrc) = jsol.solve_batched(
        jm, Menv, jnp.asarray(a_s), efc, warmstart=jnp.asarray(ws),
        use_pallas=False)
    port_efc = _port_efc(efc)
    got = solver_batched.solve_batched(pm, _t(Menv), _t(a_s), port_efc,
                                       warmstart=_t(ws))
    fj, f4, qfrc = solver_batched.final_forces(port_efc, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(qfrc.numpy(), np.asarray(wqfrc), atol=1e-2,
                               rtol=1e-4)
    assert fj.shape == wfj.shape and f4.shape == wf4.shape


@pytest.mark.slow
def test_newton_twin_matches_pallas_kernel_interpret(wall):
    """The K3 twin against the JAX kernel itself (interpret mode)."""
    from mujoco_playground_tpu.ops import newton_pallas
    from mujoco_playground_tpu_torch.ops import newton as k3
    jm, pm = wall["patch"]
    _, _, M, _, _, _, _, efc = _system(jm, True)
    rng = np.random.default_rng(8)
    a_s = rng.normal(size=(12, 2 * B)).astype(np.float32)
    ws = (a_s + 0.1 * rng.normal(size=a_s.shape)).astype(np.float32)
    e = jsol._transpose_efc(efc, 12)
    want = newton_pallas.newton_solve_pallas(
        M, jnp.asarray(a_s), e["G"], e["j_aref"], e["j_R"], e["j_floss"],
        e["j_active"], efc.j_kind, e["Jn"], e["Jt1"], e["Jt2"],
        e["c_aref"], e["c_R"], e["c_mu"], e["c_active"], 4, 3,
        block_b=2 * B, interpret=True, warmstart=jnp.asarray(ws))
    got = k3.newton_solve_plain(
        _t(M), _t(a_s), *(_t(e[k]) for k in ("G", "j_aref", "j_R", "j_floss",
                                             "j_active")),
        np.asarray(efc.j_kind),
        *(_t(e[k]) for k in ("Jn", "Jt1", "Jt2", "c_aref", "c_R", "c_mu",
                             "c_active")), 4, 3, warmstart=_t(ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-4)
