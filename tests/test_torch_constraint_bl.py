"""The port's batch-last constraint assembly (``physics/constraint_bl.py``)
against the JAX package's ``make_efc_bl`` and against the port's own
``make_efc``, on the CPU with the same float32 inputs on both sides.

States: umaze reset states (the port's ``reset``, with random velocities)
on the default manifold (48 slots), and states pressed into the maze walls
and 1-2 cm into the floor on the compat manifolds (flat + wheel patch, 72
slots).  Both packages' assemblies get the same qpos, qvel, motion
subspace and contacts (the port's, held against JAX's in
tests/test_torch_staged.py), so that the comparison holds the assembly
alone.

* Against JAX's ``make_efc_bl``, per key: 1e-5 plus 1e-5 relative (as
  ``make_efc`` is held in tests/test_torch_staged.py); ``j_kind`` equal.
* Against the port's ``make_efc`` moved to the kernel layout
  (``solver_batched.newton_args`` then ``movedim``): the joint rows and
  flags bitwise; the Jacobians 1e-6 (sums in another order); ``c_aref4``
  1e-5 plus 1e-6 relative (the row velocity sums over the dofs in another
  order).
* ``newton_solve_plain(pre_transposed=True)`` on the kernel layout equals
  the row-major twin on the same arrays moved to row-major, bitwise, and
  ``engine.newton_inputs(kernel_layout=True)`` is the same system as
  ``engine.newton_inputs``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_model_arrays, one_torch_thread  # noqa: F401
from mujoco_playground_tpu.physics import collision as jcol
from mujoco_playground_tpu.physics import constraint_bl as jcbl
from mujoco_playground_tpu.physics.model import make_model as jax_make_model
from mujoco_playground_tpu.spec import ackermann_robot_v2 as jax_robot
from mujoco_playground_tpu.spec import pointmaze_scene as jax_pointmaze
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.envs.poses import wall_poses
from mujoco_playground_tpu_torch.ops import newton as k3
from mujoco_playground_tpu_torch.physics import (batchlast, collision,
                                                 constraint, constraint_bl,
                                                 engine, solver_batched)
from mujoco_playground_tpu_torch.physics.state import State

B = 8
KEYS = ("Gt", "j_aref", "j_R", "j_floss", "j_active", "Jnt", "Jt1t",
        "Jt2t", "c_aref4", "c_R", "c_mu", "c_active")
# the arrays of the kernel layout, in K3's argument order
K3_KEYS = ("Gt", "j_aref", "j_R", "j_floss", "j_active", "j_kind", "Jnt",
           "Jt1t", "Jt2t", "c_aref4", "c_R", "c_mu", "c_active")
TRANSPOSED = ("Gt", "Jnt", "Jt1t", "Jt2t", "c_aref4")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module", params=["reset", "compat"])
def case(request):
    """(JAX model, port model, qpos, qvel) of B states."""
    compat = request.param == "compat"
    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, device="cpu", seed=1,
                             reference_flat_manifold=compat,
                             reference_wheel_patch=compat)
    gen = torch.Generator().manual_seed(2)
    if compat:
        ph = wall_poses(env, B, gen, sink=(0.01, 0.02))
        qpos, qvel = ph.qpos, ph.qvel
    else:
        qpos = env.reset(B).physics.qpos
        qvel = 0.3 * torch.randn((B, env.model.nv), generator=gen)
    jm = jax_make_model(jax_robot(), jax_pointmaze("umaze"),
                        dtype=jnp.float32, solver_iterations=4,
                        ls_iterations=3, compat_flat_manifold=compat,
                        compat_wheel_patch=compat)
    pm = interop.model_from_arrays(jax_model_arrays(jm), device="cpu")
    return jm, pm, qpos.numpy(), qvel.numpy()


def _system(pm, q, v):
    """The port's frames, motion subspace (nv, 6, B) about anchor (3, B),
    mass matrix and contacts for (q, v)."""
    qpos, qvel = _t(q), _t(v)
    xpos, xquat = _port_frames(pm, qpos)
    M, _, S, anchor = batchlast.crba_bias_bl(
        pm, [xpos[:, b].T for b in range(pm.nbody)],
        [xquat[:, b].T for b in range(pm.nbody)], qvel.T, pm.gravity)
    return qpos, qvel, M, S, anchor, collision.collide(pm, xpos, xquat)


def _jax_contacts(c, B):
    """The port's contacts as JAX's vmapped Contacts ((B, C, ...) leaves;
    the slot statics repeated per env)."""
    a = lambda x: jnp.asarray(x.numpy())
    per_env = lambda x: jnp.asarray(x.expand((B,) + x.shape[1:]).numpy())
    return jcol.Contacts(pos=a(c.pos), frame=a(c.frame), dist=a(c.dist),
                         friction=per_env(c.friction),
                         solref=per_env(c.solref), solimp=per_env(c.solimp),
                         diag_approx=per_env(c.diag_approx), body=c.body)


def _port_frames(pm, qpos):
    """The port's batched FK: xpos (B, nbody, 3), xquat (B, nbody, 4)."""
    xpos_l, xquat_l = batchlast.fk_bl(pm, qpos.T)
    return (torch.stack([x.T for x in xpos_l], 1),
            torch.stack([x.T for x in xquat_l], 1))


def test_make_efc_bl_matches_jax(case):
    jm, pm, q, v = case
    _, _, _, S, anchor, c = _system(pm, q, v)
    want = jcbl.make_efc_bl(jm, jnp.asarray(q.T), jnp.asarray(v.T),
                            jnp.asarray(S.numpy()),
                            jnp.asarray(anchor.numpy()), _jax_contacts(c, B))
    got = constraint_bl.make_efc_bl(pm, _t(q.T), _t(v.T), S, anchor, c)
    np.testing.assert_array_equal(got["j_kind"], np.asarray(want["j_kind"]))
    for k in KEYS:
        assert got[k].is_contiguous(), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    assert float(got["c_active"].sum()) >= B       # rows in contact
    assert got["Jnt"].shape[1] == (72 if pm.compat_wheel_patch else 48)


def test_make_efc_bl_matches_make_efc(case):
    """The port's two assemblies of the same system (the port's own FK,
    subspace and contacts)."""
    _, pm, q, v = case
    qpos, qvel, M, S, anchor, contacts = _system(pm, q, v)
    got = constraint_bl.make_efc_bl(pm, qpos.T, qvel.T, S, anchor, contacts)
    efc = constraint.make_efc(pm, qpos, qvel, torch.movedim(S, -1, 0),
                              anchor.T, contacts)
    rows = solver_batched.newton_args(pm, M, torch.zeros((pm.nv, B)), efc)
    want = dict(zip(K3_KEYS, rows[2:15]))
    np.testing.assert_array_equal(got["j_kind"], want["j_kind"])
    for k in KEYS:
        w = torch.movedim(want[k], 0, 1) if k in TRANSPOSED else want[k]
        g = got[k]
        if k in ("Jnt", "Jt1t", "Jt2t"):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                       rtol=0, err_msg=k)
        elif k == "c_aref4":
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                       rtol=1e-6, err_msg=k)
        else:
            assert torch.equal(g, w), k


def test_kernel_layout_twin_and_newton_inputs(case):
    """The twin in the kernel layout equals the row-major twin bitwise, and
    the staged step's system in the kernel layout is the row-major one's,
    assembled batch-last (the same tolerances as above)."""
    _, pm, q, v = case
    qpos, qvel = _t(q), _t(v)
    xpos, xquat = _port_frames(pm, qpos)
    states = State(qpos=qpos, qvel=qvel, ctrl=torch.zeros((B, pm.nu)),
                   time=torch.zeros(B), xpos=xpos, xquat=xquat,
                   qacc_warmstart=torch.zeros((B, pm.nv)))
    kl = engine.newton_inputs(pm, states, kernel_layout=True)
    rm = engine.newton_inputs(pm, states)
    moved = [torch.movedim(a, 0, 1).contiguous() if i in (2, 8, 9, 10, 11)
             else a for i, a in enumerate(kl)]
    for i, (a, b) in enumerate(zip(moved, rm)):
        if i in (0, 1, 2, 3, 4, 5, 6, 12, 13, 14):
            assert torch.equal(a, b), i
        elif i == 7:
            np.testing.assert_array_equal(a, b)
        elif i in (8, 9, 10):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        elif i == 11:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-6)
        else:
            assert a == b
    ws = torch.randn((pm.nv, B), generator=torch.Generator().manual_seed(3))
    got = k3.newton_solve_plain(*kl, warmstart=ws, pre_transposed=True)
    want = k3.newton_solve_plain(*moved, warmstart=ws)
    assert torch.equal(got, want)
    # on CPU tensors the wrapper takes the twin, in either layout
    assert torch.equal(k3.newton_solve(*kl, warmstart=ws,
                                       pre_transposed=True), want)
    assert k3.newton_solve.launches_kernel_layout == 0


def test_randomized_model_is_refused(case):
    _, pm, q, v = case
    models = dataclasses.replace(
        pm, dof_damping=pm.dof_damping.expand(B, pm.nv).clone())
    qpos = _t(q)
    xpos, xquat = _port_frames(pm, qpos)
    contacts = collision.collide(pm, xpos, xquat)
    with pytest.raises(ValueError, match="randomized"):
        constraint_bl.make_efc_bl(
            models, qpos.T, _t(v).T, torch.zeros((pm.nv, 6, B)),
            torch.zeros((3, B)), contacts)


def test_staged_step_in_the_kernel_layout(case):
    """Two staged steps with the rows assembled in K3's layout against the
    staged step's own assembly, from the same states: qpos 1e-6, qvel 1e-5
    plus 1e-5 relative (the assemblies part by an ulp, the solve mixes
    every dof)."""
    _, pm, q, v = case
    qpos, qvel = _t(q), _t(v)
    xpos, xquat = _port_frames(pm, qpos)
    s_kl = s_rm = State(qpos=qpos, qvel=qvel,
                        ctrl=0.5 * torch.ones((B, pm.nu)),
                        time=torch.zeros(B), xpos=xpos, xquat=xquat,
                        qacc_warmstart=torch.zeros((B, pm.nv)))
    for _ in range(2):
        s_kl = engine.staged_step(pm, s_kl, kernel_layout=True)
        s_rm = engine.staged_step(pm, s_rm)
    np.testing.assert_allclose(s_kl.qpos.numpy(), s_rm.qpos.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(s_kl.qvel.numpy(), s_rm.qvel.numpy(),
                               atol=1e-5, rtol=1e-5)
    assert float((s_rm.qpos - qpos).abs().max()) > 1e-5
