"""The staged DR fallback against the JAX package on the CPU (umaze, B=8,
solver 4/3), on randomized leaves drawn by JAX ``randomize_model`` and carried
across (``interop.randomized_model_from_arrays`` takes any leaf with an
env axis).  Every randomized leaf differs across envs, so a leaf indexed
along its env axis by mistake fails these checks.

* The staged DR step (``engine.step_batch(models, s, base_model=m)``)
  against JAX's (its ``assemble_dr`` path) for 3 chained steps from JAX's
  states, each step from JAX's state: with the default randomization over
  the compat manifolds (flat manifold and wheel patch), on wall poses;
  and with the default manifolds, the default randomization and per-env
  joint ranges shifted so that the steering limit binds in some envs.
  qpos and xpos 1e-6, qvel 1e-4 (the tolerances of ``test_torch_dr.py``'s
  step; both sides make MuJoCo's warm-start pick), and K3 (its twin here)
  on every step, K1 never.

The per-env observation under domain randomization (with heading noise,
K2 with each env's floor, the batched raycast) is held in
``test_torch_dr_observe.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_model_arrays, one_torch_thread  # noqa: F401
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.envs.domain_randomization import \
    randomize_model as jax_randomize
from mujoco_playground_tpu.physics import engine as jax_engine
from mujoco_playground_tpu.physics.state import State as JaxState
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.envs.poses import wall_poses
from mujoco_playground_tpu_torch.ops import newton as k3
from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.physics import engine

B = 8
SOLVER = dict(solver_iterations=4, ls_iterations=3)
COMPAT = dict(reference_flat_manifold=True, reference_wheel_patch=True)


def _envs(**knobs):
    jenv = jax_make_env("maze", "umaze", **SOLVER, **knobs)
    penv = make_ackermann_env("maze", "umaze", device="cpu", seed=3,
                              **SOLVER, **knobs)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    return jenv, penv


def _port_models(jmodels, jbase, penv):
    leaves = {name: np.asarray(leaf, np.float32) for name, leaf in
              jax_engine.batched_field_dict(jmodels, jbase).items()}
    return interop.randomized_model_from_arrays(penv.model, leaves)


def _jax_state(state):
    return JaxState(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                       for f in dataclasses.fields(state)})


def _shifted_ranges(jm):
    """Per-env joint ranges: the limited joints' ranges shifted by -0.7 ..
    0.7 rad across the envs, so that q = 0 lies outside some envs'."""
    shift = np.zeros((B,) + np.asarray(jm.jnt_range).shape, np.float32)
    for d in jm.limited_dofs:
        shift[:, jm.dof_jnt[d], :] = np.linspace(-0.7, 0.7, B)[:, None]
    return jnp.asarray(np.asarray(jm.jnt_range)[None] + shift)


@pytest.mark.parametrize("case", ["compat", "jnt_range"])
def test_staged_dr_step_matches_jax(case, monkeypatch):
    jenv, penv = _envs(**(COMPAT if case == "compat" else {}))
    jm = jenv.model
    jmodels = jax_randomize(jm, jax.random.PRNGKey(7), B)
    if case == "jnt_range":
        jmodels = jmodels.replace(jnt_range=_shifted_ranges(jm))
    pmodels = _port_models(jmodels, jm, penv)
    names = sorted(engine.batched_field_dict(pmodels, penv.model))
    assert ("jnt_range" in names) == (case == "jnt_range")
    for name in names:
        leaf = getattr(pmodels, name)
        assert bool((leaf != leaf[:1]).any()), name
    gen = torch.Generator().manual_seed(2)
    ph = wall_poses(penv, B, gen, sink=(0.002, 0.01))
    ph = ph.replace(ctrl=torch.rand((B, 3), generator=gen)
                    * torch.tensor([1.2, 40.0, 40.0])
                    - torch.tensor([0.6, 20.0, 20.0]))
    jph = _jax_state(ph)
    jstep = jax.jit(lambda s: jax_engine.step_batch(jmodels, s,
                                                    base_model=jm))
    k3.newton_solve.launches = 0
    calls = []
    step_fused = k1.step_fused
    monkeypatch.setattr(k1, "step_fused", lambda *a, **kw: calls.append(1)
                        or step_fused(*a, **kw))
    solves = []
    solve_plain = k3.newton_solve_plain
    monkeypatch.setattr(k3, "newton_solve_plain", lambda *a, **kw:
                        solves.append(1) or solve_plain(*a, **kw))
    for _ in range(3):
        ref = jstep(jph)
        got = engine.step_batch(pmodels, ph, base_model=penv.model)
        for name, tol in (("qpos", 1e-6), ("xpos", 1e-6), ("qvel", 1e-4)):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=tol, err_msg=name)
        jph = ref
        ph = dataclasses.replace(ph, **{
            f.name: torch.from_numpy(np.array(getattr(ref, f.name)))
            for f in dataclasses.fields(ph)})
    assert calls == [] and len(solves) == 3
    # the per-env parameters reached the step: the velocities spread
    assert float(np.std(np.asarray(ref.qvel), axis=0).max()) > 1e-3
