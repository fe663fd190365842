"""The goal compass and the geodesic shaping on path B, the compat
manifolds (the staged step, K3's twin, observed through K2's twin),
against the JAX package on the CPU, as ``test_torch_compass_paths.py``
holds path A: umaze, B=8, three auto-reset steps with half the envs
truncating on the first; obs and final_obs 81 wide within 1e-4 (the
compass 1e-5), reward within 2e-5, ``done`` exact, qpos 1e-5.
"""
from _torch_parity import one_torch_thread  # noqa: F401
from test_torch_compass_paths import _envs, assert_rollout_matches


def test_compass_and_shaping_on_path_b_match_jax():
    jenv, penv = _envs(reference_flat_manifold=True,
                       reference_wheel_patch=True)
    assert_rollout_matches(jenv, jenv, penv)
