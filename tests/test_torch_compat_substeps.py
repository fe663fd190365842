"""Two physics substeps in the port against the JAX package on the CPU:
6 steps of ``step_autoreset_batch`` (umaze, B=8, solver 4/3), half the
envs truncating on the first step, with JAX's own ``reset_core`` samples
injected and the port's twin making MuJoCo's warm-start pick, as JAX's CPU
step does: obs and final_obs 1e-4, reward 2e-5, ``done`` exact, qpos 1e-5
(``test_torch_compat_knobs.py`` holds delayed obs so, and says why).
Every substep but the last runs K1 without the env (``<0,0,0>``); the last
one fuses the observation.
"""
from _torch_parity import one_torch_thread  # noqa: F401
from test_torch_compat_knobs import KNOBS, rollout_matches_jax


def test_two_substeps_autoreset_rollout_matches_jax(monkeypatch):
    rollout_matches_jax(KNOBS["substeps2"], monkeypatch)
