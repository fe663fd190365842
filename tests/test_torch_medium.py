"""The solved recipe on PointMaze_Medium-v3 against the JAX package, on the
CPU (the arena of ``rl_logs/solved_medium``: 38 wall cells merged into 14
boxes, 26 free cells, 12000-step episodes).

* The geodesic fields (potential and gradient), their origin, the free-cell
  table and the wall boxes: bitwise equal to JAX's.
* The solved recipe's 81-wide observation and reward (geodesic shaping 10,
  the goal compass, collision -1, no-hit beams not collisions) for JAX's
  reset states carried across, B=8, two ``step_autoreset_batch`` steps
  with half the envs truncating on the first and JAX's ``reset_core``
  samples injected: reward within 2e-5, obs within 1e-4 (the compass 1e-5),
  the tolerances of ``test_torch_geodesic.py``.  The port's fused step
  makes MuJoCo's warm-start pick here (``force_warmstart_pick``), as JAX's
  CPU step does: without it one lidar beam of one env parts by 1.05e-4
  after the first step.
* The converted medium policy (``rl_logs/solved_medium/ppo_torch``,
  ``scripts/torch_convert_solved.py``) holds the Orbax tensors bitwise; its
  forward on 64 seeded observations against the Flax forward at
  ``test_torch_solved_ckpt.py``'s tolerance; its ``eval_seed0.npz`` holds
  the JAX env's ``reset_core`` draws for eval seed 0 bitwise.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from _torch_parity import (autoreset_rollout, force_warmstart_pick,
                           jax_model_arrays, obs_close, one_torch_thread,
                           truncate_half)  # noqa: F401
from mujoco_playground_tpu.envs import geodesic as jgeo
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.rl import networks as jax_networks
from mujoco_playground_tpu.rl import ppo as jax_ppo
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.envs.ackermann_env import GEO_RES
from mujoco_playground_tpu_torch.rl import ppo
from mujoco_playground_tpu_torch.rl.networks import ActorCritic
from mujoco_playground_tpu_torch.rl.train import CKPT_SUBDIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "rl_logs", "solved_medium")
STEP = 3000107008
B = 8
# rl_logs/solved_medium/EVAL.json's env, at solver 4/3 (RLConfig's)
KNOBS = dict(max_linear_velocity=1.5, max_angular_velocity=3.0,
             goal_distance_threshold=0.5, max_episode_steps=12000,
             collision_ignores_nohit=True, collision_penalty=-1.0,
             geodesic_reward_scale=10.0, goal_compass=True,
             solver_iterations=4, ls_iterations=3)


@pytest.fixture(scope="module")
def envs():
    """The JAX and port medium envs with the recipe's knobs (the port's
    model carried across from JAX's) and JAX's jitted auto-reset step."""
    jenv = jax_make_env("maze", "PointMaze_Medium-v3", **KNOBS)
    penv = make_ackermann_env("maze", "PointMaze_Medium-v3", device="cpu",
                              **KNOBS)
    penv.model = interop.model_from_arrays(jax_model_arrays(jenv.model),
                                           device="cpu")
    return jenv, penv, jax.jit(jenv.step_autoreset_batch)


def test_fields_free_cells_and_walls_bitwise_equal_jax(envs):
    jenv, penv, _ = envs
    jf = np.asarray(jenv._geo_fields)
    pack = penv._geo_pack.numpy()
    assert jf.shape[0] == len(jenv.scene.free_cells) > 7   # not umaze's
    np.testing.assert_array_equal(pack[..., 0], jf)
    np.testing.assert_array_equal(pack[..., 1:],
                                  jgeo.build_grad_fields(jf, GEO_RES))
    np.testing.assert_array_equal(penv._geo_origin.numpy(),
                                  np.asarray(jenv._geo_origin))
    np.testing.assert_array_equal(np.asarray(penv.scene.free_cells),
                                  np.asarray(jenv.scene.free_cells))
    np.testing.assert_array_equal(penv._free_cells.numpy(),
                                  np.asarray(jenv._free_cells))
    # 38 wall cells merged into 14 boxes (umaze: 6)
    assert penv.scene.box_pos.shape == (14, 3)
    np.testing.assert_array_equal(penv.scene.box_pos, jenv.scene.box_pos)
    np.testing.assert_array_equal(penv.scene.box_size, jenv.scene.box_size)


def test_solved_recipe_obs_and_reward_match_jax(envs, monkeypatch):
    jenv, penv, jstep = envs
    force_warmstart_pick(monkeypatch)   # JAX's CPU step makes the pick
    assert penv.obs_size == jenv.obs_size == 81
    jstates = truncate_half(jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(5), B)),
        jenv.config.max_episode_steps)

    def check(p, j):
        assert p.obs.shape == p.final_obs.shape == (B, 81)
        obs_close(p.final_obs.numpy(), j.final_obs, 1e-4, compass_atol=1e-5)
        obs_close(p.obs.numpy(), j.obs, 1e-4, compass_atol=1e-5)
        np.testing.assert_allclose(p.reward.numpy(), np.asarray(j.reward),
                                   atol=2e-5)

    n_done = autoreset_rollout(jenv, jstep, penv.step_autoreset_batch,
                               jstates, 2, 2, check)
    assert n_done >= B // 2   # the fresh observation's path was exercised


@pytest.fixture(scope="module")
def ckpts():
    state = ocp.PyTreeCheckpointer().restore(
        os.path.join(RUN, "ppo", f"step_{STEP}"))
    pt = torch.load(os.path.join(RUN, CKPT_SUBDIR, f"step_{STEP:010d}.pt"),
                    map_location="cpu", weights_only=True)
    return state, pt


def test_converted_medium_policy_matches_jax_network(ckpts):
    state, pt = ckpts
    assert pt["global_step"] == STEP
    p = state["params"]["params"]
    for tower in ("pi_tower", "vf_tower"):
        for layer in ("dense_0", "dense_1"):
            np.testing.assert_array_equal(
                pt["network"][f"{tower}.{layer}.weight"].numpy().T,
                np.asarray(p[tower][layer]["kernel"]))
    for name, v in pt["norm"].items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(state["norm"][name]))
    z = np.random.default_rng(1).normal(size=(64, 81))
    obs = (np.asarray(state["norm"]["obs_mean"], np.float64)
           + np.sqrt(np.asarray(state["norm"]["obs_var"], np.float64)) * z
           ).astype(np.float32)
    for dtype in (np.float64, np.float32):
        jnorm = jax_ppo.NormState(**{k: jnp.asarray(np.asarray(v, dtype))
                                     for k, v in state["norm"].items()})
        params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)),
                              state["params"])
        jnet = jax_networks.ActorCritic(action_size=2, hidden=(256, 256))
        jmean, _, jvalue = jnet.apply(params, jax_ppo.normalize_obs(
            jnorm, jnp.asarray(obs.astype(dtype))))
        tdtype = torch.float64 if dtype == np.float64 else torch.float32
        net = ActorCritic(81, 2, hidden=(256, 256))
        net.load_state_dict(pt["network"])
        net = net.to(tdtype)
        norm = ppo.NormState(
            **{k: v.to(tdtype) for k, v in pt["norm"].items()},
            env_returns=torch.zeros(1, dtype=tdtype))
        with torch.no_grad():
            mean, _, value = net(ppo.normalize_obs(
                norm, torch.from_numpy(obs.astype(dtype))))
        for got, want in ((mean, jmean), (value, jvalue)):
            want = np.asarray(want)
            scale = 1.0 if dtype == np.float64 else np.abs(want).max()
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale)


def test_medium_eval_draws_are_the_jax_evaluation_episodes(envs):
    jenv, penv, _ = envs
    spec = importlib.util.spec_from_file_location(
        "torch_convert_solved",
        os.path.join(ROOT, "scripts", "torch_convert_solved.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    assert (os.path.join("rl_logs", "solved_medium", "ppo", f"step_{STEP}"),
            0.0, "PointMaze_Medium-v3") in conv.SOLVED
    with jax.enable_x64(False):
        want = conv.eval_draws(jenv, 0.0)
    with np.load(os.path.join(RUN, CKPT_SUBDIR, "eval_seed0.npz")) as got:
        assert sorted(got.files) == sorted(want)   # no random baseline
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        d = {k: torch.from_numpy(got[k]) for k in got.files}
    core = penv.maze_core(d["start_xy"], d["goal_xy"], d["goal_cell"])
    np.testing.assert_allclose(
        (core.goal + core.physics.xpos[:, 1, :2]).numpy(),
        d["goal_xy"].numpy(), atol=1e-6)
