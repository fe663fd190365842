"""The committed SAC and TD3 policies carried across to the port
(``scripts/torch_convert_offpolicy.py``), on the CPU.

* ``rl_logs/offpolicy/{sac,td3}_torch/step_0020000768.pt`` hold the Orbax
  ``params_final`` leaves bitwise (flax kernels transposed): the actor,
  the critics, their targets, SAC's ``log_alpha``, and the step count.
* The actor's deterministic action on 64 seeded 79-wide observations
  against JAX's ``deterministic_policy`` on the same parameters: within
  1e-5 (float32: the two libraries sum the 256-wide layers in different
  orders, and these off-distribution inputs drive the trained layers to
  pre-tanh values of several units; 1.8e-6 measured, TD3).
* ``eval_seed0.npz`` holds EVAL.json's 256 episodes: the JAX env's
  ``reset_core`` draws for eval seed 0 (x64 off, as the evaluation ran),
  bitwise; the port's ``maze_core`` places its spawns and goals there.
* ``rl.train.main --algo <algo> --eval-only`` with EVAL.json's env flags,
  from a temporary copy of the file: 2 episodes of 10 steps, read-only.
"""
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.rl import sac as jax_sac
from mujoco_playground_tpu.rl import td3 as jax_td3
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.rl import sac, td3
from mujoco_playground_tpu_torch.rl.train import ckpt_subdir, main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 20000768
ACTION_ATOL = 1e-5


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_convert_offpolicy",
        os.path.join(ROOT, "scripts", "torch_convert_offpolicy.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    return conv


@pytest.fixture(scope="module")
def conv():
    return _script()


def _pt(algo):
    return os.path.join(ROOT, "rl_logs", "offpolicy", ckpt_subdir(algo),
                        f"step_{STEP:010d}.pt")


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_converted_checkpoint_holds_the_orbax_leaves_bitwise(conv, algo):
    leaves = conv.restore_leaves(algo)
    pt = torch.load(_pt(algo), map_location="cpu", weights_only=True)
    assert pt["global_step"] == int(leaves["global_step"]) == STEP
    trees = dict(actor_params="actor", q_params="q",
                 q_target_params="q_target")
    if algo == "td3":
        trees["actor_target_params"] = "actor_target"
    assert set(pt) == set(trees.values()) | {"global_step"} | (
        {"log_alpha"} if algo == "sac" else set())
    for tree, module in trees.items():
        p = leaves[tree]["params"]
        assert {k.rsplit(".", 1)[0] for k in pt[module]} == set(p)
        for layer, v in p.items():
            np.testing.assert_array_equal(
                pt[module][f"{layer}.weight"].numpy().T, v["kernel"])
            np.testing.assert_array_equal(pt[module][f"{layer}.bias"].numpy(),
                                          v["bias"])
    if algo == "sac":
        np.testing.assert_array_equal(pt["log_alpha"].numpy(),
                                      leaves["log_alpha"])
    assert pt["actor"]["dense_0.weight"].shape == (256, 79)
    assert pt["q"]["q1_dense_0.weight"].shape == (256, 81)


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_converted_actor_acts_as_jax(conv, algo):
    leaves = conv.restore_leaves(algo)
    pt = torch.load(_pt(algo), map_location="cpu", weights_only=True)
    obs = np.random.default_rng(0).normal(size=(64, 79)).astype(np.float32)
    jmod = jax_sac if algo == "sac" else jax_td3
    params = jax.tree_util.tree_map(jnp.asarray, leaves["actor_params"])
    with jax.enable_x64(False):
        want = np.asarray(jmod.deterministic_policy(
            _JaxEnv, _Holder(params))(jnp.asarray(obs)))
    mod = sac if algo == "sac" else td3
    cls = sac.TanhGaussianActor if algo == "sac" else td3.DeterministicActor
    actor = cls(79, 2, sac.actor_hidden_of(pt["actor"]))
    actor.load_state_dict(pt["actor"])
    got = mod.deterministic_policy(_Holder(actor))(torch.from_numpy(obs))
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ACTION_ATOL)
    assert np.abs(want).max() <= 1.0


class _JaxEnv:
    action_size = 2


class _Holder:
    """What the policies read of a train state: the actor (its
    parameters, on the JAX side)."""

    def __init__(self, actor):
        self.actor = self.actor_params = actor


def test_eval_draws_are_the_jax_evaluation_episodes(conv):
    jenv = jax_make_env("maze", "umaze", progress_reward_scale=3.0,
                        solver_iterations=4, ls_iterations=3)
    with jax.enable_x64(False):
        want = conv.eval_draws(jenv, 0.0, conv.EPISODES)
    with np.load(os.path.join(conv.RUN, conv.EVAL_DRAWS)) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        d = {k: torch.from_numpy(got[k]) for k in got.files}
    assert d["start_xy"].shape == (256, 2)
    penv = make_ackermann_env("maze", "umaze", device="cpu",
                              progress_reward_scale=3.0,
                              solver_iterations=4, ls_iterations=3)
    core = penv.maze_core(d["start_xy"], d["goal_xy"], d["goal_cell"])
    np.testing.assert_array_equal(core.physics.qpos[:, :2].numpy(),
                                  d["start_xy"].numpy())
    np.testing.assert_allclose(
        (core.goal + core.physics.xpos[:, 1, :2]).numpy(),
        d["goal_xy"].numpy(), atol=1e-6)


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_eval_only_cli_runs_the_converted_policy(tmp_path, algo):
    dst = tmp_path / ckpt_subdir(algo)
    dst.mkdir()
    shutil.copy(_pt(algo), dst)
    stats = main(["--algo", algo, "--eval-only", "--device", "cpu",
                  "--log-dir", str(tmp_path), "--maze", "umaze",
                  "--progress-reward", "3", "--num-envs", "2",
                  "--max-episode-steps", "10", "--eval-episodes", "2"])
    assert 0 < stats["mean_length"] <= 10.0
    assert all(np.isfinite(v) for v in stats.values())
    assert sorted(os.listdir(dst)) == [os.path.basename(_pt(algo))]
