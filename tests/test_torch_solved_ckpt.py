"""The committed solved PPO policy carried across to the port
(``scripts/torch_convert_solved.py``), on the CPU.

* The committed ``rl_logs/solved/ppo_torch/step_1500119040.pt`` holds the
  Orbax checkpoint's network and norm statistics bitwise (flax kernels
  transposed), and its step count.
* 64 seeded 81-wide observations, drawn from the checkpoint's own obs
  statistics, through the JAX ``ActorCritic`` and the port's, both with
  the checkpoint's obs normalization: mean action and value within 1e-5
  in float64, and within 1e-5 of the outputs' largest magnitude in float32
  (the trained policy's pre-clip means reach ~40, where float32 sums of
  256 terms in two orders part by ~4e-5).
* ``rl.train.main --eval-only`` with the solved recipe's env flags, from a
  temporary copy of the file: 2 episodes of 20 steps.
* The committed ``eval_seed0.npz`` files hold EVAL.json's episodes: the
  JAX env's ``reset_core`` draws for eval seed 0 (x64 off, as the
  evaluation ran) and the random baseline's actions, bitwise; the port's
  ``maze_core`` places its spawns and goals there.
"""
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from mujoco_playground_tpu.envs import make_ackermann_env as jax_make_env
from mujoco_playground_tpu.rl import networks as jax_networks
from mujoco_playground_tpu.rl import ppo as jax_ppo
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.rl import ppo
from mujoco_playground_tpu_torch.rl.networks import ActorCritic
from mujoco_playground_tpu_torch.rl.train import CKPT_SUBDIR, main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "rl_logs", "solved")
STEP = 1500119040
PT = os.path.join(RUN, CKPT_SUBDIR, f"step_{STEP:010d}.pt")
# the env flags of rl_logs/solved/EVAL.json, at a CPU test's length
SOLVED_FLAGS = ["--maze", "umaze", "--max-velocity", "1.5", "--max-angular",
                "3.0", "--goal-threshold", "0.5", "--sane-collision",
                "--collision-penalty", "-1", "--geodesic-reward", "10",
                "--goal-compass", "--normalize", "--hidden", "256", "256"]


@pytest.fixture(scope="module")
def ckpts():
    state = ocp.PyTreeCheckpointer().restore(
        os.path.join(RUN, "ppo", f"step_{STEP}"))
    return state, torch.load(PT, map_location="cpu", weights_only=True)


def test_converted_checkpoint_holds_the_orbax_tensors_bitwise(ckpts):
    state, pt = ckpts
    assert pt["global_step"] == STEP
    p = state["params"]["params"]
    net = pt["network"]
    for tower in ("pi_tower", "vf_tower"):
        for layer in ("dense_0", "dense_1"):
            np.testing.assert_array_equal(
                net[f"{tower}.{layer}.weight"].numpy().T,
                np.asarray(p[tower][layer]["kernel"]))
            np.testing.assert_array_equal(net[f"{tower}.{layer}.bias"].numpy(),
                                          np.asarray(p[tower][layer]["bias"]))
    for head in ("action_head", "value_head"):
        np.testing.assert_array_equal(net[f"{head}.weight"].numpy().T,
                                      np.asarray(p[head]["kernel"]))
        np.testing.assert_array_equal(net[f"{head}.bias"].numpy(),
                                      np.asarray(p[head]["bias"]))
    np.testing.assert_array_equal(net["log_std"].numpy(),
                                  np.asarray(p["log_std"]))
    assert net["pi_tower.dense_0.weight"].shape == (256, 81)
    assert set(pt["norm"]) == {"obs_mean", "obs_var", "ret_mean", "ret_var",
                               "count"}
    for name, v in pt["norm"].items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(state["norm"][name]))


def test_converted_policy_matches_jax_network(ckpts):
    state, pt = ckpts
    # observations drawn from the statistics the policy normalizes by
    # (normalized, each column is then a standard normal draw)
    z = np.random.default_rng(0).normal(size=(64, 81))
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
        net = ActorCritic(81, 2, hidden=(256, 256))
        net.load_state_dict(pt["network"])
        tdtype = torch.float64 if dtype == np.float64 else torch.float32
        net = net.to(tdtype)
        norm = ppo.NormState(
            **{k: v.to(tdtype) for k, v in pt["norm"].items()},
            env_returns=torch.zeros(1, dtype=tdtype))
        with torch.no_grad():
            mean, _, value = net(ppo.normalize_obs(
                norm, torch.from_numpy(obs.astype(dtype))))
        for got, want in ((mean, jmean), (value, jvalue)):
            want = np.asarray(want)
            assert want.dtype == dtype
            # float32: the two libraries sum the 256-wide layers in
            # different orders, so the bound is of the output's scale
            scale = 1.0 if dtype == np.float64 else np.abs(want).max()
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale)


def test_eval_only_cli_runs_the_converted_policy(tmp_path):
    dst = tmp_path / CKPT_SUBDIR
    dst.mkdir()
    shutil.copy(PT, dst)
    stats = main(["--algo", "ppo", "--eval-only", "--device", "cpu",
                  "--log-dir", str(tmp_path), "--num-envs", "2",
                  "--max-episode-steps", "20", "--eval-episodes", "2"]
                 + SOLVED_FLAGS)
    assert stats["mean_length"] == 20.0
    assert all(np.isfinite(v) for v in stats.values())
    assert sorted(os.listdir(dst)) == [os.path.basename(PT)]  # read-only


def test_eval_draws_are_the_jax_evaluation_episodes():
    spec = importlib.util.spec_from_file_location(
        "torch_convert_solved",
        os.path.join(ROOT, "scripts", "torch_convert_solved.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    jenv = jax_make_env("maze", "umaze", solver_iterations=4,
                        ls_iterations=3)
    penv = make_ackermann_env("maze", "umaze", device="cpu",
                              solver_iterations=4, ls_iterations=3)
    for rel, heading_noise, maze in conv.SOLVED:
        if maze != "PointMaze_UMaze-v3":
            continue   # the medium run's draws: test_torch_medium.py
        with jax.enable_x64(False):
            want = conv.eval_draws(jenv, heading_noise)
            if not heading_noise:
                want["random_actions"] = conv.random_baseline_actions()
        path = os.path.join(os.path.dirname(conv.port_path(
            os.path.join(ROOT, rel))), "eval_seed0.npz")
        with np.load(path) as got:
            assert sorted(got.files) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            d = {k: torch.from_numpy(got[k]) for k in got.files}
        assert d["start_xy"].shape == (512, 2)
        core = penv.maze_core(d["start_xy"], d["goal_xy"], d["goal_cell"],
                              d.get("yaw"))
        np.testing.assert_array_equal(core.physics.qpos[:, :2].numpy(),
                                      d["start_xy"].numpy())
        np.testing.assert_allclose(
            (core.goal + core.physics.xpos[:, 1, :2]).numpy(),
            d["goal_xy"].numpy(), atol=1e-6)
