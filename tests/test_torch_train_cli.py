"""The port's trainer loop (``rl/train.py``) on the CPU with tiny configs:
the PPO parts of ``test_train_cli.py``, run on the port with
``device="cpu"``.

* step accounting: the loop stops within one iteration of --timesteps
  (``timesteps=90`` gives 96);
* the save cadence and the final save land under log_dir as ``step_*.pt``;
* resume continues the counters, and a resumed run equals the straight run
  bitwise (parameters, optimizer, env states, norm statistics,
  generators);
* --eval-only restores read-only, and raises without a checkpoint;
* ``checkpoint_step`` parses beyond int32;
* --profile counts its two train steps in the step count;
* a non-finite update rolls back to the last finite state;
* one --domain-rand iteration runs through ``DomainRandomizedEnv``;
* ``evaluate_agent`` plays one episode per slot and leaves the env's
  generator untouched;
* the random baseline finishes its episodes;
* the CLI: trains and evaluates with --device cpu (PPO, and a few
  iterations of SAC and TD3), and needs a card without it;
* --reference-compat trains, its reward per step that of the reference's
  open floor.
"""
import json
import math
import os

import pytest
import torch

from mujoco_playground_tpu_torch.envs import DomainRandomizedEnv
from mujoco_playground_tpu_torch.rl import checkpoint as ckpt_lib
from mujoco_playground_tpu_torch.rl import ppo, random_policy
from mujoco_playground_tpu_torch.rl import train as train_lib
from mujoco_playground_tpu_torch.rl.config import RLConfig
from mujoco_playground_tpu_torch.rl.evaluate import (deterministic_policy,
                                                     evaluate_agent)
from mujoco_playground_tpu_torch.rl.train import build_env, main, train_ppo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny ops: one thread runs them as
    fast and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ppo_config(log_dir, timesteps, **kw):
    base = dict(
        env_type="simple", num_envs=8, unroll_length=4, num_minibatches=2,
        ppo_epochs=1, max_episode_steps=50, total_timesteps=timesteps,
        save_freq=64, eval_freq=10**9, eval_episodes=2, seed=0,
        log_dir=log_dir, solver_iterations=2, ls_iterations=2)
    base.update(kw)
    return RLConfig(**base)


def _ckpt_steps(log_dir):
    d = os.path.join(log_dir, train_lib.CKPT_SUBDIR)
    if not os.path.isdir(d):
        return []
    return sorted(ckpt_lib.checkpoint_step(e) for e in os.listdir(d)
                  if e.startswith("step_"))


def _metric_lines(log_dir):
    p = os.path.join(log_dir, train_lib.CKPT_SUBDIR, "metrics.jsonl")
    if not os.path.exists(p):
        return []
    with open(p) as f:
        return [json.loads(line) for line in f]


def _load(log_dir):
    return torch.load(ckpt_lib.latest_checkpoint(
        os.path.join(log_dir, train_lib.CKPT_SUBDIR)), weights_only=True)


def _assert_equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_ppo_loop_accounting_save_resume_evalonly(tmp_path):
    log_dir = str(tmp_path)
    spi = 8 * 4                         # num_envs * unroll

    # ---- phase 1: 3 iterations, target NOT a multiple of steps_per_iter
    ts, env, network = train_ppo(_ppo_config(log_dir, 90), verbose=False,
                                 device="cpu")
    assert 90 <= ts.global_step < 90 + spi
    assert ts.global_step == 96         # = 3 full iterations exactly
    # periodic save (save_freq=64 crossed at 96) + final save collapse to
    # one file at the final global_step
    assert _ckpt_steps(log_dir) == [96]
    # the port's files sit apart from the JAX trainer's <log-dir>/ppo
    assert os.listdir(log_dir) == [train_lib.CKPT_SUBDIR]
    assert sorted(os.listdir(os.path.join(log_dir, train_lib.CKPT_SUBDIR))) \
        == ["metrics.jsonl", "step_0000000096.pt"]
    lines = _metric_lines(log_dir)
    assert lines and lines[-1]["step"] == 96
    assert "steps_per_second" in lines[-1]
    assert all(math.isfinite(lines[-1][k]) for k in ppo.AUX_KEYS)

    # ---- phase 2: resume continues counters (no restart from 0)
    ts2, _, _ = train_ppo(_ppo_config(log_dir, 192), resume=True,
                          verbose=False, device="cpu")
    assert ts2.global_step == 192
    assert ts2.optimizer.count == 12    # 6 iterations x 1 epoch x 2 mb
    assert _ckpt_steps(log_dir) == [96, 192]

    # ---- phase 3: --eval-only is read-only
    before = _ckpt_steps(log_dir)
    n_lines = len(_metric_lines(log_dir))
    ts3, _, _ = train_ppo(_ppo_config(log_dir, 192), eval_only=True,
                          verbose=False, device="cpu")
    assert ts3.global_step == 192       # restored, not retrained
    assert _ckpt_steps(log_dir) == before
    assert len(_metric_lines(log_dir)) == n_lines


def test_ppo_eval_only_without_checkpoint_raises(tmp_path):
    cfg = _ppo_config(str(tmp_path / "empty"), 32)
    with pytest.raises(SystemExit):
        train_ppo(cfg, eval_only=True, verbose=False, device="cpu")


def test_resumed_run_equals_straight_run_bitwise(tmp_path):
    """4 iterations straight against 2, then a resume to 4, with the obs
    and reward normalization on: the final checkpoints hold the same bits
    (the learning rate is constant: --anneal-lr fits its schedule to each
    run's --timesteps, as the JAX package's does)."""
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    kw = dict(normalize_obs=True, normalize_reward=True, save_freq=10**9,
              max_episode_steps=6)
    train_ppo(_ppo_config(straight, 128, **kw), verbose=False, device="cpu")
    train_ppo(_ppo_config(split, 64, **kw), verbose=False, device="cpu")
    train_ppo(_ppo_config(split, 128, **kw), resume=True, verbose=False,
              device="cpu")
    assert _ckpt_steps(straight) == [128] and _ckpt_steps(split) == [64, 128]
    # every env resets within 6 steps, so the resumed 8 steps draw from
    # the restored env generator as well as the trainer's
    _assert_equal_trees(_load(straight), _load(split))


def test_checkpoint_step_parses_beyond_int32():
    assert ckpt_lib.checkpoint_step("/x/ppo/step_3000000000.pt") \
        == 3_000_000_000
    assert ckpt_lib.checkpoint_step("/x/ppo/step_3000000000") == 3_000_000_000
    assert ckpt_lib.checkpoint_step("/x/ppo/step_0020000768/") == 20_000_768
    assert ckpt_lib.checkpoint_step("/x/ppo/params_final") is None
    assert ckpt_lib.checkpoint_step("/x/ppo/step_garbage.pt") is None


def test_profile_counts_its_steps(tmp_path):
    """The two --profile train steps train, so they count: a 64-step
    target runs those 2 iterations and no more, and the checkpoint says
    64."""
    log_dir, prof = str(tmp_path / "logs"), str(tmp_path / "trace")
    ts, _, _ = train_ppo(_ppo_config(log_dir, 64), verbose=False,
                         profile_dir=prof, device="cpu")
    assert ts.global_step == 64 and ts.optimizer.count == 4
    assert _ckpt_steps(log_dir) == [64]
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0


def test_nonfinite_update_rolls_back(tmp_path, monkeypatch):
    """An update that leaves NaN parameters and losses is dropped: the run
    continues from the last finite state (here the initial one)."""
    real = ppo.make_train_step

    def poisoned(env, config):
        step = real(env, config)

        def step_nan(ts):
            ts, metrics = step(ts)
            with torch.no_grad():
                for p in ts.network.parameters():
                    p.fill_(float("nan"))
            return ts, {**metrics, "policy_loss": metrics["policy_loss"]
                        * float("nan")}
        return step_nan

    monkeypatch.setattr(ppo, "make_train_step", poisoned)
    cfg = _ppo_config(str(tmp_path), 64)
    ts, env, network = train_ppo(cfg, verbose=False, device="cpu")
    init = train_lib.make_network(cfg, env).state_dict()
    saved = _load(str(tmp_path))
    _assert_equal_trees(saved["network"], init)
    assert saved["optimizer"]["count"] == 0
    assert _metric_lines(str(tmp_path)) == []   # the group was not logged


def test_domain_rand_iteration(tmp_path):
    cfg = _ppo_config(str(tmp_path), 32, domain_rand=True)
    ts, env, _ = train_ppo(cfg, verbose=False, device="cpu")
    assert isinstance(env, DomainRandomizedEnv)
    assert env.models.body_mass.shape[0] == cfg.num_envs
    assert ts.global_step == 32
    assert torch.isfinite(ts.env_states.physics.qpos).all()
    assert all(math.isfinite(_metric_lines(str(tmp_path))[-1][k])
               for k in ppo.AUX_KEYS)


def test_evaluate_agent(tmp_path):
    """One episode per slot, at most max_steps long; the resets draw from
    the evaluation's generator, never the env's own; a randomized env plays
    one episode per slot."""
    cfg = _ppo_config(str(tmp_path), 0)
    env = build_env(cfg, "cpu")
    policy = deterministic_policy(train_lib.make_network(cfg, env))
    before = env.generator.get_state()
    stats = evaluate_agent(env, policy, num_episodes=4, max_steps=10)
    assert set(stats) >= {"mean_return", "std_return", "mean_length",
                          "success_rate"}
    assert 0.0 <= stats["success_rate"] <= 1.0
    assert stats["mean_length"] <= 10
    assert torch.equal(env.generator.get_state(), before)
    dr = build_env(_ppo_config(str(tmp_path), 0, domain_rand=True,
                               num_envs=3), "cpu")
    got = evaluate_agent(dr, policy, num_episodes=10, max_steps=2)
    assert got["mean_length"] == 2.0 and got["std_length"] == 0.0


def test_random_baseline_finishes_its_episodes(monkeypatch):
    monkeypatch.setattr(random_policy, "CHUNK_STEPS", 12)
    env = build_env(_ppo_config("unused", 0, max_episode_steps=10), "cpu")
    stats = random_policy.run_random_baseline(env, episodes=8, num_envs=8,
                                              seed=0, verbose=False)
    assert stats["episodes"] == 8
    assert math.isfinite(stats["mean_return"])
    # a truncated episode of the open floor sums 10 steps of about -0.1 x
    # its goal distance (2-8 m), and -50 per step in collision
    assert -600.0 < stats["mean_return"] < 0.0


def test_cli_trains_saves_and_evaluates_on_cpu(tmp_path, capsys):
    main(["--algo", "ppo", "--device", "cpu", "--num-envs", "8", "--unroll",
          "4", "--minibatches", "2", "--timesteps", "32", "--save-freq", "32",
          "--max-episode-steps", "10", "--eval-episodes", "2", "--normalize",
          "--anneal-lr", "--log-dir", str(tmp_path)])
    assert _ckpt_steps(str(tmp_path)) == [32]
    out = capsys.readouterr().out
    assert "device: cpu" in out and "Success Rate" in out


def test_cli_needs_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--algo", "ppo", "--log-dir", str(tmp_path)])


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_cli_off_policy_trains_on_cpu(algo, tmp_path, capsys):
    """Two warm-up iterations (uniform actions and gradient steps) of 2
    envs x 4 steps, the save under <log-dir>/<algo>_torch and the final
    evaluation, through the CLI."""
    stats = main(["--algo", algo, "--device", "cpu", "--num-envs", "2",
                  "--timesteps", "16", "--max-episode-steps", "4",
                  "--eval-episodes", "2", "--hidden", "32", "32",
                  "--log-dir", str(tmp_path)])
    d = os.path.join(str(tmp_path), train_lib.ckpt_subdir(algo))
    assert sorted(os.listdir(d)) == ["step_0000000016.pt"]
    saved = torch.load(os.path.join(d, "step_0000000016.pt"),
                       weights_only=True)
    assert saved["global_step"] == 16 and saved["buffer"]["size"] == 16
    assert stats["mean_length"] <= 4 and "success_rate" in stats
    out = capsys.readouterr().out
    assert "device: cpu" in out and f"[{algo}] eval" in out


def test_cli_reference_compat_trains(tmp_path):
    """--reference-compat (delayed obs and lidar aliasing) trains on the
    open floor: one iteration of 8 envs x 4 steps and the evaluation.
    There every no-hit beam reads -1 and counts as a collision, so each
    step pays the -50 penalty: the reward per step lies in [-52, -49], the
    bound ``test_env_parity.py`` holds the JAX env to."""
    env = build_env(RLConfig(reference_compat=True), "cpu")
    assert env.config.reference_delayed_obs
    assert env.config.reference_lidar_aliasing
    main(["--algo", "ppo", "--device", "cpu", "--reference-compat",
          "--num-envs", "8", "--unroll", "4", "--minibatches", "2",
          "--timesteps", "32", "--max-episode-steps", "10",
          "--eval-episodes", "2", "--log-dir", str(tmp_path)])
    assert _ckpt_steps(str(tmp_path)) == [32]
    rewards = [x["mean_reward"] for x in _metric_lines(str(tmp_path))
               if "mean_reward" in x]
    assert rewards and all(-52.0 <= r <= -49.0 for r in rewards), rewards
