"""The port's off-policy path in the env and its loop, on the CPU (the port
alone; ``tests/test_torch_offpolicy.py`` holds the learners against JAX).

* The env wiring on umaze (B=8, 30-step episodes, solver 2/2): two SAC
  and two TD3 ``train_step`` calls (2 collect + 2 gradient steps each) with
  the resets injected as ``fresh``; the buffer's rows equal, bitwise, the
  obs, action, reward, final_obs and terminated of the same env steps
  taken directly; global_step 32, buffer size 32, actions in [-1, 1].
* ``train_off_policy`` (the parts of ``test_train_cli.py`` for SAC/TD3):
  the warm-up iterations, the chunks and the cut final chunk, the save and
  ``metrics.jsonl`` under ``<log-dir>/<algo>_torch/``; a TD3 run resumed
  from its checkpoint equals the straight run bitwise (the whole train
  state: networks, targets, optimizers, buffer, env states, generators,
  update count); ``--eval-only`` restores read-only, and raises without a
  checkpoint.
"""
import copy
import json
import math
import os

import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.rl import checkpoint as ckpt_lib
from mujoco_playground_tpu_torch.rl import replay_buffer as rb
from mujoco_playground_tpu_torch.rl import sac, td3
from mujoco_playground_tpu_torch.rl import train as train_lib
from mujoco_playground_tpu_torch.rl.config import RLConfig
from mujoco_playground_tpu_torch.rl.train import train_off_policy

B = 8


@pytest.fixture(scope="module")
def umaze():
    return make_ackermann_env("maze", "umaze", max_episode_steps=30,
                              solver_iterations=2, ls_iterations=2,
                              device="cpu")


def _umaze_config():
    return RLConfig(num_envs=B, sac_buffer_size=1024, sac_batch_size=32,
                    sac_learning_starts=0, solver_iterations=2,
                    ls_iterations=2, max_episode_steps=30,
                    offpolicy_hidden_sizes=(64, 64))


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_train_steps_fill_the_buffer_with_the_env_steps(umaze, algo):
    cfg = _umaze_config()
    make = sac.make_sac if algo == "sac" else td3.make_td3
    init, make_step = make(umaze, cfg, collect_steps=2, grad_steps=2)
    state = init()
    start = copy.deepcopy(state.env_states)
    # truncate half the envs on the first step, so that both paths of the
    # auto-reset write rows
    start = start.replace(steps=torch.where(
        torch.arange(B) % 2 == 0, 29, 0).to(start.steps.dtype))
    state = state.replace(env_states=copy.deepcopy(start))
    g = torch.Generator().manual_seed(7)
    cores = [umaze.reset_core(B, generator=g) for _ in range(4)]
    step = make_step(random_actions=False)
    for call in range(2):
        state, metrics = step(
            state, fresh=lambda t, _s, c=call: cores[2 * c + t])
    assert state.global_step == 32 and state.buffer.size == 32
    assert state.buffer.ptr == 32
    assert math.isfinite(float(metrics["mean_reward"]))
    acts = state.buffer.action[:32]
    assert float(acts.abs().max()) <= 1.0

    states = start
    buf = state.buffer
    n_done = 0
    for k in range(4):
        rows = slice(k * B, (k + 1) * B)
        assert torch.equal(buf.obs[rows], states.obs), k
        states = umaze.step_autoreset_batch(states, buf.action[rows],
                                            fresh=cores[k])
        for name, want in (("reward", states.reward),
                           ("next_obs", states.final_obs),
                           ("terminated", states.terminated.float())):
            assert torch.equal(getattr(buf, name)[rows], want), (name, k)
        n_done += int(states.done.sum())
    assert n_done >= B // 2
    policy = (sac if algo == "sac" else td3).deterministic_policy(state)
    assert float(policy(states.obs).abs().max()) <= 1.0


# ------------------------------------------------------------------- loop

def _config(log_dir, **kw):
    base = dict(env_type="simple", num_envs=2, max_episode_steps=5,
                sac_learning_starts=16, sac_batch_size=16,
                sac_buffer_size=256, save_freq=32, eval_episodes=2, seed=0,
                log_dir=log_dir, solver_iterations=2, ls_iterations=2,
                offpolicy_hidden_sizes=(32, 32))
    base.update(kw)
    return RLConfig(**base)


def _subdir(log_dir, algo):
    return os.path.join(log_dir, train_lib.ckpt_subdir(algo))


def _ckpt_steps(log_dir, algo):
    d = _subdir(log_dir, algo)
    if not os.path.isdir(d):
        return []
    return sorted(ckpt_lib.checkpoint_step(e) for e in os.listdir(d)
                  if e.startswith("step_"))


def _metric_lines(log_dir, algo):
    p = os.path.join(_subdir(log_dir, algo), "metrics.jsonl")
    if not os.path.exists(p):
        return []
    with open(p) as f:
        return [json.loads(line) for line in f]


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


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_offpolicy_loop_accounting_and_final_chunk(tmp_path, algo,
                                                   monkeypatch):
    """8 env steps an iteration; 2 warm-up iterations (learning starts at
    16); chunks of 3 iterations (24 steps), the last cut to 2 by the
    52-step budget: the loop stops at 56 with 2 metrics lines."""
    monkeypatch.setattr(train_lib, "OFFPOLICY_LOG_STEPS", 24)
    log_dir = str(tmp_path)
    state, stats = train_off_policy(_config(log_dir), algo, 52,
                                    eval_episodes=2, verbose=False,
                                    device="cpu")
    assert state.global_step == 56 and state.buffer.size == 56
    assert _ckpt_steps(log_dir, algo) == [40, 56]    # save_freq 32, final
    assert os.listdir(log_dir) == [train_lib.ckpt_subdir(algo)]
    lines = _metric_lines(log_dir, algo)
    assert [x["step"] for x in lines] == [40, 56]
    keys = {"mean_reward", "buffer_size", "steps_per_second"} | (
        {"actor_loss", "alpha"} if algo == "sac" else set())
    assert set(lines[-1]) == keys | {"step", "wall_time"}
    assert all(math.isfinite(lines[-1][k]) for k in keys)
    assert lines[-1]["buffer_size"] == 56
    assert "success_rate" in stats and stats["mean_length"] <= 5
    if algo == "td3":
        assert state.update_count == 7 * 4


def test_offpolicy_resumed_run_equals_straight_run_bitwise(tmp_path):
    """TD3 with a policy delay of 3, so that the update count carried
    across the resume decides which updates move the actor: 5 iterations
    straight against 3 and a resume to 5; every env resets within 5
    steps, so the resumed iterations draw from the restored env generator
    too."""
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    kw = dict(sac_learning_starts=8, save_freq=10**9, td3_policy_delay=3)
    train_off_policy(_config(straight, **kw), "td3", 40, eval_episodes=2,
                     verbose=False, device="cpu")
    train_off_policy(_config(split, **kw), "td3", 24, eval_episodes=2,
                     verbose=False, device="cpu")
    state, _ = train_off_policy(_config(split, **kw), "td3", 40,
                                eval_episodes=2, verbose=False, resume=True,
                                device="cpu")
    assert state.global_step == 40 and state.update_count == 20
    assert _ckpt_steps(straight, "td3") == [40]
    assert _ckpt_steps(split, "td3") == [24, 40]

    def load(run):
        return torch.load(ckpt_lib.latest_checkpoint(_subdir(run, "td3")),
                          weights_only=True)

    a, b = load(straight), load(split)
    assert a["update_count"] == 20 and a["buffer"]["size"] == 40
    _assert_equal_trees(a, b)

    # --eval-only restores the policy read-only
    n_lines = len(_metric_lines(split, "td3"))
    state3, stats = train_off_policy(_config(split, **kw), "td3", 10**9,
                                     eval_episodes=2, verbose=False,
                                     eval_only=True, device="cpu")
    assert state3.global_step == 40
    assert state3.buffer.size == 0          # a policy restore: no buffer
    assert _ckpt_steps(split, "td3") == [24, 40]
    assert len(_metric_lines(split, "td3")) == n_lines
    for name in ("actor", "q", "q_target", "actor_target"):
        _assert_equal_trees(getattr(state3, name).state_dict(), b[name])
    assert math.isfinite(stats["mean_return"])


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_offpolicy_eval_only_without_checkpoint_raises(tmp_path, algo):
    with pytest.raises(SystemExit):
        train_off_policy(_config(str(tmp_path / "empty")), algo, 32,
                         eval_only=True, verbose=False, device="cpu")


def test_checkpoint_round_trip_restores_every_part():
    """``state_dict``/``load_state_dict`` of a SAC state: a fresh state of
    another seed takes every leaf of the saved one."""
    cfg = RLConfig(env_type="simple", num_envs=2, sac_buffer_size=16,
                   sac_batch_size=4, offpolicy_hidden_sizes=(8,),
                   solver_iterations=2, ls_iterations=2)
    env = make_ackermann_env("simple", device="cpu", solver_iterations=2,
                             ls_iterations=2)
    init, make_step = sac.make_sac(env, cfg, collect_steps=1, grad_steps=1)
    state, _ = make_step()(init())
    saved = copy.deepcopy(ckpt_lib.state_dict(state))
    assert saved["buffer"]["size"] == 2 and saved["global_step"] == 2
    other = sac.make_sac(env, RLConfig(**{**cfg.__dict__, "seed": 1}),
                         1, 1)[0]()
    other = ckpt_lib.load_state_dict(other, copy.deepcopy(saved))
    _assert_equal_trees(ckpt_lib.state_dict(other), saved)
    assert isinstance(other.buffer, rb.ReplayBuffer)
