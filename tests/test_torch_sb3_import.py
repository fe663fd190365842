"""The port's Stable-Baselines3 loaders (``rl/sb3_import.py``) on synthetic
SB3-layout zips, built as ``tests/test_sb3_import.py`` builds them (the
reference checkpoints are not in the repository): PPO (64x64 tanh towers),
SAC (with ``log_ent_coef`` in ``pytorch_variables.pth``) and TD3.

* Each loader's state_dicts against the JAX package's loader carried
  across with ``interop.actor_critic_from_flax`` /
  ``dense_stack_from_flax``: bitwise (the same float32 weights; flax's
  kernels are the transposes).
* The port's modules (``ActorCritic``, ``sac.TanhGaussianActor``/
  ``TwinQ``, ``td3.DeterministicActor``/``TwinQ``) with the loaded weights
  against an SB3-layout forward (``F.linear`` with tanh or relu) of the
  same state dict: within 1e-6.
"""
import io
import zipfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import one_torch_thread  # noqa: F401
from mujoco_playground_tpu.rl import sb3_import as jsb3
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.rl import sac, sb3_import, td3
from mujoco_playground_tpu_torch.rl.networks import ActorCritic

OBS, ACT = 79, 2
TOL = 1e-6


def _zip_policy(tmp_path, policy_sd, pytorch_vars=None, name="model.zip"):
    """Write a minimal SB3-format checkpoint zip (policy.pth inside)."""
    p = tmp_path / name
    with zipfile.ZipFile(p, "w") as zf:
        buf = io.BytesIO()
        torch.save(policy_sd, buf)
        zf.writestr("policy.pth", buf.getvalue())
        if pytorch_vars is not None:
            buf = io.BytesIO()
            torch.save(pytorch_vars, buf)
            zf.writestr("pytorch_variables.pth", buf.getvalue())
    return str(p)


def _lin(out_f, in_f, g):
    return (torch.randn(out_f, in_f, generator=g) * in_f ** -0.5,
            torch.randn(out_f, generator=g) * 0.1)


def _seq(sd, prefix, dims, g):
    for i in range(len(dims) - 1):
        sd[f"{prefix}.{2 * i}.weight"], sd[f"{prefix}.{2 * i}.bias"] = \
            _lin(dims[i + 1], dims[i], g)


def _critics(sd, h, g):
    for crit in ("critic", "critic_target"):
        for qf in ("qf0", "qf1"):
            _seq(sd, f"{crit}.{qf}", (OBS + ACT,) + h + (1,), g)


def ppo_sd(h=(64, 64), seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {}
    _seq(sd, "mlp_extractor.policy_net", (OBS,) + h, g)
    _seq(sd, "mlp_extractor.value_net", (OBS,) + h, g)
    sd["action_net.weight"], sd["action_net.bias"] = _lin(ACT, h[-1], g)
    sd["value_net.weight"], sd["value_net.bias"] = _lin(1, h[-1], g)
    sd["log_std"] = torch.randn(ACT, generator=g) * 0.3
    return sd


def sac_sd(h=(32, 16), seed=1):
    g = torch.Generator().manual_seed(seed)
    sd = {}
    _seq(sd, "actor.latent_pi", (OBS,) + h, g)
    sd["actor.mu.weight"], sd["actor.mu.bias"] = _lin(ACT, h[-1], g)
    sd["actor.log_std.weight"], sd["actor.log_std.bias"] = \
        _lin(ACT, h[-1], g)
    _critics(sd, h, g)
    return sd


def td3_sd(h=(24, 12), seed=2):
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for prefix in ("actor.mu", "actor_target.mu"):
        _seq(sd, prefix, (OBS,) + h + (ACT,), g)
    _critics(sd, h, g)
    return sd


def _mlp(x, sd, prefix, n, act, last=None):
    """SB3's Sequential forward: n Linear layers at stride 2, ``act``
    after each but the last (``last`` after the last)."""
    for i in range(n):
        x = F.linear(x, sd[f"{prefix}.{2 * i}.weight"],
                     sd[f"{prefix}.{2 * i}.bias"])
        if i < n - 1:
            x = act(x)
    return x if last is None else last(x)


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


def _obs_act(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(5, OBS)).astype(np.float32)),
            torch.from_numpy(np.tanh(rng.normal(size=(5, ACT)))
                             .astype(np.float32)))


def test_ppo_loader_matches_jax(tmp_path):
    path = _zip_policy(tmp_path, ppo_sd())
    got = sb3_import.load_sb3_ppo_params(path, device="cpu")
    want = interop.actor_critic_from_flax(jsb3.load_sb3_ppo_params(path))
    _assert_state_dicts_equal(got["params"], want)


def test_sac_loader_matches_jax(tmp_path):
    path = _zip_policy(tmp_path, sac_sd(),
                       {"log_ent_coef": torch.tensor([0.37])})
    got = sb3_import.load_sb3_sac_params(path, device="cpu")
    want = jsb3.load_sb3_sac_params(path)
    assert set(got) == set(want)
    assert got["hidden"] == want["hidden"] == (32, 16)
    for key in ("actor", "q", "q_target"):
        _assert_state_dicts_equal(got[key],
                                  interop.dense_stack_from_flax(want[key]))
    assert got["log_alpha"].shape == () and float(got["log_alpha"]) == float(
        np.float32(want["log_alpha"]))
    # without pytorch_variables.pth there is no trained coefficient
    bare = _zip_policy(tmp_path, sac_sd(), name="bare.zip")
    assert sb3_import.load_sb3_sac_params(bare, device="cpu")[
        "log_alpha"] is None


def test_td3_loader_matches_jax(tmp_path):
    path = _zip_policy(tmp_path, td3_sd())
    got = sb3_import.load_sb3_td3_params(path, device="cpu")
    want = jsb3.load_sb3_td3_params(path)
    assert set(got) == set(want)
    assert got["hidden"] == want["hidden"] == (24, 12)
    for key in ("actor", "actor_target", "q", "q_target"):
        _assert_state_dicts_equal(got[key],
                                  interop.dense_stack_from_flax(want[key]))


def test_ppo_forward_matches_sb3_layout(tmp_path):
    sd = ppo_sd()
    # a bare policy.pth loads as well as a zip
    pth = tmp_path / "policy.pth"
    torch.save(sd, pth)
    for path in (_zip_policy(tmp_path, sd), str(pth)):
        loaded = sb3_import.load_sb3_ppo_params(path, device="cpu")
        net = ActorCritic(OBS, ACT, hidden=(64, 64))
        net.load_state_dict(loaded["params"])
        obs, _ = _obs_act(3)
        with torch.no_grad():
            mean, log_std, value = net(obs)
            h = _mlp(obs, sd, "mlp_extractor.policy_net", 2, torch.tanh,
                     torch.tanh)
            v = _mlp(obs, sd, "mlp_extractor.value_net", 2, torch.tanh,
                     torch.tanh)
            want_mean = F.linear(h, sd["action_net.weight"],
                                 sd["action_net.bias"])
            want_value = F.linear(v, sd["value_net.weight"],
                                  sd["value_net.bias"])[:, 0]
        torch.testing.assert_close(mean, want_mean, rtol=0, atol=TOL)
        torch.testing.assert_close(value, want_value, rtol=0, atol=TOL)
        torch.testing.assert_close(log_std, sd["log_std"], rtol=0, atol=0)


def test_sac_forward_matches_sb3_layout(tmp_path):
    sd, h = sac_sd(), (32, 16)
    loaded = sb3_import.load_sb3_sac_params(_zip_policy(tmp_path, sd),
                                            device="cpu")
    actor = sac.TanhGaussianActor(OBS, ACT, hidden=loaded["hidden"])
    actor.load_state_dict(loaded["actor"])
    obs, act = _obs_act(4)
    with torch.no_grad():
        mean, log_std = actor(obs)
        x = _mlp(obs, sd, "actor.latent_pi", len(h), torch.relu, torch.relu)
        torch.testing.assert_close(
            mean, F.linear(x, sd["actor.mu.weight"], sd["actor.mu.bias"]),
            rtol=0, atol=TOL)
        torch.testing.assert_close(log_std, torch.clamp(F.linear(
            x, sd["actor.log_std.weight"], sd["actor.log_std.bias"]),
            -20.0, 2.0), rtol=0, atol=TOL)
        for key, crit in (("q", "critic"), ("q_target", "critic_target")):
            q = sac.TwinQ(OBS, ACT, hidden=loaded["hidden"])
            q.load_state_dict(loaded[key])
            for got, qf in zip(q(obs, act), ("qf0", "qf1")):
                want = _mlp(torch.cat([obs, act], -1), sd, f"{crit}.{qf}",
                            len(h) + 1, torch.relu)[:, 0]
                torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_td3_forward_matches_sb3_layout(tmp_path):
    sd, h = td3_sd(), (24, 12)
    loaded = sb3_import.load_sb3_td3_params(_zip_policy(tmp_path, sd),
                                            device="cpu")
    obs, act = _obs_act(5)
    with torch.no_grad():
        for key, prefix in (("actor", "actor.mu"),
                            ("actor_target", "actor_target.mu")):
            actor = td3.DeterministicActor(OBS, ACT, hidden=loaded["hidden"])
            actor.load_state_dict(loaded[key])
            torch.testing.assert_close(
                actor(obs), _mlp(obs, sd, prefix, len(h) + 1, torch.relu,
                                 torch.tanh), rtol=0, atol=TOL)
        for key, crit in (("q", "critic"), ("q_target", "critic_target")):
            q = td3.TwinQ(OBS, ACT, hidden=loaded["hidden"])
            q.load_state_dict(loaded[key])
            for got, qf in zip(q(obs, act), ("qf0", "qf1")):
                want = _mlp(torch.cat([obs, act], -1), sd, f"{crit}.{qf}",
                            len(h) + 1, torch.relu)[:, 0]
                torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_loaders_need_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here: the default device is valid")
    path = _zip_policy(tmp_path, ppo_sd())
    for load in (sb3_import.load_sb3_ppo_params,
                 sb3_import.load_sb3_sac_params,
                 sb3_import.load_sb3_td3_params):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(path)
