"""The measurement helpers of ``chip_smoke.py`` that run without a card."""
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _event(key, device_type, us, count=1):
    return SimpleNamespace(key=key, device_type=device_type,
                           self_device_time_total=us, count=count)


def test_kernel_times_counts_each_kernel_once():
    """An operator's device time is that of the kernels it launched, which
    the trace lists as well: only the kernels count toward device time."""
    events = [_event("aten::mul", DeviceType.CPU, 5.0),
              _event("void elementwise_kernel<mul>", DeviceType.CUDA, 5.0),
              _event("k3_kernel(K3Args)", DeviceType.CUDA, 7.0, count=2),
              _event("aten::empty", DeviceType.CPU, 0.0)]
    got = chip_smoke.kernel_times(events)
    assert got == [(7.0, 2, "k3_kernel(K3Args)"),
                   (5.0, 1, "void elementwise_kernel<mul>")]
    assert sum(t for t, _, _ in got) == 12.0


def test_kernel_times_leaves_out_user_annotations():
    """A ``record_function`` range (the optimizer's step) shows on the
    device's timeline spanning the kernels it launched: only the kernels
    count."""
    events = [_event("void multi_tensor_apply_kernel", DeviceType.CUDA, 4.0),
              _event("Optimizer.step#Adam.step", DeviceType.CUDA, 9.0)]
    events[1].is_user_annotation = True
    assert chip_smoke.kernel_times(events) == [
        (4.0, 1, "void multi_tensor_apply_kernel")]


def test_tree_diff_reads_floats_and_bits():
    """The resume check's comparison of two saved train states: the largest
    float difference, and whether every leaf holds the same bits."""
    a = {"net": {"w": torch.tensor([1.0, 2.0])}, "step": 3,
         "gen": torch.tensor([7, 8], dtype=torch.uint8)}
    b = {"net": {"w": torch.tensor([1.0, 2.5])}, "step": 3,
         "gen": torch.tensor([7, 8], dtype=torch.uint8)}
    assert chip_smoke._tree_diff(a, a) == (0.0, True)
    assert chip_smoke._tree_diff(a, b) == (0.5, False)
    b["net"]["w"] = a["net"]["w"].clone()
    b["gen"] = torch.tensor([7, 9], dtype=torch.uint8)
    assert chip_smoke._tree_diff(a, b) == (0.0, False)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="with a CUDA device chip_smoke.py runs in full")
def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA device it exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_k1_ops_of_the_plain_physics_step():
    """The bound of K1 ``<0,0,0>`` counts the physics without the two scans
    and the env rows: their operations come off the fused step's."""
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    env = make_ackermann_env("maze", "umaze", device="cpu",
                             solver_iterations=4, ls_iterations=3)
    model = env.model
    active = [0.5] * 48
    fused = chip_smoke.k1_ops(model, active)
    plain = chip_smoke.k1_ops(model, active, fresh=False, env=False)
    nbox = model.num_scene_boxes
    scans = 2 * model.nsite * (72 + 27 * nbox)
    rows = 60 + model.nsite + 8 * model.nbody
    assert fused - plain == scans + rows
    assert 0 < plain < fused


def test_shifted_ranges_bind_the_outer_envs():
    """Per-env joint ranges for the staged DR check: every env's range
    differs, and q = 0 lies outside the outer envs' limited ranges."""
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    model = make_ackermann_env("maze", "umaze", device="cpu").model
    rng = chip_smoke.shifted_ranges(model, 8)
    assert rng.shape == (8,) + model.jnt_range.shape
    jid = model.dof_jnt[model.limited_dofs[0]]
    lo, hi = rng[:, jid, 0], rng[:, jid, 1]
    assert len(set(lo.tolist())) == 8
    outside = (lo > 0) | (hi < 0)
    assert bool(outside[0]) and bool(outside[-1])
    assert not bool(outside[3:5].any())


def test_sb3_helpers_write_what_the_loaders_read(tmp_path):
    """The tooling phase's synthetic SB3 zip: the PPO loader reads it back
    bitwise, and the SB3-layout forward equals the loaded ActorCritic."""
    import torch.nn.functional as F

    from mujoco_playground_tpu_torch.rl import sb3_import
    from mujoco_playground_tpu_torch.rl.networks import ActorCritic
    gen = torch.Generator().manual_seed(0)
    sd = {}
    for prefix in ("mlp_extractor.policy_net", "mlp_extractor.value_net"):
        chip_smoke.sb3_layers(sd, prefix, (79, 64, 64), gen)
    chip_smoke.sb3_linear(sd, "action_net", 64, 2, gen)
    chip_smoke.sb3_linear(sd, "value_net", 64, 1, gen)
    sd["log_std"] = torch.zeros(2)
    path = chip_smoke.sb3_zip(str(tmp_path / "ppo.zip"), sd)
    net = ActorCritic(79, 2)
    net.load_state_dict(sb3_import.load_sb3_ppo_params(
        path, device="cpu")["params"])
    x = torch.randn(4, 79, generator=gen)
    with torch.no_grad():
        mean, _, _ = net(x)
        want = F.linear(chip_smoke.sb3_forward(
            x, sd, "mlp_extractor.policy_net", 2, torch.tanh, torch.tanh),
            sd["action_net.weight"], sd["action_net.bias"])
    torch.testing.assert_close(mean, want, rtol=0, atol=1e-6)


def test_chip_smoke_imports_no_optional_package():
    """The chip machine has none of gymnasium, gymnasium_robotics, mujoco,
    matplotlib, pygame or glfw: chip_smoke.py imports none of them (the
    port's optional imports fall back without them)."""
    import re
    src = (ROOT / "chip_smoke.py").read_text()
    names = "|".join(chip_smoke.OPTIONAL)
    assert not re.findall(rf"^\s*(import|from)\s+({names})\b", src, re.M)
