"""The measurement helpers of ``chip_smoke.py`` that run without a card."""
import math
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


def test_ulp_distance_counts_float32_steps():
    """The import phase's leaf comparison: float32 values apart, across
    zero and for the same bits."""
    a = torch.tensor([1.0, -2.0, 0.0, 3.5])
    b = torch.nextafter(a, torch.full_like(a, math.inf))
    assert chip_smoke.ulp_distance(a, a).tolist() == [0, 0, 0, 0]
    assert chip_smoke.ulp_distance(a, b).tolist() == [1, 1, 1, 1]
    c = torch.nextafter(b, torch.full_like(a, math.inf))
    assert chip_smoke.ulp_distance(a, c).tolist() == [2, 2, 2, 2]
    tiny = torch.tensor([1e-45])
    assert chip_smoke.ulp_distance(-tiny, tiny).tolist() == [2]
    assert chip_smoke.ulp_distance(torch.tensor([-0.0]),
                                   torch.tensor([0.0])).tolist() == [0]


def test_model_leaf_diff_reads_values_shapes_and_statics():
    """The import phase's report: the round trip's model against the hand
    spec's differs in the chassis hulls only; a one-ulp move of a leaf
    shows as (|diff|, 1)."""
    import dataclasses

    from mujoco_playground_tpu_torch.physics.model import make_model
    from mujoco_playground_tpu_torch.spec import (mjcf, mjcf_import, robot,
                                                  scene)
    umaze = scene.pointmaze_scene("umaze")
    hand = make_model(robot.ackermann_robot_v2(), umaze, device="cpu")
    spec = mjcf_import.from_mjcf(mjcf.to_mjcf(robot.ackermann_robot_v2()))
    imported = make_model(spec, umaze, device="cpu")
    diff = chip_smoke.model_leaf_diff(imported, hand)
    assert set(diff) == set(chip_smoke.IMPORT_HULL_FIELDS)
    assert diff["chassis_hull_verts"] == "shape (2, 8, 3) vs (2, 36, 3)"
    assert chip_smoke.model_leaf_diff(hand, hand) == {}
    mass = hand.body_mass.clone()
    mass[1] = torch.nextafter(mass[1], torch.tensor(math.inf))
    moved = dataclasses.replace(hand, body_mass=mass)
    d, ulps = chip_smoke.model_leaf_diff(moved, hand)["body_mass"]
    assert ulps == 1 and 0 < d < 1e-6


def test_k3_to_rows_moves_the_kernel_layout():
    """The batch-last phase's bitwise check moves G, Jn/Jt1/Jt2 and c_aref
    to row-major and leaves the rest as they are."""
    nv, nj, nc, B = 12, 11, 48, 3
    args = [torch.randn(nv, nv, B), torch.randn(nv, B),
            torch.randn(nv, nj, B)] + [torch.randn(nj, B)] * 4 + [
        [0] * nj] + [torch.randn(nv, nc, B) for _ in range(3)] + [
        torch.randn(4, nc, B)] + [torch.randn(nc, B)] * 3 + [4, 3]
    rows = chip_smoke.k3_to_rows(args)
    assert rows[2].shape == (nj, nv, B) and rows[2].is_contiguous()
    assert rows[8].shape == (nc, nv, B)
    assert rows[11].shape == (nc, 4, B)
    assert torch.equal(rows[2][5, 3], args[2][3, 5])
    assert torch.equal(rows[11][7, 2], args[11][2, 7])
    for i in (0, 1, 3, 7, 12, 15, 16):
        assert rows[i] is args[i]


def test_parallel_phase_runs_the_recipes():
    """The data-parallel phase's flags, read by
    ``scripts/torch_multihost_train.py``'s parser, give the README's PPO
    recipe at 4096 envs and the committed SAC/TD3 runs' configuration."""
    from mujoco_playground_tpu_torch.parallel import dryrun
    mh = chip_smoke.load_script("torch_multihost_train")
    ppo = mh.config_of(mh.make_parser().parse_args(
        chip_smoke.PAR_PPO + chip_smoke.PAR_COMMON))
    assert (ppo.num_envs, ppo.unroll_length, ppo.num_minibatches,
            ppo.ppo_epochs, ppo.hidden_sizes) == (4096, 32, 32, 10, (64, 64))
    assert ppo.normalize_obs and ppo.normalize_reward
    args = mh.make_parser().parse_args(chip_smoke.PAR_OFF
                                       + chip_smoke.PAR_COMMON)
    assert args.algo == ["sac", "td3"]
    off = dryrun.algo_config(mh.config_of(args), "sac")
    assert (off.num_envs, off.progress_reward, off.sac_buffer_size,
            off.sac_batch_size, off.offpolicy_hidden_sizes) == (
        256, 3.0, 100000, 256, (256, 256))
    for cfg in (ppo, off):
        assert (cfg.env_type, cfg.maze_id, cfg.solver_iterations,
                cfg.ls_iterations) == ("maze", "umaze", 4, 3)


def test_capability_phase_runs_the_protocols():
    """The capability phase's flags: the scripted expert on umaze with
    PARITY.md's protocol, the medium policy with its EVAL.json's env and
    the 1-env reference-compat recipe."""
    import json
    from mujoco_playground_tpu_torch.rl import train as train_lib
    scripted = chip_smoke.load_script("torch_scripted_ceiling")
    args = scripted.make_parser().parse_args(chip_smoke.CAP_SCRIPTED)
    assert (args.max_velocity, args.max_angular, args.max_episode_steps,
            args.episodes) == (1.5, 3.0, 6000, 512)
    assert scripted.ARENAS[(args.maze, args.spawn_heading_noise)] == "umaze"
    with open(ROOT / "rl_logs" / chip_smoke.CAP_MEDIUM[0] / "EVAL.json") as f:
        env = json.load(f)["env"]
    flags = chip_smoke.load_script("torch_solved_eval").eval_flags(env)
    cfg = train_lib.config_from_args(train_lib.make_parser().parse_args(
        flags + ["--algo", "ppo"]))
    assert (cfg.env_type, cfg.maze_id, cfg.max_episode_steps,
            cfg.hidden_sizes, cfg.goal_compass, cfg.normalize_obs) == (
        "maze", "medium", 12000, (256, 256), True, True)
    assert (ROOT / "rl_logs" / chip_smoke.CAP_MEDIUM[0] / "ppo_torch"
            / f"step_{chip_smoke.CAP_MEDIUM[1]:010d}.pt").exists()
    compat = chip_smoke.load_script("torch_reference_compat_run")
    rc = compat.recipe(False, chip_smoke.CAP_COMPAT_STEPS,
                       chip_smoke.CAP_COMPAT_STEPS)
    assert (rc.env_type, rc.num_envs, rc.unroll_length, rc.reference_compat,
            rc.ent_coef) == ("simple", 1, 2048, True, 0.0)
    assert chip_smoke.CAP_EPISODE_BOUNDS == (-52000.0, -49000.0)
