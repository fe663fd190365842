"""The frozen count of ``bench_port/counts.py`` against the port's own
``chip_smoke.py::k1_ops`` at the same slot activity, on both
configurations; the activity from the reference's collision."""
import pytest
import torch

import chip_smoke
from bench_port import counts, manifest
from bench_port.reference.env import RefEnv
from bench_port.traffic import Traffic
from mujoco_playground_tpu_torch.envs.make_env import make_ackermann_env


def _port_model(cfg):
    env = dict(cfg["env"])
    maze = env.pop("maze_id")
    return make_ackermann_env("maze", maze, device="cpu", **env).model


@pytest.mark.parametrize("name", ["umaze_flagship", "medium_maze"])
def test_frozen_count_matches_chip_smoke(name):
    cfg = manifest.config(name)
    ref = RefEnv(cfg["env"], "cpu")
    model = _port_model(cfg)
    nslot = len(counts.ref_step.slot_statics(
        counts.ref_step.static_model(ref.model)))
    for act in ([0.0] * nslot, [1.0] * nslot,
                [(i % 3) / 2.0 for i in range(nslot)]):
        assert counts.k1_ops(ref.model, act) == chip_smoke.k1_ops(model, act)
    assert counts.k1_bytes(ref.model) * 16384 == (
        model.nq + 2 * model.nv + model.nu + 7 + model.nq + model.nv
        + model.nbody * 7 + model.nv + 2 * model.nsite + 12) * 4 * 16384


@pytest.mark.parametrize("name,ops", [("umaze_flagship", 33_696),
                                      ("medium_maze", 64_800)])
def test_scan_operations(name, ops):
    """The two scans' share of the count: 2 x 72 beams x (72 + 27 boxes)."""
    ref = RefEnv(manifest.config(name)["env"], "cpu")
    sm = counts.ref_step.static_model(ref.model)
    assert 2 * sm.nsite * (72 + 27 * sm.num_scene_boxes) == ops


def test_activity_of_spawned_states():
    """At rest on the floor each wheel touches it and nothing else: the
    activity the count takes is the reference collision's."""
    cfg = manifest.config("umaze_flagship")
    ref = RefEnv(cfg["env"], "cpu")
    tr = Traffic(manifest.traffic("uniform_64k") | {"num_envs": 16},
                 cfg["env"], ref.free_cells, ref.cell_size, 5, "cpu")
    s = ref.spawn(*tr.spawns())
    act = counts.slot_activity(ref.model, s["qpos"])
    assert 0 < sum(act) < len(act)
    assert all(a in (0.0, 1.0) for a in act)   # every spawn alike
    assert counts.step_ops(ref.model, [s["qpos"], s["qpos"]]) == \
        counts.k1_ops(ref.model, act)
    bound, by = counts.bound_ms(counts.k1_bytes(ref.model) * 65536,
                                counts.k1_ops(ref.model, act) * 65536)
    assert by == "operations" and 0.01 < bound < 0.2
    torch.testing.assert_close(bound, counts.k1_ops(ref.model, act)
                               * 65536 / counts.PEAK_F32 * 1e3)


def test_policy_operations():
    """The medium policy's action: its normalisation, the actor's two
    256-wide tanh layers and the head; the value tower not counted."""
    from bench_port.reference import policy as ref_policy
    cfg = manifest.config("medium_maze")
    net, _ = ref_policy.load_weights(manifest.policy_path(cfg), "cpu")
    obs = net["pi_tower.dense_0.weight"].shape[1]
    assert counts.policy_ops(net) == (
        2 * obs + (2 * obs * 256 + 2 * 256) + (2 * 256 * 256 + 2 * 256)
        + (2 * 256 * 2 + 2))
    net["vf_tower.dense_0.weight"] = net["vf_tower.dense_0.weight"][:1]
    assert counts.policy_ops(net) == 174_756
