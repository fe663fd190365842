"""The port stands alone: it loads without JAX and without any module of the
JAX package, its sources import neither, and its entry points refuse to
run without a CUDA device unless the caller asks for the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "mujoco_playground_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_port_imports_without_jax():
    code = "\n".join(
        [f"import {m}" for m in _modules()]
        + ["import sys",
           "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'flax', 'optax', 'orbax', 'mujoco_playground_tpu'))",
           "print(bad)", "assert not bad, bad"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip() == "[]"


def test_every_module_of_the_port_is_checked():
    """The import check walks the package: the modules of each slice are in
    it (the staged step, domain randomization, the Newton kernel, the
    trainer, the geodesic fields, the off-policy learners, the per-env
    step's solver, raycast and sensors, the interop and tooling layer)."""
    mods = set(_modules())
    for m in ("envs.domain_randomization", "envs.geodesic",
              "physics.batchlast",
              "physics.collision", "physics.constraint",
              "physics.linalg_small", "physics.solver_batched",
              "physics.solver", "physics.raycast", "physics.sensors",
              "ops.newton", "ops.step", "ops.lidar", "interop",
              "rl", "rl.config", "rl.networks", "rl.ppo", "rl.checkpoint",
              "rl.replay_buffer", "rl.sac", "rl.td3",
              "rl.evaluate", "rl.random_policy", "rl.train", "rl.utils",
              "utils", "utils.logging", "utils.profiler",
              "core.cmd_vel", "teleop", "teleop.keyboard",
              "teleop.joystick", "spec.mjcf", "envs.spawner",
              "envs.gym_wrapper", "main_sim", "utils.visualize",
              "rl.sb3_import"):
        assert f"mujoco_playground_tpu_torch.{m}" in mods, m


def test_sources_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b"
                         r"|mujoco_playground_tpu\.\w", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{p}: {m.group(0)}" for p in files
            for m in pattern.finditer(p.read_text())]
    assert not hits, hits


def test_entry_points_need_cuda_unless_asked_for_cpu():
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_ackermann_env("maze", "umaze")
    env = make_ackermann_env("maze", "umaze", device="cpu",
                             solver_iterations=4, ls_iterations=3)
    assert env.model.device.type == "cpu"


def _tooling_entry_points():
    from mujoco_playground_tpu_torch import main_sim
    from mujoco_playground_tpu_torch.envs import gym_wrapper, spawner
    return {
        "GymAckermannEnv": lambda: gym_wrapper.GymAckermannEnv(
            maze_id="umaze"),
        "GymVectorAckermannEnv": lambda: gym_wrapper.GymVectorAckermannEnv(
            4, maze_id="umaze"),
        "SimpleMapSpawner": spawner.SimpleMapSpawner,
        "MapSpawner": spawner.MapSpawner,
        "main_sim": lambda: main_sim.main(["--headless", "--steps", "1"]),
    }


@pytest.mark.parametrize("name", ["GymAckermannEnv", "GymVectorAckermannEnv",
                                  "MapSpawner", "SimpleMapSpawner",
                                  "main_sim"])
def test_tooling_entry_points_need_cuda_unless_asked_for_cpu(name):
    """The wrappers, the spawners and the interactive sim default to the
    card as the envs do, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        _tooling_entry_points()[name]()
