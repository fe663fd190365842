"""The port stands alone: it loads without JAX and without any module of the
JAX package, its sources import neither, and its entry points refuse to
run without a CUDA device unless the caller asks for the CPU."""
import pathlib
import re
import socket
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "mujoco_playground_tpu_torch"
# the port's multi-process runners and its learning-record scripts
# (scripts/, beside the JAX package's)
SCRIPTS = [ROOT / "scripts" / f"{name}.py" for name in (
    "torch_multihost_train", "torch_scale_bench", "torch_parallel_ab",
    "torch_solved_eval", "torch_scripted_ceiling", "torch_failure_modes",
    "torch_reference_compat_run", "torch_learning_record",
    "torch_k3_probe")]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_port_imports_without_jax():
    code = "\n".join(
        [f"import {m}" for m in _modules()]
        + ["import importlib.util"]
        + [f"spec = importlib.util.spec_from_file_location('s{i}', "
           f"{str(p)!r})\n"
           "spec.loader.exec_module(importlib.util.module_from_spec(spec))"
           for i, p in enumerate(SCRIPTS)]
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
    step's solver, raycast and sensors, the interop and tooling layer, the
    MJCF import with its meshes and native library, the batch-last
    constraint assembly, data parallelism)."""
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
              "rl.sb3_import", "native", "spec.mesh", "spec.mjcf_import",
              "physics.constraint_bl", "parallel", "parallel.distributed",
              "parallel.mesh", "parallel.dryrun"):
        assert f"mujoco_playground_tpu_torch.{m}" in mods, m


def test_sources_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b"
                         r"|mujoco_playground_tpu\.\w", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + SCRIPTS
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


def test_bad_rendezvous_raises():
    """A rendezvous that no peer joins raises; it never falls back to one
    process (False is kept for a run that asks for no group at all)."""
    import torch.distributed as dist

    from mujoco_playground_tpu_torch.parallel import initialize_distributed
    assert initialize_distributed() is False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError):
        initialize_distributed(f"tcp://127.0.0.1:{port}", 2, 0,
                               device="cpu", timeout_s=2)
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        initialize_distributed(f"tcp://127.0.0.1:{port}", 2, device="cpu")
    if not dist.is_nccl_available():    # a CPU build: NCCL is missing
        with pytest.raises(RuntimeError, match="NCCL"):
            initialize_distributed(f"tcp://127.0.0.1:{port}", 1, 0,
                                   backend="nccl", device="cpu")
