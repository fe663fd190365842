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
           "bad = sorted(m for m in sys.modules if m == 'jax' "
           "or m.startswith('jax.') or m == 'mujoco_playground_tpu' "
           "or m.startswith('mujoco_playground_tpu.'))",
           "print(bad)", "assert not bad, bad"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip() == "[]"


def test_every_module_of_the_port_is_checked():
    """The import check walks the package: the modules of each slice are in
    it (the staged step, domain randomization, the Newton kernel)."""
    mods = set(_modules())
    for m in ("envs.domain_randomization", "physics.batchlast",
              "physics.collision", "physics.constraint",
              "physics.linalg_small", "physics.solver_batched",
              "ops.newton", "ops.step", "ops.lidar", "interop"):
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
