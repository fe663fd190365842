"""Neither the harness nor the reference loads JAX or the JAX package;
the reference loads nothing of the port either.  Top-level module names
(the part before the first dot) are compared whole: the port's name
begins with the JAX package's."""
import subprocess
import sys

import pytest

from bench_port import modules
from bench_port.tests.conftest import ROOT

HARNESS = ["bench_port.run", "bench_port.control", "bench_port.check",
           "bench_port.counts", "bench_port.trace", "bench_port.window",
           "bench_port.traffic", "bench_port.program", "bench_port.manifest",
           "bench_port.stalls"]
REFERENCE = ["bench_port.reference." + m for m in (
    "env", "step", "newton", "lanes", "lidar", "model", "robot", "scene",
    "spec_types", "kinematics", "inertia", "mathutil", "geodesic",
    "policy")]


def _loaded_after(imports, extra=""):
    code = ("import importlib, json, sys\n"
            f"for m in {imports!r}: importlib.import_module(m)\n"
            f"{extra}\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    import json
    return json.loads(out.stdout.splitlines()[-1])


def test_top_level_names_compared_whole():
    names = ["mujoco_playground_tpu_torch.envs", "jaxtyping",
             "mujoco_playground_tpu.physics", "jaxlib.xla_client", "flax",
             "optax.tree", "orbax_utils", "numpy"]
    assert modules.forbidden_loaded(names) == [
        "flax", "jaxlib.xla_client", "mujoco_playground_tpu.physics",
        "optax.tree"]
    assert modules.forbidden_loaded(names, extra=[modules.PORT]) == [
        "flax", "jaxlib.xla_client", "mujoco_playground_tpu.physics",
        "mujoco_playground_tpu_torch.envs", "optax.tree"]


def test_harness_loads_no_jax():
    """The harness with the port's env and policy modules loaded, as a run
    loads them."""
    loaded = _loaded_after(HARNESS, extra=(
        "import mujoco_playground_tpu_torch.envs.make_env\n"
        "import mujoco_playground_tpu_torch.rl.evaluate\n"
        "import mujoco_playground_tpu_torch.rl.networks"))
    assert "mujoco_playground_tpu_torch" in loaded
    assert modules.forbidden_loaded(loaded) == []


def test_reference_loads_neither_jax_nor_the_port():
    loaded = _loaded_after(REFERENCE)
    assert modules.forbidden_loaded(loaded, extra=[modules.PORT]) == []


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "bench_port" / "reference").glob("*.py")))
def test_reference_sources_name_no_forbidden_module(path):
    text = (ROOT / path).read_text()
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            top = s.split()[1].split(".")[0]
            assert top not in modules.FORBIDDEN + (modules.PORT,), line
