"""Kernel K3 on the path-B envs where it once missed its twins on an H100.

``tests/data/k3_path_b_misses.npz`` holds the Newton systems (every
``newton_solve`` argument and the warm start) of the envs of path B (the
umaze env with the compat manifolds at 16384 envs, solver 4/3) on which
the kernel, when it computed in float32, was more than ``K3_TOL`` from its
float32 twin on the card (``scripts/torch_k3_probe.py --from 10 --every
10 --steps 200 --seed 3 4 --save``; PERF.md).  The kernel computes in
float64 now, and on the card gives the same bits as its host build.  On
the CPU, on those envs:

* the host build of ``csrc/newton_kernel.cu`` (g++ without contractions,
  as ``test_torch_kernel_source.py`` builds it) against the twin run in
  float64, within ``K3_TOL``, and against the float32 twin by
  ``chip_smoke.py``'s rule: within ``K3_TOL`` of it, or, where the float32
  twin is more than the tolerance from the float64 twin, within the
  tolerance of the float64 twin;
* the env where the kernel alone was wrong (seed 3, step 90, env 15609):
  the host build and the three twins (float32, float64, converged) within
  ``K3_TOL`` of each other, with no rule;
* the envs where the float32 twin is off the float64 answer (seed 3, step
  120, env 3083's kind): the float32 twin's distance to the float64 twin,
  on record;
* (slow) the twin against the JAX package's ``newton_solve_pallas`` in
  interpret mode, in float64 within ``K3_TOL`` and in float32 by the rule
  above.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from mujoco_playground_tpu_torch.ops import build
from mujoco_playground_tpu_torch.ops import newton as k3

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# (seed, step, env) of the captured envs, in the file's order
CAPTURED = [(3, 90, 15609), (3, 120, 3083), (4, 30, 6757), (4, 40, 2636),
            (4, 110, 10277), (4, 180, 13349)]
KERNEL_ALONE = (3, 90, 15609)
TOL = [chip_smoke.K3_TOL + (True,)]


def _ratio(a, b):
    return chip_smoke.outputs_ratio([a], [b], TOL)


@pytest.fixture(scope="module")
def misses():
    args, ws, ids = chip_smoke.load_k3_misses(chip_smoke.K3_MISSES, "cpu")
    assert ids == CAPTURED
    t32 = k3.newton_solve_plain(*args, warmstart=ws)
    t64 = k3.newton_solve_plain(*chip_smoke.as_f64(args),
                                warmstart=ws.double())
    return dict(args=args, ws=ws, t32=t32, t64=t64)


@pytest.fixture(scope="module")
def host_k3(tmp_path_factory, misses):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    so = tmp_path_factory.mktemp("host_k3") / "newton_kernel.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-x", "c++",
                    str(build.CSRC / "newton_kernel.cu"), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    return k3.launch_k3(ctypes.CDLL(str(so)), *misses["args"], misses["ws"],
                        None)


def _held(got, t32, t64):
    """chip_smoke.py's rule for a float32 solve ``got`` of one env: within
    the tolerance of the float32 twin, or of the float64 twin where the
    float32 twin is more than the tolerance from it."""
    near32 = float(_ratio(got, t32)[0])
    off = float(_ratio(t32, t64)[0])
    near64 = float(_ratio(got, t64)[0])
    return near32 <= 1 or (off > 1 and near64 <= 1), (near32, off, near64)


ENVS = pytest.mark.parametrize("e", range(len(CAPTURED)),
                               ids=[f"seed{s}-step{t}-env{i}"
                                    for s, t, i in CAPTURED])


@ENVS
def test_host_build_on_the_float64_twin(misses, host_k3, e):
    ratio = float(_ratio(host_k3[:, [e]], misses["t64"][:, [e]])[0])
    assert ratio <= 1, ratio


@ENVS
def test_host_build_holds_the_twins(misses, host_k3, e):
    ok, ratios = _held(host_k3[:, [e]], misses["t32"][:, [e]],
                       misses["t64"][:, [e]])
    assert ok, ("host build to the float32 twin, float32 twin to the "
                "float64 twin, host build to the float64 twin, in units of "
                f"K3_TOL: {ratios}")


def test_env_where_the_kernel_alone_was_wrong(misses, host_k3):
    e = CAPTURED.index(KERNEL_ALONE)
    args = [a[..., [e]] if isinstance(a, torch.Tensor) else a
            for a in misses["args"]]
    more = chip_smoke.as_f64(args)
    more[15], more[16] = 40, 20
    conv = k3.newton_solve_plain(*more,
                                 warmstart=misses["ws"][:, [e]].double())
    t32, t64 = misses["t32"][:, [e]], misses["t64"][:, [e]]
    for a, b in ((host_k3[:, [e]], t32), (host_k3[:, [e]], t64),
                 (t32, t64), (t64, conv)):
        assert float(_ratio(a, b)[0]) <= 1


def test_float32_twin_off_the_float64_answer_on_record(misses, host_k3):
    """Seed 3, step 120, env 3083: the float32 twin is 28.9x the tolerance
    from the float64 twin on the CPU as on the card, and the host build
    lands on the float64 answer."""
    e = CAPTURED.index((3, 120, 3083))
    t32, t64 = misses["t32"][:, [e]], misses["t64"][:, [e]]
    off = float(_ratio(t32, t64)[0])
    assert 20 < off < 40
    assert float(_ratio(host_k3[:, [e]], t64)[0]) <= 1


@pytest.mark.slow
def test_twin_matches_jax_newton_solve_pallas_interpret(misses):
    """The twin against the JAX kernel itself (interpret mode, one grid
    step over the captured envs): in float64 within K3_TOL; in float32 by
    chip_smoke.py's rule, since on some of these envs the float32 solve is
    ill-conditioned and the two float32 programs land on different sides
    of a friction row's kink."""
    import jax.numpy as jnp
    from mujoco_playground_tpu.ops import newton_pallas
    args, ws = misses["args"], misses["ws"]
    n = ws.shape[1]
    for dtype, twin in ((np.float64, misses["t64"]),
                        (np.float32, misses["t32"])):
        def j(t):
            return jnp.asarray(t.numpy().astype(dtype))
        got = torch.from_numpy(np.array(newton_pallas.newton_solve_pallas(
            *(j(a) for a in args[:7]), np.asarray(args[7]),
            *(j(a) for a in args[8:15]), args[15], args[16], block_b=n,
            interpret=True, warmstart=j(ws))))
        for e in range(n):
            mine, theirs = twin[:, [e]], got[:, [e]]
            apart = float(_ratio(mine, theirs)[0])
            if dtype == np.float64:
                assert apart <= 1, (CAPTURED[e], apart)
                continue
            # float32: together, or one on the float64 answer and the other
            # off it by more than the tolerance
            t64 = misses["t64"][:, [e]]
            to64 = sorted(float(_ratio(q, t64)[0]) for q in (mine, theirs))
            assert apart <= 1 or (to64[0] <= 1 < to64[1]), (
                CAPTURED[e], apart, to64)


def test_probe_save_round_trips(tmp_path, misses):
    """What scripts/torch_k3_probe.py --save writes, chip_smoke.py's loader
    reads back: the arguments, the warm start and each env's seed, step
    and id."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_k3_probe", ROOT / "scripts" / "torch_k3_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    args, ws = misses["args"], misses["ws"]
    found = [(s, t, i, probe.sub(args, [e]), ws[:, [e]])
             for e, (s, t, i) in enumerate(CAPTURED[:2])]
    path = tmp_path / "m.npz"
    probe.save_misses(path, found)
    got, got_ws, ids = chip_smoke.load_k3_misses(path, "cpu")
    assert ids == CAPTURED[:2]
    assert torch.equal(got_ws, ws[:, :2])
    for a, b in zip(got, probe.sub(args, [0, 1])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
