"""Kernel K1 on the wall-contact envs where it once missed its twins.

``tests/data/k1_wall_misses.npz`` holds the inputs of the env steps on
which an earlier build of the kernel parted from its float32 twin
(``scripts/torch_k1_probe.py --tree <that checkout> --save``; PERF.md).
Its first 18 come from the host build on the CPU: the umaze env (solver
4/3, flag set ``<0,0,0>``) from ``wall_poses`` (seeds 1 and 2, 8192 envs, 6
chained steps, seeded uniform ctrl), 14x to 6,400x ``chip_smoke.K1_TOL``
apart.  The other 25 come from the card (an NVIDIA H100 at 16384 envs:
the main path, path A, R and R under DR every 10th of 200 steps and the
wall chains under every flag set, seeds 1 and 2), 1x to 1,230x apart, all
parting inside the solve, where the kernel and the twin summed rows in
different orders.  In 17 of the CPU's a wheel's disc end lay inside
a wall box, so that the direction from the end's center to the box, the
rim point's direction, was rounding noise, and the kernel's frames (its
math library's ``sincosf``) and sums (float32 where the twin folds static
masses in float64) rounded otherwise than the twin's; in one (seed 1, step
4, env 2954) a stiff contact row sat on a pyramid edge's kink after the
solve's first iteration and the two summed the rows in different orders.
The kernel now computes every such decision from the twin's IEEE
operations in the twin's order.  On the CPU, on those envs:

* the host build of ``csrc/step_kernel.cu`` and ``step_kernel_dr.cu`` (g++
  without contractions, as ``test_torch_kernel_source.py`` builds them)
  against the float32 twin, K1 with each env's flag set and K1e with the
  model's own parameters: the physics outputs bitwise, every output within
  ``K1_TOL``, with no set-aside;
* each env's kind and distances as the probe recorded them with the
  earlier build (``kernel_alone``: the two twins agree and the kernel was
  off, 6 on the CPU and 10 on the card; ``twin_off``: the kernel sat on
  the float64 twin and the float32 twin was off, 4 and 14;
  ``all_differ``, 8 and 1);
* on the CPU's 18, the float32 twin's distance to the float64 twin now,
  on record: these steps stay ill-conditioned in float32, so on 14 of them
  the kernel and its twin (together) are off the float64 answer;
* (slow) the JAX package's float32 step (the Pallas kernel in interpret
  mode) on the CPU's 18, on record: it lands on the twin's answer on 11
  envs and off it on 7, by the same noise;
* (slow) the CPU sweep that found them, again: no env over the tolerance
  and every env bitwise.
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
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.ops import build
from mujoco_playground_tpu_torch.ops import step as k1

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# (seed, step, env) of the captured envs, in the file's order
CAPTURED = [(1, 1, 1804), (1, 1, 5266), (1, 2, 76), (1, 2, 3282),
            (1, 2, 3687), (1, 2, 7459), (1, 3, 1326), (1, 4, 2382),
            (1, 4, 2954), (1, 4, 5363), (1, 4, 5870), (1, 4, 7629),
            (2, 2, 402), (2, 4, 2921), (2, 4, 4745), (2, 4, 6990),
            (2, 5, 6456), (2, 5, 8155)]
KINDS = {"host build": {"kernel_alone": 6, "twin_off": 4, "all_differ": 8},
         "NVIDIA H100 80GB HBM3, 700.00 W": {"kernel_alone": 10,
                                             "twin_off": 14,
                                             "all_differ": 1}}
# where the float32 twin (and the kernel) sits on the float64 twin now;
# elsewhere it is more than 100x the tolerance from it
ON_FLOAT64 = {(1, 3, 1326), (2, 4, 4745), (2, 4, 6990), (2, 5, 6456)}
# where the JAX package's float32 step lands on the twin's answer
JAX_ON_TWIN = {(1, 1, 1804), (1, 2, 76), (1, 2, 3282), (1, 2, 7459),
               (1, 3, 1326), (1, 4, 2954), (1, 4, 5870), (1, 4, 7629),
               (2, 4, 2921), (2, 5, 6456), (2, 5, 8155)}


@pytest.fixture(scope="module")
def env():
    return make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, device="cpu",
                              seed=chip_smoke.SEED)


@pytest.fixture(scope="module")
def misses():
    z = chip_smoke.load_k1_misses(chip_smoke.K1_MISSES, "cpu")
    ids = list(zip(z["seed"].tolist(), z["step"].tolist(),
                   z["env"].tolist()))
    assert ids[:len(CAPTURED)] == CAPTURED
    assert list(z["where"][:len(CAPTURED)]) == ["host build"] * len(CAPTURED)
    return z


def _cpu_envs(env, z):
    """step_plain's args of the 18 envs the CPU sweep captured."""
    n = len(CAPTURED)
    return (env.model, *(z[k][:, :n].contiguous() for k in
                         ("qpos", "qvel", "ctrl", "warmstart")),
            None, None, None, False)


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("host_k1")
    libs = {}
    for src in ("step_kernel.cu", "step_kernel_dr.cu"):
        so = out / (src + ".so")
        subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                        "-ffp-contract=off", "-x", "c++",
                        str(build.CSRC / src), "-o", str(so)],
                       check=True, capture_output=True, timeout=300)
        libs[src] = ctypes.CDLL(str(so))

    def run(args, dr):
        lib = libs["step_kernel.cu" if dr is None else "step_kernel_dr.cu"]
        return k1.launch_k1(lib, *args, None, dr)
    return run


def _rows(x):
    return x.reshape(x.shape[0], -1).T.contiguous()


def _ratio(got, want, model):
    return chip_smoke.outputs_ratio(chip_smoke.k1_views(got, model),
                                    chip_smoke.k1_views(want, model),
                                    chip_smoke.K1_TOLS)


def test_host_build_is_the_twin_on_the_captured_envs(env, misses, host_k1):
    groups = list(chip_smoke.k1_miss_groups(env, misses, with_k1e=True))
    assert len(groups) >= 2
    for key, args, dr, idx in groups:
        got = host_k1(args, dr)
        want = k1.step_plain(*args, dr_params=dr)
        for name, g, w in zip(chip_smoke.K1_TOL, got, want):
            assert torch.equal(g, w), (key, name)
        assert float(_ratio(got, want, env.model).max()) <= 1


def test_strict_phase_passes_the_host_build(env, host_k1):
    failures = []
    chip_smoke.k1_misses_check(env, "cpu", failures, run=host_k1)
    assert failures == []


def test_recorded_kinds(misses):
    for where, counts in KINDS.items():
        kinds = [k for k, w in zip(misses["kind"], misses["where"])
                 if w == where]
        assert {k: kinds.count(k) for k in counts} == counts
    assert set(misses["where"].tolist()) == set(KINDS)
    for kind, r, t64, k64 in zip(misses["kind"], misses["ratio"],
                                 misses["twin64"], misses["kernel64"]):
        assert r > 1
        if kind == "kernel_alone":
            assert t64 <= 1 < k64
        elif kind == "twin_off":
            assert k64 <= 1 < t64
        else:
            assert k64 > 1 and t64 > 1


def test_float64_twin_distance_on_record(env, misses):
    args = _cpu_envs(env, misses)
    t32 = k1.step_plain(*args)
    t64 = [t.float() for t in k1.step_plain(
        args[0], *(a.double() for a in args[1:5]), *args[5:])]
    apart = _ratio(t32, t64, env.model)
    for e, ids in enumerate(CAPTURED):
        if ids in ON_FLOAT64:
            assert float(apart[e]) <= 1, (ids, float(apart[e]))
        else:
            assert float(apart[e]) > 100, (ids, float(apart[e]))


@pytest.mark.slow
def test_jax_float32_step_on_the_captured_envs(env, misses):
    """The JAX package's step_pallas (interpret mode, as its own tests run
    it on the CPU) in float32 on the captured inputs: on the twin's answer
    where JAX_ON_TWIN says, elsewhere more than 100x the tolerance from
    it."""
    import jax.numpy as jnp

    from mujoco_playground_tpu.envs import \
        make_ackermann_env as jax_make_env
    from mujoco_playground_tpu.ops import step_pallas
    args = _cpu_envs(env, misses)
    n = args[1].shape[1]
    jenv = jax_make_env("maze", "umaze", solver_iterations=4,
                        ls_iterations=3)
    fn = step_pallas.build_step_fn(jenv.model, 4, 3, block_b=n,
                                   interpret=True)

    def j(t):
        return jnp.asarray(t.T.numpy())
    out = fn(j(args[1]), j(args[2]), j(args[3]), warmstart=j(args[4]))
    got = [torch.from_numpy(np.asarray(o, np.float32).reshape(n, -1).T
                            .copy()) for o in out]
    apart = _ratio(got, k1.step_plain(*args), env.model)
    for e, ids in enumerate(CAPTURED):
        if ids in JAX_ON_TWIN:
            assert float(apart[e]) <= 1, (ids, float(apart[e]))
        else:
            assert float(apart[e]) > 100, (ids, float(apart[e]))


@pytest.mark.slow
def test_wall_sweep_has_no_miss(env, host_k1):
    """The sweep behind the file (seeds 1 and 2, 8192 wall envs, 6 chained
    steps of K1 <0,0,0>): every env bitwise, none over the tolerance."""
    from mujoco_playground_tpu_torch.envs.poses import wall_poses
    B = 8192
    for seed in (1, 2):
        gen = torch.Generator().manual_seed(seed)
        ph = wall_poses(env, B, gen)
        q, v, ws = (_rows(x) for x in (ph.qpos, ph.qvel,
                                        ph.qacc_warmstart))
        for step in range(6):
            ctrl = torch.rand((3, B), generator=gen) * 2 - 1
            args = (env.model, q, v, ctrl, ws, None, None, None, False)
            got = host_k1(args, None)
            want = k1.step_plain(*args)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (seed, step)
            q, v, ws = want[0], want[1], want[4]
