"""The CUDA sources of kernels K1, K1e, K2 and K3, compiled as host C++,
against their plain PyTorch twins on the CPU.

Each ``.cu`` file of ``mujoco_playground_tpu_torch/csrc`` also compiles
without nvcc: its per-env program then runs one env after another behind the
same C interface (``k1_set_constants``/``k1_launch``, ``k1e_*``, ``k2_*``,
``k3_launch``), so the wrappers' ``launch_k1``/``launch_k2``/``launch_k3``
drive it with CPU pointers.  This holds the kernels' arithmetic, constant
blocks and argument marshalling against the twins here; the nvcc build is
held against them on the card by ``chip_smoke.py``.

Tolerances (same inputs, 3 chained steps at B=8): qpos, xpos and xquat
1e-6; qvel 1e-5; qacc atol 1e-3 plus rtol 1e-4 (the error of an env scales
with the largest accelerations of the solve, ~4e3 on wheel dofs, and the
dense loops sum in another order than the twin's pruned program); env slab
1e-5, the goal angle through sin and cos; K2 1e-6.  K1e takes the same
tolerances on parameters with a +-2 cm floor offset; K3 is held at qacc atol
1e-3 plus rtol 1e-4 on the system of 3 compat-path steps.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mujoco_playground_tpu_torch.envs import (RandomizationConfig,
                                              make_ackermann_env,
                                              randomize_model)
from mujoco_playground_tpu_torch.ops import build
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.ops import newton as k3
from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.physics import engine

B = 8
TOL = dict(qpos=(1e-6, 0), qvel=(1e-5, 0), xpos=(1e-6, 0), xquat=(1e-6, 0),
           qacc=(1e-3, 1e-4), slab=(1e-5, 0))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for src in build.SOURCES:
        so = out / (src + ".so")
        subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                        "-ffp-contract=off", "-x", "c++",
                        str(build.CSRC / src), "-o", str(so)],
                       check=True, capture_output=True, timeout=300)
        libs[src] = ctypes.CDLL(str(so))
    return libs


@pytest.fixture(scope="module")
def env():
    return make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, device="cpu", seed=5)


def _rows(t):
    return t.reshape(t.shape[0], -1).T.contiguous()


def _compare(name, got, want, model):
    atol, rtol = TOL[name]
    got, want = got.numpy(), want.numpy()
    if name == "slab":
        ang = model.nsite + 6
        for f in (np.sin, np.cos):
            np.testing.assert_allclose(f(got[ang]), f(want[ang]), atol=atol)
        got, want = np.delete(got, ang, 0), np.delete(want, ang, 0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                               err_msg=name)


def _dr_params(env):
    models = randomize_model(env.model, torch.Generator().manual_seed(9), B,
                             RandomizationConfig(floor_z_offset=(-0.02, 0.02)))
    return engine.dr_params(models, env.model, B)


@pytest.mark.parametrize("with_env,with_fresh,ws_compare,dr",
                         [(True, True, False, False),
                          (False, False, True, False),
                          (True, False, False, False),
                          (True, True, False, True),
                          (True, False, False, True)],
                         ids=["True-False", "False-True", "env-nofresh",
                              "dr-fresh", "dr-nofresh"])
def test_step_kernel_source_matches_plain_twin(host_libs, env, with_env,
                                               with_fresh, ws_compare, dr):
    lib = host_libs["step_kernel_dr.cu" if dr else "step_kernel.cu"]
    params = _dr_params(env) if dr else None
    model = env.model
    st = env.reset(B)
    fresh = env.reset_core(B)
    g = torch.Generator().manual_seed(2)
    q, v = _rows(st.physics.qpos), _rows(st.physics.qvel)
    ws = _rows(st.physics.qacc_warmstart)
    env_in = _rows(torch.cat([st.odom_ref.position[:, :2], st.goal,
                              st.prev_goal_distance[:, None],
                              fresh.physics.xpos[:, 1, :2]], -1))
    if not with_fresh:
        env_in = env_in[:5].contiguous()
    for _ in range(3):
        ctrl = torch.rand((model.nu, B), generator=g) * 2 - 1
        args = (model, q, v, ctrl, ws, env_in if with_env else None,
                env._env_statics() if with_env else None,
                env._fresh_statics() if with_fresh else None, ws_compare)
        want = k1.step_plain(*args, dr_params=params)
        got = k1.launch_k1(lib, *args, None, dr_params=params)
        assert len(got) == len(want) == (6 if with_env else 5)
        for name, a, b in zip(TOL, got, want):
            _compare(name, a, b, model)
        q, v, ws = want[0], want[1], want[4]
    assert k1.step_fused.launches == k1.step_fused.launches_dr == 0


@pytest.mark.parametrize("with_env,with_fresh,ws_compare",
                         [(True, True, True), (True, False, True),
                          (False, False, False)])
def test_step_kernel_refuses_uncompiled_variants(host_libs, env, with_env,
                                                 with_fresh, ws_compare):
    """Only the flag sets the port calls are compiled; the wrappers and the
    C entry point refuse the others."""
    model = env.model
    st = env.reset(B)
    q, v = _rows(st.physics.qpos), _rows(st.physics.qvel)
    ws = _rows(st.physics.qacc_warmstart)
    ctrl = torch.zeros((model.nu, B))
    env_in = torch.zeros((7 if with_fresh else 5, B))
    args = (model, q, v, ctrl, ws, env_in if with_env else None,
            env._env_statics() if with_env else None,
            env._fresh_statics() if with_fresh else None, ws_compare)
    with pytest.raises(ValueError, match="no variant"):
        k1.launch_k1(host_libs["step_kernel.cu"], *args, None)
    with pytest.raises(ValueError, match="no variant"):
        k1.step_fused(*args)
    fn = host_libs["step_kernel.cu"].k1_launch
    fn.restype = ctypes.c_int
    assert fn(*([None] * 11), ctypes.c_int(B), int(with_env), int(with_fresh),
              int(ws_compare), 0, *([ctypes.c_float(0.0)] * 4), None) != 0


@pytest.mark.parametrize("with_env,with_fresh,ws_compare",
                         [(False, False, True), (True, True, True),
                          (False, False, False)])
def test_dr_step_kernel_refuses_uncompiled_variants(host_libs, env, with_env,
                                                    with_fresh, ws_compare):
    """K1e compiles only the two env-step flag sets, and needs its
    parameters."""
    model = env.model
    st = env.reset(B)
    q, v = _rows(st.physics.qpos), _rows(st.physics.qvel)
    ws = _rows(st.physics.qacc_warmstart)
    ctrl = torch.zeros((model.nu, B))
    env_in = torch.zeros((7 if with_fresh else 5, B))
    args = (model, q, v, ctrl, ws, env_in if with_env else None,
            env._env_statics() if with_env else None,
            env._fresh_statics() if with_fresh else None, ws_compare)
    params = _dr_params(env)
    lib = host_libs["step_kernel_dr.cu"]
    with pytest.raises(ValueError, match="no variant"):
        k1.launch_k1(lib, *args, None, dr_params=params)
    with pytest.raises(ValueError, match="no variant"):
        k1.step_fused(*args, dr_params=params)
    fn = lib.k1e_launch
    fn.restype = ctypes.c_int
    ptrs = [None] * 12
    ptrs[5] = params.data_ptr()
    assert fn(*ptrs, ctypes.c_int(B), int(with_env), int(with_fresh),
              int(ws_compare), 0, *([ctypes.c_float(0.0)] * 4), None) != 0
    # the env step's flag set without parameters
    assert fn(*([None] * 12), ctypes.c_int(B), 1, 0, 0, 0,
              *([ctypes.c_float(0.0)] * 4), None) != 0


def _staged_system(seed=0):
    """The Newton system of the compat path after 3 staged steps at B, as
    the staged step assembles it, and the warm start it would take."""
    cenv = make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, device="cpu", seed=seed,
                              reference_flat_manifold=True,
                              reference_wheel_patch=True)
    g = torch.Generator().manual_seed(seed)
    st = cenv.reset(B)
    for _ in range(3):
        st = cenv.step_autoreset_batch(st, torch.rand((B, 2), generator=g)
                                       * 2 - 1)
    ph = st.physics
    return (engine.newton_inputs(cenv.model, ph),
            ph.qacc_warmstart.T.contiguous())


@pytest.mark.parametrize("warm", [True, False])
def test_newton_kernel_source_matches_plain_twin(host_libs, warm):
    args, ws = _staged_system()
    ws = ws if warm else None
    assert args[8].shape[0] == 72          # the wheel patch's slot count
    assert float(args[14].sum()) >= B      # rows in contact
    want = k3.newton_solve_plain(*args, warmstart=ws)
    got = k3.launch_k3(host_libs["newton_kernel.cu"], *args, ws, None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-4)
    assert k3.newton_solve.launches == 0


def test_newton_kernel_checks_its_inputs(host_libs):
    args, ws = _staged_system()
    lib = host_libs["newton_kernel.cu"]
    bad = list(args)
    bad[8] = torch.zeros((73,) + args[8].shape[1:])
    with pytest.raises(ValueError, match="at most"):
        k3.launch_k3(lib, *bad, ws, None)
    bad = list(args)
    bad[2] = args[2].transpose(0, 1)
    with pytest.raises(ValueError, match="shape"):
        k3.launch_k3(lib, *bad, ws, None)
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(ValueError, match="float32"):
        k3.launch_k3(lib, *bad, ws, None)


def test_lidar_kernel_source_matches_plain_twin(host_libs, env):
    model = env.model
    st = env.reset(B)
    xpos, xquat = _rows(st.physics.xpos), _rows(st.physics.xquat)
    got = k2.launch_k2(host_libs["lidar_kernel.cu"], model, xpos, xquat,
                       None)
    want = k2.lidar_plain(model, xpos, xquat)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert (want > 0).any()
    assert k2.lidar.launches == 0


def test_kernel_wrappers_check_their_inputs(host_libs, env):
    model = env.model
    lib = host_libs["lidar_kernel.cu"]
    xpos = torch.zeros((model.nbody * 3, B))
    with pytest.raises(ValueError, match="shape"):
        k2.launch_k2(lib, model, xpos, torch.zeros((5, B)), None)
    with pytest.raises(ValueError, match="float32"):
        k2.launch_k2(lib, model, xpos.double(),
                     torch.zeros((model.nbody * 4, B)), None)
    with pytest.raises(ValueError, match="contiguous"):
        k2.launch_k2(lib, model, torch.zeros((B, model.nbody * 3)).T,
                     torch.zeros((model.nbody * 4, B)), None)
