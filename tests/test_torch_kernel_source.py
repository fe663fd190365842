"""The CUDA sources of kernels K1 and K2, compiled as host C++, against their
plain PyTorch twins on the CPU.

Each ``.cu`` file of ``mujoco_playground_tpu_torch/csrc`` also compiles
without nvcc: its per-env program then runs one env after another behind the
same C interface (``k1_set_constants``/``k1_launch``, ``k2_*``), so the
wrappers' ``launch_k1``/``launch_k2`` drive it with CPU pointers.  This holds
the kernels' arithmetic, constant blocks and argument marshalling against
the twins here; the nvcc build is held against them on the card by
``chip_smoke.py``.

Tolerances (same inputs, 3 chained steps at B=8): qpos, xpos and xquat
1e-6; qvel 1e-5; qacc atol 1e-3 plus rtol 1e-4 (the error of an env scales
with the largest accelerations of the solve, ~4e3 on wheel dofs, and the
dense loops sum in another order than the twin's pruned program); env slab
1e-5, the goal angle through sin and cos; K2 1e-6.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.ops import build
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.ops import step as k1

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


@pytest.mark.parametrize("with_env,with_fresh,ws_compare",
                         [(True, True, False), (False, False, True),
                          (True, False, False)],
                         ids=["True-False", "False-True", "env-nofresh"])
def test_step_kernel_source_matches_plain_twin(host_libs, env, with_env,
                                               with_fresh, ws_compare):
    lib = host_libs["step_kernel.cu"]
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
        want = k1.step_plain(*args)
        got = k1.launch_k1(lib, *args, None)
        assert len(got) == len(want) == (6 if with_env else 5)
        for name, a, b in zip(TOL, got, want):
            _compare(name, a, b, model)
        q, v, ws = want[0], want[1], want[4]
    assert k1.step_fused.launches == 0


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
