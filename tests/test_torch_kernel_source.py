"""The CUDA sources of kernels K1, K1e, K2 and K3, compiled as host C++,
against their plain PyTorch twins on the CPU.

Each ``.cu`` file of ``mujoco_playground_tpu_torch/csrc`` also compiles
without nvcc: its per-env program then runs one env after another behind the
same C interface (``k1_set_constants``/``k1_launch``, ``k1e_*``, ``k2_*``,
``k3_launch``), so the wrappers' ``launch_k1``/``launch_k2``/``launch_k3``
drive it with CPU pointers.  K1 and K1e run each env's group of K1_G lanes
one lane after another between barriers, with the card's partition of the
work over lanes and its reduction order.  This holds the kernels'
arithmetic, constant blocks and argument marshalling against the twins
here; the nvcc build is held against them on the card by ``chip_smoke.py``.

Tolerances (same inputs, 3 chained steps at B=8, 2 from wall contacts):
qpos, xpos and xquat 1e-6; qvel 1e-5; qacc atol 1e-3 plus rtol 1e-4 (the
error of an env scales with the largest accelerations of the solve, ~4e3
on wheel dofs, and the dense loops sum in another order than the twin's
pruned program); env slab
1e-5, the goal angle through sin and cos; K2 1e-6, also with a per-env
floor.  K1e takes the same tolerances on parameters with a +-2 cm floor
offset; the plain physics step (``<0,0,0>``, K1 and K1e) the same as the
others, also for a robot with 8-vertex hulls (padded); K3 is held at qacc
atol 1e-3 plus rtol 1e-4 on the system of 3 compat-path steps, in both of
its input layouts, and its kernel-layout instantiation equals the
row-major one bitwise on the same systems.
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
from mujoco_playground_tpu_torch.envs.poses import wall_poses
from mujoco_playground_tpu_torch.ops import build
from mujoco_playground_tpu_torch.ops import lidar as k2
from mujoco_playground_tpu_torch.ops import newton as k3
from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.physics import batchlast, engine, mathutil

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
                          (False, False, False, False),
                          (True, True, False, True),
                          (True, False, False, True),
                          (False, False, False, True)],
                         ids=["True-False", "False-True", "env-nofresh",
                              "physics", "dr-fresh", "dr-nofresh",
                              "dr-physics"])
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


@pytest.mark.parametrize("dr", [False, True], ids=["k1", "k1e"])
def test_step_kernel_source_wall_contacts(host_libs, env, dr):
    """The many-row workspace: poses pushed into a maze wall and 1-2 cm into
    the floor, through the auto-reset step's flag set for 2 chained
    steps."""
    lib = host_libs["step_kernel_dr.cu" if dr else "step_kernel.cu"]
    params = _dr_params(env) if dr else None
    model = env.model
    gen = torch.Generator().manual_seed(0)
    ph = wall_poses(env, B, gen, sink=(0.01, 0.02))
    q, v = _rows(ph.qpos), _rows(ph.qvel)
    ws = _rows(ph.qacc_warmstart)
    active = k1.contact_activity(model, q, params).sum(0)
    assert int(active.max()) >= 12
    st = env.reset(B)
    env_in = _rows(torch.cat([st.odom_ref.position[:, :2], st.goal,
                              st.prev_goal_distance[:, None], ph.qpos[:, :2]],
                             -1))
    for _ in range(2):
        ctrl = torch.rand((model.nu, B), generator=gen) * 2 - 1
        args = (model, q, v, ctrl, ws, env_in, env._env_statics(),
                env._fresh_statics(), False)
        want = k1.step_plain(*args, dr_params=params)
        got = k1.launch_k1(lib, *args, None, dr_params=params)
        for name, a, b in zip(TOL, got, want):
            _compare(name, a, b, model)
        q, v, ws = want[0], want[1], want[4]


@pytest.mark.parametrize("with_env,with_fresh,ws_compare",
                         [(True, True, True), (True, False, True),
                          (False, True, False)])
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
                          (False, True, False)])
def test_dr_step_kernel_refuses_uncompiled_variants(host_libs, env, with_env,
                                                    with_fresh, ws_compare):
    """K1e compiles only the two env-step flag sets and the plain physics
    step, and needs its parameters."""
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


@pytest.fixture(scope="module")
def staged_system():
    """The Newton system of the compat path after 3 staged steps at B, as
    the staged step assembles it, and the warm start it would take (read,
    never written, by the tests that share it)."""
    cenv = make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, device="cpu", seed=0,
                              reference_flat_manifold=True,
                              reference_wheel_patch=True)
    g = torch.Generator().manual_seed(0)
    st = cenv.reset(B)
    for _ in range(3):
        st = cenv.step_autoreset_batch(st, torch.rand((B, 2), generator=g)
                                       * 2 - 1)
    ph = st.physics
    return (engine.newton_inputs(cenv.model, ph),
            ph.qacc_warmstart.T.contiguous())


@pytest.mark.parametrize("warm", [True, False])
def test_newton_kernel_source_matches_plain_twin(host_libs, staged_system,
                                                warm):
    args, ws = staged_system
    ws = ws if warm else None
    assert args[8].shape[0] == 72          # the wheel patch's slot count
    assert float(args[14].sum()) >= B      # rows in contact
    want = k3.newton_solve_plain(*args, warmstart=ws)
    got = k3.launch_k3(host_libs["newton_kernel.cu"], *args, ws, None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-4)
    assert k3.newton_solve.launches == 0


def _row_sets(args, ws, case):
    """The staged system with other rows in contact: every row of every env
    (the pool overflows), disjoint sets of rows per env of one block with
    counts that leave the last env a window of the pool smaller than its
    rows, so it runs them in chunks (and reference accelerations that make
    the rows push), or 13 envs (the fixture's 8 and its first 5 again: the
    last block holds 5 envs)."""
    args = list(args)
    if case == "b13":
        cols = torch.tensor(list(range(B)) + list(range(5)))
        return ([a[..., cols].contiguous() if isinstance(a, torch.Tensor)
                 and a.dim() > 1 else a for a in args],
                ws[:, cols].contiguous())
    act = torch.zeros_like(args[14])
    if case == "all_rows":
        act[:] = 1.0
    else:
        # env e: rows e, e + 8, ... (9 at most), 55 rows in all
        for e, n in enumerate([2, 9, 3, 9, 9, 5, 9, 9]):
            act[e::B, e][:n] = 1.0
        # reference accelerations of 10 m/s^2, so that the rows push
        args[11] = torch.where(act[:, None, :] > 0, 10.0, args[11])
    args[14] = act
    return args, ws


@pytest.mark.parametrize("case", ["all_rows", "disjoint", "b13"])
def test_newton_kernel_source_row_sets(host_libs, staged_system, case):
    args, ws = _row_sets(*staged_system, case)
    act = args[14]
    if case == "disjoint":
        assert int(act.sum()) > 48 and float((act.sum(1) > 1).sum()) == 0
    if case == "all_rows":
        assert int(act.sum()) == 72 * B
    want = k3.newton_solve_plain(*args, warmstart=ws)
    got = k3.launch_k3(host_libs["newton_kernel.cu"], *args, ws, None)
    assert got.shape == want.shape and bool(torch.isfinite(want).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-4)


def _kernel_layout(args):
    """K3's row-major arguments moved to the kernel layout: G (nv, nj, B),
    Jn / Jt1 / Jt2 (nv, nc, B), c_aref (4, nc, B), contiguous."""
    return [torch.movedim(a, 0, 1).contiguous() if i in (2, 8, 9, 10, 11)
            else a for i, a in enumerate(args)]


@pytest.mark.parametrize("case", ["staged", "all_rows", "disjoint", "b13"])
def test_newton_kernel_source_kernel_layout(host_libs, staged_system, case):
    """The kernel-layout instantiation on the same systems: bitwise the
    row-major one's (the same values, other addresses), and within the
    row-major test's tolerance of the twin (also when the pool overflows
    and envs run their rows through it in chunks)."""
    args, ws = (staged_system if case == "staged"
                else _row_sets(*staged_system, case))
    lib = host_libs["newton_kernel.cu"]
    row_major = k3.launch_k3(lib, *args, ws, None)
    got = k3.launch_k3(lib, *_kernel_layout(args), ws, None,
                       pre_transposed=True)
    assert torch.equal(got, row_major)
    want = k3.newton_solve_plain(*_kernel_layout(args), warmstart=ws,
                                 pre_transposed=True)
    assert torch.equal(want, k3.newton_solve_plain(*args, warmstart=ws))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-4)
    assert k3.newton_solve.launches_kernel_layout == 0


def test_newton_kernel_checks_kernel_layout_inputs(host_libs, staged_system):
    args, ws = staged_system
    lib = host_libs["newton_kernel.cu"]
    kl = _kernel_layout(args)
    with pytest.raises(ValueError, match="shape"):      # row-major G
        k3.launch_k3(lib, *(kl[:2] + [args[2]] + kl[3:]), ws, None,
                     pre_transposed=True)
    with pytest.raises(ValueError, match="shape"):      # row-major c_aref
        k3.launch_k3(lib, *(kl[:11] + [args[11]] + kl[12:]), ws, None,
                     pre_transposed=True)
    with pytest.raises(ValueError, match="contiguous"):  # a moved view
        k3.launch_k3(lib, *(kl[:8] + [torch.movedim(args[8], 0, 1)]
                            + kl[9:]), ws, None, pre_transposed=True)
    bad = list(kl)
    bad[8] = torch.zeros((12, 73, B))
    bad[9], bad[10] = bad[8], bad[8]
    bad[11] = torch.zeros((4, 73, B))
    bad[12] = bad[13] = bad[14] = torch.zeros((73, B))
    with pytest.raises(ValueError, match="at most"):
        k3.launch_k3(lib, *bad, ws, None, pre_transposed=True)


def test_step_kernel_source_padded_hulls(host_libs, env):
    """A robot whose chassis hulls have fewer vertices than the kernel holds
    (the MJCF round trip's box corners, 8 of 36): the constant block pads
    them with vertices no quadrant lists.  Held on the plain physics step
    from poses pressed into the walls and floor, where the hulls touch."""
    from mujoco_playground_tpu_torch.physics.model import make_model
    from mujoco_playground_tpu_torch.spec import mjcf, mjcf_import, robot
    spec = mjcf_import.from_mjcf(mjcf.to_mjcf(robot.ackermann_robot_v2()))
    model = make_model(spec, env.scene, solver_iterations=4, ls_iterations=3,
                       device="cpu")
    assert model.chassis_hull_verts.shape[1] == 8
    gen = torch.Generator().manual_seed(6)
    ph = wall_poses(env, B, gen, sink=(0.01, 0.02))
    q, v = _rows(ph.qpos), _rows(ph.qvel)
    ws = _rows(ph.qacc_warmstart)
    hull_rows = k1.contact_activity(model, q)[-16:].sum()
    assert int(hull_rows) >= 4
    lib = host_libs["step_kernel.cu"]
    for _ in range(2):
        ctrl = torch.rand((model.nu, B), generator=gen) * 2 - 1
        args = (model, q, v, ctrl, ws, None, None, None, False)
        want = k1.step_plain(*args)
        got = k1.launch_k1(lib, *args, None)
        for name, a, b in zip(TOL, got, want):
            _compare(name, a, b, model)
        q, v, ws = want[0], want[1], want[4]


def test_newton_kernel_checks_its_inputs(host_libs, staged_system):
    args, ws = staged_system
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


def test_lidar_kernel_source_per_env_floor(host_libs, env):
    """K2 with each env's floor height (the default randomization's floors,
    widened to +-2 cm) on frames pitched 8 degrees down, so that beams meet
    the floor; the same launch with the model's floor differs."""
    model = env.model
    st = env.reset(B)
    q = st.physics.qpos.clone()
    half = np.deg2rad(8.0) / 2
    pitch = torch.tensor([np.cos(half), 0.0, np.sin(half), 0.0])
    q[:, 3:7] = mathutil.quat_mul(q[:, 3:7], pitch.expand(B, 4))
    xpos, xquat = batchlast.fk_bl(model, q.T)
    xpos = torch.cat(xpos).contiguous()
    xquat = torch.cat(xquat).contiguous()
    floor = randomize_model(model, torch.Generator().manual_seed(4), B,
                            RandomizationConfig(floor_z_offset=(-0.02, 0.02))
                            ).plane_z
    lib = host_libs["lidar_kernel.cu"]
    got = k2.launch_k2(lib, model, xpos, xquat, None, floor)
    want = k2.lidar_plain(model, xpos, xquat, floor)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    base = k2.launch_k2(lib, model, xpos, xquat, None)
    assert float((base - got).abs().max()) > 1e-3
    assert k2.lidar.launches == k2.lidar.launches_floor == 0
    with pytest.raises(ValueError, match="shape"):
        k2.launch_k2(lib, model, xpos, xquat, None, floor[:-1])


def test_lidar_kernel_source_no_hit_and_cutoff(host_libs, env):
    """B=13 (a partial block of envs): env 0 high above the maze (level
    beams hit nothing: -1), env 1 as high and pitched 10 degrees (beams
    that meet the floor beyond the cutoff read the cutoff), the rest
    reset frames."""
    model = env.model
    n = 13
    st = env.reset(n)
    xpos, xquat = _rows(st.physics.xpos), _rows(st.physics.xquat)
    for e in (0, 1):
        xpos[3:6, e] = torch.tensor([0.0, 0.0, 5.0])
    half = np.deg2rad(10.0) / 2
    xquat[4:8, 0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    xquat[4:8, 1] = torch.tensor([np.cos(half), 0.0, np.sin(half), 0.0])
    got = k2.launch_k2(host_libs["lidar_kernel.cu"], model, xpos, xquat,
                       None)
    want = k2.lidar_plain(model, xpos, xquat)
    cutoff = float(model.sensor_cutoff.max())
    assert bool((want[:, 0] == -1.0).all())
    assert bool((want[:, 1] == cutoff).any())
    assert bool((want[:, 1] == -1.0).any())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


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
