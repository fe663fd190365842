"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``mujoco_playground_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch twin on the card, then drives
the port's main path: ``make_ackermann_env("maze", "umaze",
solver_iterations=4, ls_iterations=3)``, a batched reset and 200 steps of
``step_autoreset_batch`` over 16384 lockstep envs with uniform random
actions.  It checks that the main path went through the kernels (launch
counts), that its outputs are finite, times the kernels and the env step
with CUDA events, and prints one JSON line of kernel numbers and, last, the
device line.  Exits non-zero on any failure, and when no CUDA device exists.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN = 16384        # envs of the main path (the umaze bench's width)
STEPS = 200           # main-path env steps
WARMUP = 20           # of those, untimed
PROFILE_STEPS = 10    # further steps under torch.profiler
B_CHECK = 1024        # envs of the kernel-vs-twin checks
CHECK_STEPS = 3
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores, at the 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# (atol, rtol) of each K1 output against the plain twin on the same inputs,
# about 10x the largest difference read on an H100 (PERF.md).  qpos, xpos
# and xquat: float32 rounding of ~1 m values.  qvel and qacc are held per
# env, normwise: the Newton solve mixes all dofs of an env, so rtol
# multiplies the env's largest |value| of that output (accelerations reach
# 1e4 in wall contacts; the readings are ~3e-5 of that).  Env slab: lidar
# readings, in meters, lose relative precision where a beam meets the floor
# at a grazing angle (~1e-5 of the reading).
K1_TOL = dict(qpos=(1e-6, 0.0), qvel=(1e-5, 3e-4), xpos=(1e-6, 0.0),
              xquat=(1e-6, 0.0), qacc=(1e-2, 3e-4), slab=(1e-5, 1e-4))
K1_NORMWISE = ("qvel", "qacc")
K2_TOL = (5e-6, 0.0)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call of fn over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(got, want, atol, rtol, normwise=False):
    """(max abs error, max error relative to the reference, worst excess
    over atol + rtol |want|) of (rows, B) outputs; ``normwise`` measures
    each env (column) by its largest |error| and largest |want|."""
    d = (got - want).abs()
    ref = want.abs()
    if normwise:
        d, ref = d.amax(0), ref.amax(0)
    rel = float((d / ref.clamp_min(1e-30)).max())
    return float(d.max()), rel, float((d - atol - rtol * ref).max())


def angle_free(slab, model):
    """The env slab with its goal-angle row as sin and cos rows (a wrap may
    differ by 2 pi at +-pi)."""
    a = model.nsite + 6
    return torch.cat([slab[:a], slab[a + 1:], torch.sin(slab[a:a + 1]),
                      torch.cos(slab[a:a + 1])])


def check_k1(label, got, want, model, failures):
    """Prints each K1 output's max error against the twin; appends the ones
    over tolerance to failures; returns the max abs error over them all."""
    worst = 0.0
    for name, g, w in zip(K1_TOL, got, want):
        atol, rtol = K1_TOL[name]
        if name == "slab":
            g, w = angle_free(g, model), angle_free(w, model)
        normwise = name in K1_NORMWISE
        err, rel, excess = max_err(g, w, atol, rtol, normwise)
        per = " per env" if normwise else ""
        relative = f", max |err|/|ref|{per} {rel:.3e}" if rtol else ""
        print(f"check K1 {label} {name}: max |err| {err:.3e}{relative} (tol "
              f"{atol:g} + {rtol:g}|ref|{per})")
        if not math.isfinite(err) or excess > 0:
            failures.append(f"K1 {label} {name}")
        worst = max(worst, err)
    return worst


def check_k2(label, got, want, failures):
    err, _, excess = max_err(got, want, *K2_TOL)
    print(f"check K2 {label}: max |err| {err:.3e} (tol {K2_TOL[0]:g})")
    if not math.isfinite(err) or excess > 0:
        failures.append(f"K2 {label}")
    return err


def ptxas_report(logs):
    """Per kernel function: registers, stack and spill bytes from -Xptxas -v."""
    rows = []
    for src, text in logs.items():
        fn = None
        for line in text.splitlines():
            if "Compiling entry function" in line or "Function properties" in line:
                fn = line.split("'")[1] if "'" in line else line.split()[-1]
            if "bytes stack frame" in line or "Used" in line:
                rows.append(f"{src} {fn}: {line.split(':', 1)[-1].strip()}")
    return rows


def chol_ops(pat, order):
    """(factor, solve) float32 operations of the Cholesky of an SPD matrix
    whose structural nonzeros are ``pat``, eliminated in ``order``, fill-in
    included: 2 per update L[i,j] -= L[i,k] L[j,k] with both factors
    nonzero, then 1 per scaled entry and the pivot's rsqrt; 2 per
    off-diagonal nonzero and 1 division per row in each triangular solve."""
    p = list(order)
    L = np.tril(pat[np.ix_(p, p)])
    fac = 0
    for j in range(len(p)):
        for k in range(j):
            if L[j, k]:
                rows = j + np.flatnonzero(L[j:, k])
                fac += 2 * len(rows)
                L[rows, j] = True
        fac += 1 + int(L[j:, j].sum())
    return fac, 2 * (2 * int(np.tril(L, -1).sum()) + len(p))


def k1_ops(model, slot_active, fresh=True, ws_compare=False):
    """Float32 operations one env step of K1 needs (an FMA counts 2),
    counted over the structural nonzeros only, as the TPU kernel's static
    pruning keeps them: each body's Jacobian over its ancestor dofs (CRBA,
    RNEA, contact rows), the tree-sparse factor and solves of M and of the
    Newton Hessian (M's pattern plus the equality rows' couplings) in the
    leaves-first order, and only the contact rows this run's data makes
    active (``slot_active``: each slot's mean activity over the envs).  The
    per-stage constants are the operations of the kernel's code
    (csrc/step_model.cuh, step_newton.cuh, lidar.cuh)."""
    from mujoco_playground_tpu_torch.ops import step as k1
    sm = k1.static_model(model)
    nv, nbox, ns = sm.nv, sm.num_scene_boxes, sm.nsite
    anc = [np.flatnonzero(sm.ancestor_mask[b]) for b in range(sm.nbody)]
    n = {b: len(anc[b]) for b in range(sm.nbody)}
    m_pat = np.eye(nv, dtype=bool)
    for b in sm.bodies:
        m_pat[np.ix_(anc[b], anc[b])] = True
    h_pat = m_pat.copy()
    for d1, d2 in sm.eq_dof_pairs:
        h_pat[d1, d2] = h_pat[d2, d1] = True
    slot_body = [s[0] for s in k1.slot_statics(sm)]
    for b in set(slot_body):
        h_pat[np.ix_(anc[b], anc[b])] = True
    nnz_m = int(m_pat.sum())
    fac_m, sol_m = chol_ops(m_pat, sm.order)
    fac_h, sol_h = chol_ops(h_pat, sm.order)
    nj = (len(sm.eq_dof_pairs) + len(sm.friction_dofs)
          + 2 * len(sm.limited_dofs))

    def contacts(f):
        """Expected sum of f(n) over this run's active contact rows, n the
        row's dof count."""
        return sum(p * f(n[b]) for p, b in zip(slot_active, slot_body))

    types = list(sm.jnt_type)
    fk = (61 * (sm.nbody - 1) + 100 * types.count(1) + 12 * types.count(0)
          + 34 * (len(types) - types.count(0) - types.count(1)))
    crba = sum(150 + 72 * n[b] + 6 * n[b] * (n[b] + 1) + 12 * n[b]
               for b in sm.bodies)
    rnea = (sum(18 * n[b] + 174 for b in sm.bodies)
            + 36 * sum(sm.carried) + 25 * nv)
    smooth = 12 * sm.nu + 3 * nv + fac_m + sol_m
    nw, nh = len(sm.wheel_body), len(sm.chassis_box_body)
    nhv = sm.chassis_hull_verts.shape[1]
    collide = (nw * (120 + (12 * nbox + 280 if nbox else 0))
               + nh * (30 + 18 * nhv + 60
                       + (12 * nbox + 50 * nhv + 180 if nbox else 0)))
    rows = 25 * nj + contacts(lambda k: 33 * k + 40)
    newton_it = (20 * nj + contacts(lambda k: 20 * k + 3 * k * (k + 1) + 36)
                 + 36 + 2 * nnz_m + fac_h + sol_h
                 + 3 * nj + contacts(lambda k: 6 * k + 4) + 2 * nnz_m + 48
                 + sm.ls_iterations * (5 + 10 * nj + contacts(lambda k: 42))
                 + 2 * nv)
    ws = (2 * (12 * nj + contacts(lambda k: 6 * k + 24)) + 2 * nnz_m + 36
          if ws_compare else 0)
    euler = 2 * nnz_m + 4 * nv + fac_m + sol_m + nv + 56 + 2 * (nv - 6)
    lidar = (2 if fresh else 1) * ns * (72 + 27 * nbox)
    env = 60 + ns + (8 * sm.nbody if fresh else 0)
    return (2 * fk + crba + rnea + smooth + collide + rows
            + sm.iterations * newton_it + ws + euler + lidar + env)


def bound_ms(nbytes, flops):
    t_b = nbytes / PEAK_BYTES * 1e3
    t_f = flops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke run needs one NVIDIA GPU")
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    from mujoco_playground_tpu_torch.ops import build
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import step as k1
    from mujoco_playground_tpu_torch.physics.state import make_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_name_and_limit()

    # -- phase 1: build ----------------------------------------------------
    t = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t:.1f} s for {', '.join(logs)} "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for row in ptxas_report(logs):
        print(f"  ptxas {row}")
    print(f"card: {card}")

    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, seed=SEED)
    model = env.model
    statics, fresh = env._env_statics(), env._fresh_statics()

    def rows(x):
        """A batch's leaf (B, ...) as the kernels' (rows, B); one env's
        leaf as (rows, 1)."""
        if x.dim() == 1:
            return x[:, None].contiguous()
        return x.reshape(x.shape[0], -1).T.contiguous()

    # -- phase 2: kernels against their plain twins -------------------------
    # K1's two variants at B_CHECK from reset states, 3 chained steps; the
    # settle variant (ws_compare, no env rows) also at B=1 on the settle
    # input, as AckermannEnv.__init__ runs it; K2 on the reset frames
    failures = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    st = env.reset(B_CHECK)
    env_in = torch.cat([st.odom_ref.position[:, :2], st.goal,
                        st.prev_goal_distance[:, None],
                        env.reset_core(B_CHECK).physics.qpos[:, :2]],
                       -1).T.contiguous()
    qpos_settle = model.qpos0.clone()
    qpos_settle[2] = env.scene.floor_z + 0.055
    settle = make_state(model, qpos=qpos_settle)
    runs = ((f"env+fresh B={B_CHECK}", st.physics, True, False, B_CHECK),
            (f"ws_compare B={B_CHECK}", st.physics, False, True, B_CHECK),
            ("ws_compare settle B=1", settle, False, True, 1))
    for label, ph, with_env, ws_compare, b in runs:
        q, v = rows(ph.qpos), rows(ph.qvel)
        ws = rows(ph.qacc_warmstart)
        for step in range(CHECK_STEPS):
            ctrl = (rows(settle.ctrl) if b == 1 else
                    torch.rand((3, b), generator=gen, device=dev) * 2 - 1)
            args = (model, q, v, ctrl, ws,
                    env_in if with_env else None,
                    statics if with_env else None,
                    fresh if with_env else None, ws_compare)
            got = k1.step_fused(*args)
            want = k1.step_plain(*args)
            torch.cuda.synchronize()
            check_k1(f"{label} step {step}", got, want, model, failures)
            q, v, ws = want[0], want[1], want[4]
    xp, xq = rows(st.physics.xpos), rows(st.physics.xquat)
    check_k2(f"B={B_CHECK}", k2.lidar(model, xp, xq),
             k2.lidar_plain(model, xp, xq), failures)
    if failures:
        fail(f"kernels disagree with their plain twins: {failures}")

    # -- phase 3: the main path ---------------------------------------------
    act_gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    k1.step_fused.launches = 0
    k2.lidar.launches = 0
    states = reset_states = env.reset(B_MAIN)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for i in range(STEPS):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0.record()
        actions = torch.rand((B_MAIN, 2), generator=act_gen, device=dev) * 2 - 1
        states = env.step_autoreset_batch(states, actions)
    t1.record()
    torch.cuda.synchronize()
    launches = {"K1": k1.step_fused.launches, "K2": k2.lidar.launches}
    step_ms = t0.elapsed_time(t1) / (STEPS - WARMUP)
    print(f"main path: B={B_MAIN}, {STEPS} steps, launches {launches}, "
          f"{step_ms:.4f} ms/env step, "
          f"{B_MAIN / step_ms * 1e3:.0f} env-steps/s ({card})")
    if launches["K1"] != STEPS:
        fail(f"K1 ran {launches['K1']} times in {STEPS} main-path steps")
    if launches["K2"] < 1:
        fail("K2 did not run at reset")
    for name, x in (("obs", states.obs), ("reward", states.reward),
                    ("qpos", states.physics.qpos),
                    ("qvel", states.physics.qvel),
                    ("final_obs", states.final_obs)):
        if not bool(torch.isfinite(x).all()):
            fail(f"main path: non-finite {name}")
    if tuple(states.obs.shape) != (B_MAIN, env.obs_size):
        fail(f"main path: obs shape {tuple(states.obs.shape)}")
    done = int(states.done.sum())
    print(f"main path outputs finite; obs {tuple(states.obs.shape)}, "
          f"{done} envs done on the last step")

    # where a main-path step's time goes: device time by kernel over a
    # short profiled window, and the device's idle share of the wall time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            actions = torch.rand((B_MAIN, 2), generator=act_gen,
                                 device=dev) * 2 - 1
            states = env.step_autoreset_batch(states, actions)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    kern = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy_us = sum(k[0] for k in kern)
    print(f"profile of {PROFILE_STEPS} main-path steps: wall "
          f"{wall_us / PROFILE_STEPS:.1f} us/step, device busy "
          f"{busy_us / PROFILE_STEPS:.1f} us/step, idle share "
          f"{1 - busy_us / wall_us:.3f} ({card})")
    for us, count, name in kern[:8]:
        print(f"  {us / PROFILE_STEPS:9.1f} us/step  x{count // PROFILE_STEPS:<3d}"
              f" {name[:90]}")

    # -- phase 4: the kernels at the main-path shape -------------------------
    # K1 as the main path calls it (<with_env, with_fresh, !ws_compare>) on
    # the last main-path states, K2 on the reset frames it scanned; each
    # held against its twin on the same inputs, then timed
    ph = states.physics
    q, v, ws = rows(ph.qpos), rows(ph.qvel), rows(ph.qacc_warmstart)
    ctrl = torch.rand((3, B_MAIN), generator=gen, device=dev) * 2 - 1
    env_in = torch.cat([states.odom_ref.position[:, :2], states.goal,
                        states.prev_goal_distance[:, None],
                        env.reset_core(B_MAIN).physics.qpos[:, :2]],
                       -1).T.contiguous()
    args = (model, q, v, ctrl, ws, env_in, statics, fresh, False)
    xp, xq = rows(reset_states.physics.xpos), rows(reset_states.physics.xquat)
    got, want = k1.step_fused(*args), k1.step_plain(*args)
    k1_err = check_k1(f"main B={B_MAIN}", got, want, model, failures)
    k2_err = check_k2(f"B={B_MAIN}", k2.lidar(model, xp, xq),
                      k2.lidar_plain(model, xp, xq), failures)
    if failures:
        fail(f"kernels disagree with their plain twins: {failures}")
    # the conditioning behind the tolerances: the twin in float64 on the
    # same inputs, and how far the kernel and the float32 twin are from it
    exact = k1.step_plain(model, *(t.double() for t in args[1:6]),
                          *args[6:])
    for name, g, w, x in zip(K1_TOL, got, want, exact):
        if name == "slab":
            g, w, x = (angle_free(t, model) for t in (g, w, x))
        print(f"float64 twin, {name}: max |kernel - f64| "
              f"{float((g.double() - x).abs().max()):.3e}, max |f32 twin - "
              f"f64| {float((w.double() - x).abs().max()):.3e}")
    del got, want, exact
    k1_ms = cuda_ms(lambda: k1.step_fused(*args), 20)
    k1_plain_ms = cuda_ms(lambda: k1.step_plain(*args), 2)
    k2_ms = cuda_ms(lambda: k2.lidar(model, xp, xq), 50)
    k2_plain_ms = cuda_ms(lambda: k2.lidar_plain(model, xp, xq), 3)
    slot_active = k1.contact_activity(model, q).float().mean(1).tolist()
    nbox = model.num_scene_boxes
    k1_bytes = (model.nq + 2 * model.nv + model.nu + 7 + model.nq
                + model.nv + model.nbody * 7 + model.nv
                + 2 * model.nsite + 12) * 4 * B_MAIN
    k1_flop = k1_ops(model, slot_active)
    k1_bound, k1_by = bound_ms(k1_bytes, k1_flop * B_MAIN)
    k2_bytes = (model.nbody * 7 + model.nsite) * 4 * B_MAIN
    k2_bound, k2_by = bound_ms(
        k2_bytes, model.nsite * (72 + 27 * nbox) * B_MAIN)
    print(f"K1: {k1_ms:.4f} ms (plain {k1_plain_ms:.2f} ms, bound "
          f"{k1_bound:.5f} ms by {k1_by}: {k1_flop:.0f} operations per env"
          f" with {sum(slot_active):.2f} active contact rows per env); K2: "
          f"{k2_ms:.4f} ms (plain {k2_plain_ms:.2f} ms, bound "
          f"{k2_bound:.5f} ms by {k2_by}) at B={B_MAIN} ({card})")

    print(json.dumps({"kernels": [
        {"name": "K1 step (fused env + fresh scan)", "route": "cuda",
         "source": "mujoco_playground_tpu_torch/csrc/step_kernel.cu",
         "replaces": "mujoco_playground_tpu/ops/step_pallas.py:955",
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "K2 lidar", "route": "cuda",
         "source": "mujoco_playground_tpu_torch/csrc/lidar_kernel.cu",
         "replaces": "mujoco_playground_tpu/ops/lidar_pallas.py:114",
         "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
