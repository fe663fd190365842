"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``mujoco_playground_tpu_torch/csrc`` with nvcc
(one nvcc per source, all at once), holds each kernel against its plain
PyTorch twin on the card, then drives the port's three paths over 16384
lockstep envs of ``make_ackermann_env("maze", "umaze", solver_iterations=4,
ls_iterations=3)`` with uniform random actions:

* the main path: a batched reset and 200 steps of ``step_autoreset_batch``
  (kernel K1, K2 at reset);
* path A: ``DomainRandomizedEnv`` for 200 steps (kernel K1e);
* path B: the same env with the compat manifolds
  (``reference_flat_manifold``, ``reference_wheel_patch``): the staged step
  through kernel K3, the observation through K2.

Each path runs with the launch counts set to 0 just before it and read just
after; it checks that the path went through its kernels and that its
outputs are finite, and times it with CUDA events.  Then each kernel is
held against its twin at the paths' shapes and timed beside its bound.  It
prints one JSON line of kernel numbers and, last, the device line.  Exits
non-zero on any failure, and when no CUDA device exists.
"""
from __future__ import annotations

import dataclasses
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
DR_STEPS = 200        # path A env steps (WARMUP of them untimed)
SAME_STEPS = 10       # of those, from one shared start with shared actions
STAGED_STEPS = 200    # path B env steps (spawned robots land by ~100)
STAGED_WARMUP = 20
STAGED_PROFILE = 5

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
# K3's qacc against its twin, per env and normwise like K1's qacc: the
# kernel and the twin sum the Hessian and gradients over the contact rows
# in different orders (the kernel row by row over the rows in contact, the
# twin over all rows at once), and the solve mixes every dof of an env
K3_TOL = (1e-2, 3e-4)
# K1 is held strictly at every shape.  K1e and K3 at the paths' B=16384
# shapes: a few envs may sit where the step itself is ill-conditioned, so
# that a rounding difference flips a contact or friction row between
# active and inactive and the kernel and its float32 twin land on
# different sides (PERF.md).  Such an env may exceed the tolerance only if
# the twins show it ill-conditioned without the kernel: fed the same
# inputs with qpos, qvel and the warm start (K3: the smooth acceleration,
# the reference accelerations and the warm start) each moved one float32
# ulp up or down at random, the float64 or the float32 twin moves by more
# than the tolerance in one of ULP_DRAWS draws.  At most MAX_FLIPS envs
# may be set aside; their ids and the twins' moves are printed, and
# max_abs_err covers all envs.
MAX_FLIPS = 16
ULP_DRAWS = 8


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


def env_ratio(got, want, atol, rtol, normwise):
    """Per env (column): its largest |got - want| in units of atol + rtol
    |want| (normwise: the env's largest |error| against its largest
    |want|); over 1 is over tolerance."""
    d = (got.double() - want.double()).abs()
    ref = want.double().abs()
    if normwise:
        return d.amax(0) / (atol + rtol * ref.amax(0))
    return (d / (atol + rtol * ref)).amax(0)


def outputs_ratio(got, want, tols):
    """Per env: env_ratio's largest value over the outputs."""
    return torch.stack([env_ratio(g, w, *tol)
                        for g, w, tol in zip(got, want, tols)]).amax(0)


def nudge(t, gen):
    """Float32 t with every entry moved one ulp up or down at random."""
    up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
    inf = torch.full_like(t, math.inf)
    return torch.nextafter(t, torch.where(up, inf, -inf))


def ill_conditioned(run, tols, gen, got):
    """Per env of a subset, how far the twins move when the inputs move one
    ulp: ``run(dtype, nudged)`` gives the twin's outputs in dtype on the
    subset's inputs, ``nudged`` with one-ulp moves; tols lists (atol, rtol,
    normwise) per output; got is the kernel's outputs on the subset.
    Returns the largest move of the float64 and of the float32 twin over
    ULP_DRAWS draws, and the kernel's distance to the nearest twin run, all
    in units of the tolerance (outputs_ratio)."""
    moved, near = [], None
    for dtype in (torch.float64, torch.float32):
        base = run(dtype, False)
        most = torch.zeros(got[0].shape[-1], dtype=torch.float64,
                           device=got[0].device)
        for draw in range(ULP_DRAWS + 1):
            out = base if draw == 0 else run(dtype, True)
            most = torch.maximum(most, outputs_ratio(out, base, tols))
            gap = outputs_ratio(got, out, tols)
            near = gap if near is None else torch.minimum(near, gap)
        moved.append(most)
    return moved[0], moved[1], near


def set_aside(label, over, witness, got, failures):
    """Of the envs over tolerance (bool (B,)), those ``witness`` (env ids
    and the kernel's outputs on them -> ill_conditioned's moves) shows
    ill-conditioned without the kernel, at most MAX_FLIPS: a twin moves by
    more than the tolerance.  Appends a failure for any other.  Returns
    the bool (B,) mask of the envs set aside."""
    ids = torch.nonzero(over).flatten()
    aside = torch.zeros_like(over)
    if len(ids) > MAX_FLIPS:
        print(f"check {label}: {len(ids)} envs over tolerance (allowed: "
              f"{MAX_FLIPS} if ill-conditioned)")
        failures.append(f"{label} envs over tolerance")
        return aside
    print(f"check {label}: envs over tolerance {ids.tolist()}")
    if not len(ids):
        return aside
    moved64, moved32, near = witness(ids, [g[..., ids] for g in got])
    ill = (moved64 > 1) | (moved32 > 1)
    aside[ids[ill]] = True
    for i, env in enumerate(ids.tolist()):
        print(f"  env {env}: under one-ulp input moves the float64 twin "
              f"moves {float(moved64[i]):.3g}x and the float32 twin "
              f"{float(moved32[i]):.3g}x the tolerance; the kernel is "
              f"{float(near[i]):.3g}x it from the nearest twin run; "
              f"{'set aside' if bool(ill[i]) else 'NOT ill-conditioned'}")
    if not bool(ill.all()):
        failures.append(f"{label} envs over tolerance, not ill-conditioned")
    return aside


def angle_free(slab, model):
    """The env slab with its goal-angle row as sin and cos rows (a wrap may
    differ by 2 pi at +-pi)."""
    a = model.nsite + 6
    return torch.cat([slab[:a], slab[a + 1:], torch.sin(slab[a:a + 1]),
                      torch.cos(slab[a:a + 1])])


K1_TOLS = [K1_TOL[n] + (n in K1_NORMWISE,) for n in K1_TOL]


def k1_views(outs, model):
    """K1's outputs as the checks compare them (the slab angle-free)."""
    return [angle_free(t, model) if name == "slab" else t
            for name, t in zip(K1_TOL, outs)]


def check_outputs(label, names, tols, got, want, failures, witness=None):
    """Prints each output's max error against the twin; appends the ones
    over tolerance to failures; returns the max abs error over all envs.
    With ``witness`` (see set_aside) envs over tolerance may be set aside,
    and each output's error is printed over all envs and over the rest."""
    aside = None
    if witness is not None:
        over = outputs_ratio(got, want, tols) > 1
        aside = set_aside(label, over, witness, got, failures)
    worst = 0.0
    for name, g, w, (atol, rtol, normwise) in zip(names, got, want, tols):
        err, rel, excess = max_err(g, w, atol, rtol, normwise)
        per = " per env" if normwise else ""
        relative = f", max |err|/|ref|{per} {rel:.3e}" if rtol else ""
        rest = ""
        if aside is not None and bool(aside.any()):
            err_r, rel_r, excess = max_err(g[..., ~aside], w[..., ~aside],
                                           atol, rtol, normwise)
            rest = (f"; other envs {err_r:.3e}"
                    + (f", {rel_r:.3e}" if rtol else ""))
        print(f"check {label} {name}: max |err| {err:.3e}{relative}{rest} "
              f"(tol {atol:g} + {rtol:g}|ref|{per})")
        if not math.isfinite(err) or excess > 0:
            failures.append(f"{label} {name}")
        worst = max(worst, err)
    return worst


def check_k1(label, got, want, model, failures, witness=None):
    return check_outputs(f"K1 {label}", list(K1_TOL), K1_TOLS,
                         k1_views(got, model), k1_views(want, model),
                         failures, witness)


def check_k3(label, got, want, failures, witness=None):
    return check_outputs(f"K3 {label}", ["qacc"], [K3_TOL + (True,)],
                         [got], [want], failures, witness)


def k1e_witness(args, dr_params, gen):
    """set_aside's witness for K1e's check on ``args`` (step_plain's)."""
    from mujoco_playground_tpu_torch.ops import step as k1
    model, q, v, ctrl, ws, env_in, statics, fresh, ws_compare = args

    def witness(ids, got):
        def run(dtype, nudged):
            def sub(t, move=False):
                t = t[:, ids].contiguous()
                return (nudge(t, gen) if move and nudged else t).to(dtype)
            return k1_views(k1.step_plain(
                model, sub(q, True), sub(v, True), sub(ctrl), sub(ws, True),
                sub(env_in), statics, fresh, ws_compare,
                dr_params=sub(dr_params)), model)
        return ill_conditioned(run, K1_TOLS, gen, got)
    return witness


def k3_witness(args, ws, gen):
    """set_aside's witness for K3's check on ``args`` (newton_solve's)."""
    from mujoco_playground_tpu_torch.ops import newton as k3
    moved = (1, 3, 11)     # a_s, j_aref, c_aref

    def witness(ids, got):
        def run(dtype, nudged):
            def sub(i, t, move=False):
                if not isinstance(t, torch.Tensor):
                    return t
                t = t[..., ids].contiguous()
                return (nudge(t, gen) if move and nudged else t).to(dtype)
            return [k3.newton_solve_plain(
                *(sub(i, t, i in moved) for i, t in enumerate(args)),
                warmstart=sub(-1, ws, True))]
        return ill_conditioned(run, [K3_TOL + (True,)], gen, got)
    return witness


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


def k3_bytes(nv, nj, nc, na):
    """Bytes one env of K3 must move, counted as k3_ops counts operations:
    M, a_s, the warm start and every joint row in, the nc active flags, the
    na rows in contact (Jn, Jt1, Jt2, c_aref, c_R, c_mu) in, qacc out."""
    return 4 * (nv * nv + 3 * nv + nj * (nv + 4) + nc
                + na * (3 * nv + 6))


def k3_ops(nv, jg, na, iterations, ls_iterations, warm):
    """Float32 operations of one env of K3 (an FMA counts 2), counted over
    the dense rows csrc/newton_kernel.cu processes: every joint row (jg: the
    nonzero count of each row's G, which the Hessian and J^T f loops skip
    to) and the na contact rows in contact, each with all nv columns."""
    nj = len(jg)
    chol = sum((nv - j) * (2 * j + 1) + 1 for j in range(nv)) + 2 * nv * nv
    rows_val = nj * (2 * nv + 2) + na * (6 * nv + 12)
    cost = nj * (2 * nv + 12) + na * (6 * nv + 40)
    ws = 2 * cost + 2 * nv * nv + 4 * nv if warm else 0
    it = (rows_val + nj * 8 + na * 16                      # values, forces
          + sum(2 * g + g * (g + 1) for g in jg)           # J^T f, G^T w G
          + na * (6 * nv + 16 + 8 * nv + 3 * nv * (nv + 1))  # contact blocks
          + 2 * nv * nv + 3 * nv + nv + chol               # grad, solve
          + nj * 2 * nv + na * (6 * nv + 4) + 2 * nv * nv + 4 * nv
          + ls_iterations * (5 + 10 * nj + 38 * na)         # line search
          + 2 * nv)
    return ws + iterations * it


def wall_poses(env, B, gen):
    """B umaze states next to walls, at rest controls: the settled template
    moved to a random free cell, pushed 0.37-0.43 m from the cell's center
    toward one of its four sides (walls bound most of them), at a random
    yaw, so wheels and hulls touch wall boxes at depths up to a few cm."""
    from mujoco_playground_tpu_torch.physics import batchlast
    from mujoco_playground_tpu_torch.physics import mathutil as mu
    dev = env.device
    tpl = env._template
    cells = env._free_cells
    ci = torch.randint(0, cells.shape[0], (B,), generator=gen, device=dev)
    side = torch.randint(0, 4, (B,), generator=gen, device=dev)
    dirs = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]],
                        device=dev)[side]
    u = torch.rand((B, 3), generator=gen, device=dev)
    xy = cells[ci] + dirs * (0.37 + 0.06 * u[:, :1])
    yaw = (u[:, 1] * 2 - 1) * math.pi
    qz = torch.stack([torch.cos(yaw / 2), torch.zeros_like(yaw),
                      torch.zeros_like(yaw), torch.sin(yaw / 2)], -1)
    qpos = tpl.qpos.expand(B, -1).clone()
    qpos[:, :2] = xy
    qpos[:, 3:7] = mu.quat_mul(qz, tpl.qpos[3:7].expand(B, 4))
    qvel = 0.05 * (torch.rand((B, env.model.nv), generator=gen, device=dev)
                   * 2 - 1)
    xpos, xquat = batchlast.fk_bl(env.model, qpos.T)
    return env.reset_core(B).physics.replace(
        qpos=qpos, qvel=qvel, xpos=torch.stack([x.T for x in xpos], 1),
        xquat=torch.stack([x.T for x in xquat], 1),
        ctrl=torch.zeros((B, env.model.nu), device=dev))


def reset_counts():
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.ops import step as k1
    k1.step_fused.launches = k1.step_fused.launches_dr = 0
    k2.lidar.launches = k3.newton_solve.launches = 0


def read_counts():
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.ops import step as k1
    return {"K1": k1.step_fused.launches, "K1e": k1.step_fused.launches_dr,
            "K2": k2.lidar.launches, "K3": k3.newton_solve.launches}


def check_finite(label, states, obs_size, B):
    for name, x in (("obs", states.obs), ("reward", states.reward),
                    ("qpos", states.physics.qpos),
                    ("qvel", states.physics.qvel),
                    ("final_obs", states.final_obs)):
        if not bool(torch.isfinite(x).all()):
            fail(f"{label}: non-finite {name}")
    if tuple(states.obs.shape) != (B, obs_size):
        fail(f"{label}: obs shape {tuple(states.obs.shape)}")


def profile_steps(label, step, n, card):
    """Device time by kernel and the device's idle share over n steps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    kern = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy_us = sum(k[0] for k in kern)
    print(f"profile of {n} {label} steps: wall {wall_us / n:.1f} us/step, "
          f"device busy {busy_us / n:.1f} us/step, idle share "
          f"{1 - busy_us / wall_us:.3f} ({card})")
    for us, count, name in kern[:8]:
        print(f"  {us / n:9.1f} us/step  x{count // n:<3d} {name[:90]}")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke run needs one NVIDIA GPU")
    from mujoco_playground_tpu_torch.envs import (DomainRandomizedEnv,
                                                  RandomizationConfig,
                                                  make_ackermann_env,
                                                  randomize_model)
    from mujoco_playground_tpu_torch.ops import build
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.ops import step as k1
    from mujoco_playground_tpu_torch.physics import engine
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

    # K1e's two variants at B_CHECK, 3 chained steps, on parameters with a
    # +-2 cm floor offset (a wrong plane_z would show in the lidar rows)
    dr_cfg = RandomizationConfig(floor_z_offset=(-0.02, 0.02))
    params = engine.dr_params(randomize_model(model, gen, B_CHECK, dr_cfg),
                              model, B_CHECK)
    for with_fresh in (True, False):
        label = f"e {'env+fresh' if with_fresh else 'env'} B={B_CHECK}"
        q, v = rows(st.physics.qpos), rows(st.physics.qvel)
        ws = rows(st.physics.qacc_warmstart)
        e_in = env_in if with_fresh else env_in[:5].contiguous()
        for step in range(CHECK_STEPS):
            ctrl = torch.rand((3, B_CHECK), generator=gen, device=dev) * 2 - 1
            args = (model, q, v, ctrl, ws, e_in, statics,
                    fresh if with_fresh else None, False)
            got = k1.step_fused(*args, dr_params=params)
            want = k1.step_plain(*args, dr_params=params)
            torch.cuda.synchronize()
            check_k1(f"{label} step {step}", got, want, model, failures)
            q, v, ws = want[0], want[1], want[4]

    # K3 at B_CHECK on the system the staged step assembles for compat-path
    # states next to walls, with a warm start
    cenv = make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, seed=SEED,
                              reference_flat_manifold=True,
                              reference_wheel_patch=True)
    # the system the staged step assembles (engine.newton_inputs), with a
    # warm start 1 m/s^2 (normal per dof) away from the smooth acceleration
    sys_args = engine.newton_inputs(cenv.model,
                                    wall_poses(cenv, B_CHECK, gen))
    sys_ws = (sys_args[1] + torch.randn(sys_args[1].shape, generator=gen,
                                        device=dev)).contiguous()
    active = sys_args[14].sum(0)
    print(f"K3 system B={B_CHECK}: {sys_args[8].shape[0]} contact rows, "
          f"{float(active.mean()):.2f} in contact per env (max "
          f"{int(active.max())})")
    check_k3(f"B={B_CHECK}", k3.newton_solve(*sys_args, warmstart=sys_ws),
             k3.newton_solve_plain(*sys_args, warmstart=sys_ws), failures)
    if failures:
        fail(f"kernels disagree with their plain twins: {failures}")

    # -- phase 3: the main path ---------------------------------------------
    act_gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def random_actions():
        return torch.rand((B_MAIN, 2), generator=act_gen, device=dev) * 2 - 1

    reset_counts()
    states = reset_states = env.reset(B_MAIN)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for i in range(STEPS):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0.record()
        states = env.step_autoreset_batch(states, random_actions())
    t1.record()
    torch.cuda.synchronize()
    launches = read_counts()
    step_ms = t0.elapsed_time(t1) / (STEPS - WARMUP)
    print(f"main path: B={B_MAIN}, {STEPS} steps, launches {launches}, "
          f"{step_ms:.4f} ms/env step, "
          f"{B_MAIN / step_ms * 1e3:.0f} env-steps/s ({card})")
    if launches["K1"] != STEPS:
        fail(f"K1 ran {launches['K1']} times in {STEPS} main-path steps")
    if launches["K2"] < 1:
        fail("K2 did not run at reset")
    if launches["K1e"] or launches["K3"]:
        fail(f"the main path launched K1e or K3: {launches}")
    check_finite("main path", states, env.obs_size, B_MAIN)
    print(f"main path outputs finite; obs {tuple(states.obs.shape)}, "
          f"{int(states.done.sum())} envs done on the last step")

    # where a main-path step's time goes: device time by kernel over a
    # short profiled window, and the device's idle share of the wall time
    def main_step():
        nonlocal states
        states = env.step_autoreset_batch(states, random_actions())

    profile_steps("main-path", main_step, PROFILE_STEPS, card)

    # -- phase 3b: path A, domain randomization through K1e ----------------
    # the default randomization (RandomizationConfig()); every env starts
    # from one shared reset sample and takes one shared action for
    # SAME_STEPS steps, so only the parameters spread their velocities;
    # then random actions
    dr_env = DomainRandomizedEnv(
        env, B_MAIN, torch.Generator(device=dev).manual_seed(SEED + 3),
        RandomizationConfig())
    core = expand_tree(env.reset_core(1), B_MAIN)
    same = random_actions()[:1].expand(B_MAIN, 2)
    reset_counts()
    dstates = dr_env.reset(core=core)
    ever_done = torch.zeros(B_MAIN, dtype=torch.bool, device=dev)
    for i in range(DR_STEPS):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0.record()
        dstates = dr_env.step_autoreset_batch(
            dstates, same if i < SAME_STEPS else random_actions())
        if i < SAME_STEPS:
            ever_done |= dstates.done
        if i == SAME_STEPS - 1:
            kept = dstates.physics.qvel[~ever_done]
            spread = float(kept.std(0).max())
    t1.record()
    torch.cuda.synchronize()
    launches_dr = read_counts()
    dr_ms = t0.elapsed_time(t1) / (DR_STEPS - WARMUP)
    print(f"path A (DomainRandomizedEnv): B={B_MAIN}, {DR_STEPS} steps, "
          f"launches {launches_dr}, {dr_ms:.4f} ms/env step, "
          f"{B_MAIN / dr_ms * 1e3:.0f} env-steps/s ({card})")
    print(f"path A: after {SAME_STEPS} steps from one shared start with "
          f"one shared action, max over dofs of the std of qvel across "
          f"{kept.shape[0]} envs: {spread:.4e}")
    if launches_dr["K1e"] != DR_STEPS:
        fail(f"K1e ran {launches_dr['K1e']} times in {DR_STEPS} path A steps")
    if launches_dr["K1"] or launches_dr["K3"]:
        fail(f"path A launched K1 or K3: {launches_dr}")
    if launches_dr["K2"] < 1:
        fail("K2 did not run at the path A reset")
    if not spread > 1e-4:
        fail("path A: identical starts and actions did not spread qvel; "
             "the randomized parameters did not reach K1e")
    check_finite("path A", dstates, env.obs_size, B_MAIN)

    # -- phase 3c: path B, the compat manifolds through the staged step ----
    reset_counts()
    cstates = cenv.reset(B_MAIN)
    for i in range(STAGED_STEPS):
        if i == STAGED_WARMUP:
            torch.cuda.synchronize()
            t0.record()
        cstates = cenv.step_autoreset_batch(cstates, random_actions())
    t1.record()
    torch.cuda.synchronize()
    launches_st = read_counts()
    st_ms = t0.elapsed_time(t1) / (STAGED_STEPS - STAGED_WARMUP)
    print(f"path B (compat manifolds, staged step): B={B_MAIN}, "
          f"{STAGED_STEPS} steps, launches {launches_st}, {st_ms:.4f} "
          f"ms/env step, {B_MAIN / st_ms * 1e3:.0f} env-steps/s ({card})")
    if launches_st["K3"] != STAGED_STEPS:
        fail(f"K3 ran {launches_st['K3']} times in {STAGED_STEPS} path B "
             f"steps")
    if launches_st["K1"] or launches_st["K1e"]:
        fail(f"path B launched K1 or K1e: {launches_st}")
    if launches_st["K2"] < STAGED_STEPS:
        fail(f"K2 ran {launches_st['K2']} times in {STAGED_STEPS} path B "
             f"steps")
    check_finite("path B", cstates, cenv.obs_size, B_MAIN)

    def staged_step():
        nonlocal cstates
        cstates = cenv.step_autoreset_batch(cstates, random_actions())

    profile_steps("path B", staged_step, STAGED_PROFILE, card)

    # -- phase 4: the kernels at the paths' shapes ---------------------------
    # K1 as the main path calls it (<with_env, with_fresh, !ws_compare>) on
    # the last main-path states, K2 on the reset frames it scanned, K1e on
    # the last path A states with its parameters, K3 on the system of the
    # last path B states; each held against its twin on the same inputs,
    # then timed
    ph = states.physics
    q, v, ws = rows(ph.qpos), rows(ph.qvel), rows(ph.qacc_warmstart)
    ctrl = torch.rand((3, B_MAIN), generator=gen, device=dev) * 2 - 1
    fresh_xy = env.reset_core(B_MAIN).physics.qpos[:, :2]
    env_in = torch.cat([states.odom_ref.position[:, :2], states.goal,
                        states.prev_goal_distance[:, None], fresh_xy],
                       -1).T.contiguous()
    args = (model, q, v, ctrl, ws, env_in, statics, fresh, False)
    xp, xq = rows(reset_states.physics.xpos), rows(reset_states.physics.xquat)
    got, want = k1.step_fused(*args), k1.step_plain(*args)
    # the twin in float64 on the same inputs: the conditioning behind the
    # tolerances
    exact = k1.step_plain(model, *(t.double() for t in args[1:6]),
                          *args[6:])
    k1_err = check_k1(f"main B={B_MAIN}", got, want, model, failures)
    k2_err = check_k2(f"B={B_MAIN}", k2.lidar(model, xp, xq),
                      k2.lidar_plain(model, xp, xq), failures)
    dph = dstates.physics
    dparams = engine.dr_params(dr_env.models, model, B_MAIN)
    d_env_in = torch.cat([dstates.odom_ref.position[:, :2], dstates.goal,
                          dstates.prev_goal_distance[:, None], fresh_xy],
                         -1).T.contiguous()
    dargs = (model, rows(dph.qpos), rows(dph.qvel), ctrl,
             rows(dph.qacc_warmstart), d_env_in, statics, fresh, False)
    k1e_err = check_k1(
        f"e main B={B_MAIN}", k1.step_fused(*dargs, dr_params=dparams),
        k1.step_plain(*dargs, dr_params=dparams), model, failures,
        k1e_witness(dargs, dparams, gen))
    cph = cstates.physics
    sys_args = engine.newton_inputs(cenv.model, cph)
    sys_ws = cph.qacc_warmstart.T.contiguous()
    active = sys_args[14].sum(0)
    k3_err = check_k3(f"B={B_MAIN}", k3.newton_solve(*sys_args,
                                                      warmstart=sys_ws),
                      k3.newton_solve_plain(*sys_args, warmstart=sys_ws),
                      failures, k3_witness(sys_args, sys_ws, gen))
    if failures:
        fail(f"kernels disagree with their plain twins: {failures}")
    # how far the kernel and the float32 twin are from the float64 twin
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
    k1e_ms = cuda_ms(lambda: k1.step_fused(*dargs, dr_params=dparams), 20)
    k1e_plain_ms = cuda_ms(lambda: k1.step_plain(*dargs, dr_params=dparams),
                           2)
    k3_ms = cuda_ms(lambda: k3.newton_solve(*sys_args, warmstart=sys_ws), 20)
    k3_plain_ms = cuda_ms(
        lambda: k3.newton_solve_plain(*sys_args, warmstart=sys_ws), 2)

    nbox = model.num_scene_boxes
    k1_bytes = (model.nq + 2 * model.nv + model.nu + 7 + model.nq
                + model.nv + model.nbody * 7 + model.nv
                + 2 * model.nsite + 12) * 4 * B_MAIN
    slot_active = k1.contact_activity(model, q).float().mean(1).tolist()
    k1_flop = k1_ops(model, slot_active)
    k1_bound, k1_by = bound_ms(k1_bytes, k1_flop * B_MAIN)
    k1e_bytes = k1_bytes + dparams.shape[0] * 4 * B_MAIN
    slot_active_e = k1.contact_activity(
        model, dargs[1], dparams).float().mean(1).tolist()
    k1e_flop = k1_ops(model, slot_active_e)
    k1e_bound, k1e_by = bound_ms(k1e_bytes, k1e_flop * B_MAIN)
    k2_bytes = (model.nbody * 7 + model.nsite) * 4 * B_MAIN
    k2_bound, k2_by = bound_ms(
        k2_bytes, model.nsite * (72 + 27 * nbox) * B_MAIN)
    na = float(active.float().mean())
    k3_env_bytes = k3_bytes(model.nv, sys_args[2].shape[0],
                            sys_args[8].shape[0], na)
    jg = (sys_args[2][:, :, 0] != 0).sum(1).tolist()
    k3_flop = k3_ops(model.nv, jg, na, cenv.model.solver_iterations,
                     cenv.model.ls_iterations, True)
    k3_bound, k3_by = bound_ms(k3_env_bytes * B_MAIN, k3_flop * B_MAIN)
    print(f"K1: {k1_ms:.4f} ms (plain {k1_plain_ms:.2f} ms, bound "
          f"{k1_bound:.5f} ms by {k1_by}: {k1_flop:.0f} operations per env"
          f" with {sum(slot_active):.2f} active contact rows per env); K2: "
          f"{k2_ms:.4f} ms (plain {k2_plain_ms:.2f} ms, bound "
          f"{k2_bound:.5f} ms by {k2_by}) at B={B_MAIN} ({card})")
    print(f"K1e: {k1e_ms:.4f} ms (plain {k1e_plain_ms:.2f} ms, bound "
          f"{k1e_bound:.5f} ms by {k1e_by}: {k1e_bytes / B_MAIN:.0f} B and "
          f"{k1e_flop:.0f} operations per env with {sum(slot_active_e):.2f}"
          f" active contact rows per env); K3: {k3_ms:.4f} ms (plain "
          f"{k3_plain_ms:.2f} ms, bound {k3_bound:.5f} ms by {k3_by}: "
          f"{k3_env_bytes:.0f} B and {k3_flop:.0f} operations per env "
          f"with {na:.2f} of "
          f"{sys_args[8].shape[0]} contact rows in contact) at B={B_MAIN} "
          f"({card})")

    def entry(name, source, replaces, n, err, ms, plain, bound, by):
        return {"name": name, "route": "cuda",
                "source": f"mujoco_playground_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bound,
                "bound_by": by, "library_ms": None}

    step_src = "mujoco_playground_tpu/ops/step_pallas.py:955"
    print(json.dumps({"kernels": [
        entry("K1 step (fused env + fresh scan)", "step_kernel.cu", step_src,
              launches["K1"], k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by),
        entry("K1e step with domain-randomized parameters",
              "step_kernel_dr.cu", step_src, launches_dr["K1e"], k1e_err,
              k1e_ms, k1e_plain_ms, k1e_bound, k1e_by),
        entry("K2 lidar", "lidar_kernel.cu",
              "mujoco_playground_tpu/ops/lidar_pallas.py:114", launches["K2"],
              k2_err, k2_ms, k2_plain_ms, k2_bound, k2_by),
        entry("K3 Newton solve (staged step)", "newton_kernel.cu",
              "mujoco_playground_tpu/ops/newton_pallas.py:366",
              launches_st["K3"], k3_err, k3_ms, k3_plain_ms, k3_bound,
              k3_by),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def expand_tree(tree, B):
    """A one-env dataclass tree of (1, ...) leaves repeated to B envs."""
    if isinstance(tree, torch.Tensor):
        return tree.expand((B,) + tree.shape[1:]).clone()
    return dataclasses.replace(tree, **{
        f.name: expand_tree(getattr(tree, f.name), B)
        for f in dataclasses.fields(tree)})


if __name__ == "__main__":
    main()
