"""Kernel K1 (K1e) against its twins on the paths' states, step by step,
and on the envs where it once missed them.

    python3 scripts/torch_k1_probe.py [--paths main,A,R,RD,wall] [--B N]
        [--steps 200] [--every 10] [--seed 1 [2 ...]] [--wall-steps 6]
        [--host] [--tree DIR] [--detail 8] [--save PATH]
    python3 scripts/torch_k1_probe.py --load PATH [--host] [--tree DIR]

Stepping (one CUDA card, or the host build with ``--host``): for each
``--seed`` of the actions, at ``--B`` envs (16384, the paths' width, on the
card; 8192 with ``--host``):

* ``main``: ``chip_smoke.py``'s main path (the umaze env, solver 4/3,
  ``step_autoreset_batch``), K1 ``<1,1,0>`` held on the states of every
  ``--every``-th step from step 0 to ``--steps``, as ``chip_smoke.py``'s
  phase 4 holds it on the last one (fresh ctrl, env rows, spawn scan);
* ``A``: path A (the default randomization, ``DomainRandomizedEnv``), K1e
  ``<1,1,0,dr>`` so;
* ``R``: path R (delayed obs and lidar aliasing), K1 ``<0,0,0>`` so;
* ``RD``: path R under the default randomization, K1e ``<0,0,0,dr>`` so;
* ``wall``: ``wall_poses`` states (seeded by the seed), ``--wall-steps``
  chained steps through each flag set's variant, the twin's outputs
  chained (with ``--host``: ``<0,0,0>`` only, the sweep behind
  ``tests/data/k1_wall_misses.npz``).

Each check holds the kernel against the float32 twin with ``K1_TOL``
(``outputs_ratio``), counts the envs whose physics outputs differ from
the twin's in any bit, and for each env over the tolerance (at most
``--detail`` a check in full) prints the kernel's and the float32 twin's
distances, in units of the tolerance, to the float64 twin and to the
float64-solve twin (the float32 twin with its own system solved in
float64 and rounded), the one-ulp witness of ``chip_smoke.py``'s
``set_aside`` (how far each twin moves under one-ulp input moves), the
env's kind (``kernel_alone``: the two twins agree and the kernel is off;
``twin_off``: the kernel sits on the float64 twin and the float32 twin is
off; ``all_differ``), and where the kernel leaves the twin: the least
Newton iteration count at which the two part (1: in the system the solve
is given, its contact activity, geometry or rows; k > 1: in the solve's
k-th iteration), with the contact slots whose activity the float32 and
float64 twins see differently.  At the end, per path: the checks, the env
steps, the envs over the tolerance by kind, and the envs not bitwise.

``--host`` runs ``step_kernel.cu``/``step_kernel_dr.cu`` built as host C++
(g++ without contractions, as ``tests/test_torch_kernel_source.py`` builds
them) on CPU tensors, the whole sweep on the CPU (default paths:
``wall``).  ``--tree DIR`` takes the package, its kernels, its twin and
``chip_smoke.py`` from another checkout, such as the parent commit
unpacked by ``git archive`` under ``build/``.  ``--save PATH`` writes the
inputs of every env over the tolerance (flag set, qpos, qvel, ctrl, warm
start, env rows, K1e parameters) with its path, seed, step, id, kind and
distances to an npz file that ``chip_smoke.load_k1_misses`` reads;
``--load PATH`` holds such envs again, with the same diagnosis.
"""
import argparse
import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _tree_from_argv():
    if "--tree" in sys.argv:
        return Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
    return ROOT


# the package, its twin and chip_smoke.py of --tree (this checkout's by
# default) take the imports
sys.path.insert(0, str(_tree_from_argv()))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mujoco_playground_tpu_torch.ops import step as k1  # noqa: E402

PATHS = ("main", "A", "R", "RD", "wall")
KINDS = ("kernel_alone", "twin_off", "all_differ")
NPHYS = 5   # qpos, qvel, xpos, xquat, qacc: the outputs that must be bitwise


def host_libs(work):
    """The tree's K1 and K1e sources built as host C++ (g++, no
    contractions)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise SystemExit("no host C++ compiler")
    from mujoco_playground_tpu_torch.ops import build
    libs = {}
    for src in ("step_kernel.cu", "step_kernel_dr.cu"):
        so = Path(work) / (src + ".so")
        subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                        "-ffp-contract=off", "-x", "c++",
                        str(build.CSRC / src), "-o", str(so)], check=True,
                       capture_output=True, timeout=300)
        libs[src] = ctypes.CDLL(str(so))
    return libs


def kernel_runner(host, work):
    """run(args, dr) -> the kernel's outputs on step_plain's args."""
    if host:
        libs = host_libs(work)

        def run(args, dr):
            src = "step_kernel.cu" if dr is None else "step_kernel_dr.cu"
            return k1.launch_k1(libs[src], *args, None, dr)
        return run

    def run(args, dr):
        return k1.step_fused(*args, dr_params=dr)
    return run


def sub(args, ids):
    return tuple(a[:, ids].contiguous() if isinstance(a, torch.Tensor)
                 else a for a in args)


def ratio(got, want, model):
    return cs.outputs_ratio(cs.k1_views(got, model),
                            cs.k1_views(want, model), cs.K1_TOLS)


def f64(args):
    return (args[0],) + tuple(t.double() if isinstance(t, torch.Tensor)
                              else t for t in args[1:6]) + args[6:]


def solve_in_f64(model, args, dr):
    """The float32 twin with the system it assembles solved in float64
    and the solution rounded to float32."""
    body = k1.newton_body

    def wide(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        if isinstance(x, list):
            return [wide(v) for v in x]
        if isinstance(x, dict):
            return {k: wide(v) for k, v in x.items()}
        return x

    def in_f64(nv, its, ls, M, a_s, jrows, cgroups, **kw):
        kw = dict(kw, a0=wide(kw.get("a0")))
        out = body(nv, its, ls, wide(M), wide(a_s), wide(jrows),
                   wide(cgroups), **kw)
        return [v.float() if isinstance(v, torch.Tensor) else v for v in out]
    k1.newton_body = in_f64
    try:
        return k1.step_plain(*args, dr_params=dr)
    finally:
        k1.newton_body = body


def parting_iteration(model, run, args, dr):
    """The least Newton iteration count at which the kernel and the float32
    twin part on one env (None: they do not at any count)."""
    for it in range(1, model.solver_iterations + 1):
        m = dataclasses.replace(model, solver_iterations=it)
        a = (m,) + tuple(args[1:])
        if float(ratio(run(a, dr), k1.step_plain(*a, dr_params=dr),
                       model)[0]) > 1:
            return it
    return None


def activity_flips(model, q, dr):
    """Contact slots whose activity (dist < 0) the float32 and the float64
    twin see differently on one env."""
    a32 = k1.contact_activity(model, q, dr)
    a64 = k1.contact_activity(model, q.double(),
                              None if dr is None else dr.double())
    return torch.nonzero((a32 != a64)[:, 0]).flatten().tolist()


def diagnose(model, run, args, dr, i, gen, got, want):
    """One env over the tolerance: its distances, witness, kind and the
    place where the kernel leaves the twin.  Returns (kind, kernel to the
    float32 twin, float32 twin to the float64 twin, kernel to the float64
    twin)."""
    one = sub(args, [i])
    d1 = None if dr is None else dr[:, [i]].contiguous()
    g = [t[:, [i]] for t in got]
    w = [t[:, [i]] for t in want]
    t64 = [t.float() for t in k1.step_plain(*f64(one), dr_params=(
        None if d1 is None else d1.double()))]
    s64 = solve_in_f64(model, one, d1)

    def rr(a, b):
        return float(ratio(a, b, model)[0])
    k32, t32_64, k64 = rr(g, w), rr(w, t64), rr(g, t64)
    kind = ("kernel_alone" if t32_64 <= 1 else
            "twin_off" if k64 <= 1 else "all_differ")
    moved64, moved32, near, _, _ = cs.k1_witness(one, gen, d1)(
        torch.tensor([0], device=one[1].device),
        [cs.k1_views(g, model)[j] for j in range(len(g))])
    part = parting_iteration(model, run, one, d1)
    where = ("never (at 1..N iterations)" if part is None else
             "before the solve (the system)" if part == 1 else
             f"in the solve's iteration {part}")
    print(f"  env {i}: {kind}; the kernel {k32:.3g}x from the float32 twin, "
          f"{k64:.3g}x from the float64 twin, {rr(g, s64):.3g}x from the "
          f"float64-solve twin; the float32 twin {t32_64:.3g}x from the "
          f"float64 twin, {rr(w, s64):.3g}x from the float64-solve twin; "
          f"one-ulp witness: float64 twin moves {float(moved64[0]):.3g}x, "
          f"float32 twin {float(moved32[0]):.3g}x, kernel "
          f"{float(near[0]):.3g}x from the nearest twin run; kernel and "
          f"twin part {where}; slots whose activity the float32 and "
          f"float64 twins see differently: "
          f"{activity_flips(model, one[1], d1)}", flush=True)
    return kind, k32, t32_64, k64


class Tally:
    def __init__(self):
        self.rows = {}

    def add(self, path, n, over, kinds, not_bitwise):
        r = self.rows.setdefault(path, dict(checks=0, env_steps=0, over=0,
                                            not_bitwise=0,
                                            **{k: 0 for k in KINDS}))
        r["checks"] += 1
        r["env_steps"] += n
        r["over"] += over
        r["not_bitwise"] += not_bitwise
        for k in kinds:
            r[k] += 1

    def report(self, where):
        for path, r in self.rows.items():
            print(f"path {path}: {r['checks']} checks, {r['env_steps']} env "
                  f"steps, {r['over']} envs over the tolerance ("
                  + ", ".join(f"{k} {r[k]}" for k in KINDS)
                  + f"), {r['not_bitwise']} envs not bitwise ({where})")


class Prober:
    def __init__(self, opt, run, gen):
        self.opt, self.run, self.gen = opt, run, gen
        self.tally = Tally()
        self.found = []

    def check(self, path, label, args, dr, meta):
        model = args[0]
        got = self.run(args, dr)
        want = k1.step_plain(*args, dr_params=dr)
        r = ratio(got, want, model)
        over = torch.nonzero(r > 1).flatten().tolist()
        nb = int(torch.stack([(g != w).any(0) for g, w in
                              zip(got[:NPHYS], want[:NPHYS])]).any(0).sum())
        print(f"{label}: worst {float(r.max()):.4g}x the tolerance; envs "
              f"over {over}; {nb} of {r.shape[0]} envs not bitwise",
              flush=True)
        kinds = []
        for i in over[:self.opt.detail]:
            kind, k32, t32_64, k64 = diagnose(model, self.run, args, dr, i,
                                              self.gen, got, want)
            kinds.append(kind)
            self.found.append(dict(meta, env=i, kind=kind, ratio=k32,
                                   twin64=t32_64, kernel64=k64,
                                   args=sub(args, [i]),
                                   dr=None if dr is None
                                   else dr[:, [i]].contiguous()))
        self.tally.add(path, r.shape[0], len(over), kinds, nb)
        return want


def rows(x):
    return x.reshape(x.shape[0], -1).T.contiguous()


def step_args(env, st, ctrl, fresh_xy, with_env, with_fresh):
    """step_plain's arguments for the flag set on states st."""
    ph = st.physics
    env_in = statics = fresh = None
    if with_env:
        cols = [st.odom_ref.position[:, :2], st.goal,
                st.prev_goal_distance[:, None]]
        if with_fresh:
            cols.append(fresh_xy)
            fresh = env._fresh_statics()
        env_in = torch.cat(cols, -1).T.contiguous()
        statics = env._env_statics()
    return (env.model, rows(ph.qpos), rows(ph.qvel), ctrl,
            rows(ph.qacc_warmstart), env_in, statics, fresh, False)


def run_paths(opt, prober, dev):
    from mujoco_playground_tpu_torch.envs import (DomainRandomizedEnv,
                                                  RandomizationConfig,
                                                  make_ackermann_env)
    from mujoco_playground_tpu_torch.envs.poses import wall_poses
    from mujoco_playground_tpu_torch.physics import engine
    solver = dict(solver_iterations=4, ls_iterations=3, seed=cs.SEED,
                  device=dev)
    env = make_ackermann_env("maze", "umaze", **solver)
    B = opt.B
    for seed in opt.seed:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def ctrl():
            return torch.rand((3, B), generator=gen, device=dev) * 2 - 1

        def actions():
            return torch.rand((B, 2), generator=gen, device=dev) * 2 - 1
        fresh_xy = env.reset_core(B).physics.qpos[:, :2]
        for path in opt.paths:
            if path == "wall":
                continue
            if path in ("R", "RD"):
                base = make_ackermann_env(
                    "maze", "umaze", reference_delayed_obs=True,
                    reference_lidar_aliasing=True, **solver)
            else:
                base = env
            dr_env = (DomainRandomizedEnv(
                base, B, torch.Generator(device=dev).manual_seed(seed + 100),
                RandomizationConfig()) if path in ("A", "RD") else None)
            stepper = dr_env or base
            st = dr_env.reset() if dr_env else base.reset(B)
            full = path in ("main", "A")
            for step in range(opt.steps + 1):
                if step % opt.every == 0:
                    args = step_args(base, st, ctrl(), fresh_xy, full, full)
                    dr = (engine.dr_params(dr_env.models, base.model, B)
                          if dr_env else None)
                    prober.check(path, f"{path} seed {seed} step {step}",
                                 args, dr, dict(path=path, seed=seed,
                                                step=step))
                if step < opt.steps:
                    st = stepper.step_autoreset_batch(st, actions())
            del st, dr_env, stepper
        if "wall" in opt.paths:
            wgen = torch.Generator(device=dev).manual_seed(seed)
            ph = wall_poses(env, B, wgen)
            st = env.reset(B)
            e_in = torch.cat([st.odom_ref.position[:, :2], st.goal,
                              st.prev_goal_distance[:, None],
                              ph.qpos[:, :2]], -1).T.contiguous()
            params = None
            if not opt.host:
                from mujoco_playground_tpu_torch.envs import randomize_model
                params = engine.dr_params(randomize_model(
                    env.model, wgen, B, RandomizationConfig()), env.model, B)
            keys = ([cs.PLAIN] if opt.host else list(k1.K1_VARIANTS))
            for key in keys:
                with_env, with_fresh, wsc, dr_on = key
                q, v, ws = rows(ph.qpos), rows(ph.qvel), rows(
                    ph.qacc_warmstart)
                for step in range(opt.wall_steps):
                    c = torch.rand((3, B), generator=wgen, device=dev) * 2 - 1
                    args = (env.model, q, v, c, ws,
                            (e_in if with_fresh else e_in[:5].contiguous())
                            if with_env else None,
                            env._env_statics() if with_env else None,
                            env._fresh_statics() if with_fresh else None, wsc)
                    want = prober.check(
                        "wall", f"wall {key} seed {seed} step {step}", args,
                        params if dr_on else None,
                        dict(path="wall", seed=seed, step=step))
                    q, v, ws = want[0], want[1], want[4]


def save_misses(path, found):
    """The captured envs' K1 inputs, envs last, in one npz file."""
    n = len(found)
    m = found[0]["args"][0]
    dr_rows = k1.dr_param_rows(k1.static_model(m), k1.DR_SUPPORTED)[1]
    out = dict(qpos=np.zeros((m.nq, n), np.float32),
               qvel=np.zeros((m.nv, n), np.float32),
               ctrl=np.zeros((m.nu, n), np.float32),
               warmstart=np.zeros((m.nv, n), np.float32),
               env_in=np.zeros((7, n), np.float32),
               dr=np.zeros((dr_rows, n), np.float32),
               variant=np.zeros((n, 4), np.int8))
    for j, f in enumerate(found):
        a = f["args"]
        for name, t in zip(("qpos", "qvel", "ctrl", "warmstart"), a[1:5]):
            out[name][:, j] = t[:, 0].cpu().numpy()
        if a[5] is not None:
            out["env_in"][:a[5].shape[0], j] = a[5][:, 0].cpu().numpy()
        if f["dr"] is not None:
            out["dr"][:, j] = f["dr"][:, 0].cpu().numpy()
        out["variant"][j] = [a[6] is not None, a[7] is not None, a[8],
                             f["dr"] is not None]
    for key in ("path", "kind"):
        out[key] = np.array([f[key] for f in found])
    for key in ("seed", "step", "env"):
        out[key] = np.array([f[key] for f in found], np.int64)
    for key in ("ratio", "twin64", "kernel64"):
        out[key] = np.array([f[key] for f in found], np.float64)
    out["where"] = np.array([f["where"] for f in found])
    np.savez_compressed(path, **out)
    print(f"saved {n} envs to {path} ({os.path.getsize(path)} B)")


def load_mode(opt, prober, dev):
    """Holds the saved envs (this checkout's loader, any tree's kernel)."""
    import importlib.util
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, seed=cs.SEED, device=dev)
    z = here.load_k1_misses(opt.load, dev)
    for key, args, dr, idx in here.k1_miss_groups(env, z):
        label = (f"saved envs {key}: " + ", ".join(
            f"{z['path'][j]} seed {z['seed'][j]} step {z['step'][j]} env "
            f"{z['env'][j]} ({z['kind'][j]})" for j in idx))
        prober.check("saved", label, args, dr, {})


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--paths", default=None)
    p.add_argument("--B", type=int, default=None)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--seed", type=int, nargs="+", default=[1, 2])
    p.add_argument("--wall-steps", type=int, default=6)
    p.add_argument("--host", action="store_true")
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--detail", type=int, default=8)
    p.add_argument("--save", default=None)
    p.add_argument("--load", default=None)
    opt = p.parse_args()
    opt.paths = (opt.paths or ("wall" if opt.host else ",".join(PATHS))
                 ).split(",")
    for path in opt.paths:
        if path not in PATHS:
            raise SystemExit(f"unknown path {path}: {PATHS}")
    opt.B = opt.B or (8192 if opt.host else 16384)
    torch.backends.cuda.matmul.allow_tf32 = False
    if not opt.host and not torch.cuda.is_available():
        raise SystemExit("torch_k1_probe: needs a CUDA card (or --host)")
    dev = torch.device("cpu" if opt.host else "cuda")
    where = "host build" if opt.host else cs.gpu_name_and_limit()
    print(f"tree {opt.tree}; {where}")
    with tempfile.TemporaryDirectory() as work:
        prober = Prober(opt, kernel_runner(opt.host, work),
                        torch.Generator(device=dev).manual_seed(cs.SEED + 4))
        if opt.load:
            load_mode(opt, prober, dev)
        else:
            run_paths(opt, prober, dev)
    prober.tally.report(where)
    if opt.save and prober.found:
        for f in prober.found:
            f["where"] = where
        save_misses(opt.save, prober.found)


if __name__ == "__main__":
    main()
