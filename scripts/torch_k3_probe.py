"""K3 against its twins on path B's states, step by step, and on the envs
where it misses them.

    python3 scripts/torch_k3_probe.py [--steps 200] [--every 10] [--from 60]
        [--seed 3 [4 ...]] [--variants base,...] [--host] [--time]
        [--save PATH] [--iterations N]
    python3 scripts/torch_k3_probe.py --load PATH [--iterations N]
        [--variants base,...] [--host] [--tree DIR] [--device cpu]

Stepping: for each ``--seed`` of the actions, steps ``chip_smoke.py``'s
path B (the umaze env with the compat manifolds at 16384 envs, solver 4/3,
seeded uniform actions) and, every ``--every`` steps from ``--from`` on,
holds K3 on the step's Newton inputs against its float32 twin as
``chip_smoke.py`` does: its tolerance, and its ``set_aside`` rule for the
envs over it (the twins moved by one-ulp input nudges, or the float32
twin off the float64 twin with the kernel on it; at most ``MAX_FLIPS``).
Each of ``--variants`` of ``newton_kernel.cu`` (``VARIANTS``; ``base`` is
this checkout's build) is held so; at the end each variant's count of
envs over the tolerance, set aside and not admitted.  For each env over it
with ``base`` (at most 4 a step in detail) it prints the env's rows in
contact, whether the kernel gives the same bits for the env alone and in
its block of 8 (a test for cross-env interference), and the kernel's and
the float32 twin's distances, in units of the tolerance, to the float64
twin and to a float64 twin run to convergence (40 Newton and 20
line-search iterations), with the three qacc vectors.  ``--save PATH``
writes the K3 inputs of every env over the tolerance with ``base`` (each
``newton_solve`` argument and the warm start, sliced to the env,
batch-last) with its seed, step and env id to an npz file, which
``chip_smoke.load_k3_misses`` reads.  ``--iterations N`` also runs the
kernel and the twins on each such env at 0..N Newton iterations (K3 takes
the count at run time): iteration 0 is the start, where each picks the warm
start or the smooth acceleration (MuJoCo's mj_warmstart), and the script
prints which, with the two costs the pick compares (in float64).
``--host`` also runs ``newton_kernel.cu`` built as host C++ (g++, as
``tests/test_torch_kernel_source.py`` builds it) on the CPU on every
check's inputs and counts, per variant, the envs whose qacc differs from
the host build's in any bit.  ``--time`` times the variants on the last
check's inputs in the order given and back (A B B A for two): ``ms`` by
CUDA events around each call, ``device_ms`` from one replay of a CUDA
graph of 20 calls, one JSON line each.

``--load PATH`` holds the saved envs instead, through each variant at
0..N iterations, against the float32 and float64 twins (with ``--host``
whether each variant has the host build's bits).  With ``--device cpu``
each variant's source is built as host C++ (its nvcc flags do not apply:
the host build has no contractions and its ``rsqrtf`` is ``1 / sqrtf``)
and the twins run on the CPU.  On the card each variant is a copy of
``csrc/`` under ``build/k3_variants/<name>/`` built by nvcc with its
flags, all at once.  ``--tree DIR`` takes the variants' source and flags
from another checkout (``base``: its own; this checkout's by default),
such as an earlier commit unpacked by ``git archive`` under ``build/``
(PERF.md's diagnosis of the float32 kernel was made so).  Stepping needs
one CUDA card (or ``--device cpu``, at a small ``chip_smoke.B_MAIN``,
slowly).
"""
import argparse
import concurrent.futures
import ctypes
import functools
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TOL = [cs.K3_TOL + (True,)]
PIVOT = "rsqrtf(fmaxf(ajj, 1e-30f))"
IEEE_PIVOT = "1.0f / sqrtf(fmaxf(ajj, 1e-30f))"
# name -> (change of newton_kernel.cu's nvcc flags: "keep", "+" no
# contractions (-fmad=false), "-" contractions allowed; source edits (old,
# new)), each relative to --tree's source and flags (the pivot edits apply
# to the float32 kernel before this checkout's, as git archive unpacks it)
VARIANTS = {
    "base": ("keep", ()),
    "fmad_off": ("+", ()),
    "fmad_on": ("-", ()),
    "ieee_pivot": ("keep", ((PIVOT, IEEE_PIVOT),)),
    "fmad_off_ieee_pivot": ("+", ((PIVOT, IEEE_PIVOT),)),
}


def sub(args, ids):
    return tuple(a[..., ids].contiguous() if isinstance(a, torch.Tensor)
                 else a for a in args)


def on(args, device):
    return [a.to(device) if isinstance(a, torch.Tensor) else a
            for a in args]


def at_iterations(args, n):
    args = list(args)
    args[15] = n
    return args


def ratio(a, b):
    return cs.outputs_ratio([a], [b], TOL)


def pick_costs(args, ws):
    """The two costs MuJoCo's warm-start pick compares, per env, in
    float64: the primal cost at the warm start (with the smooth quadratic)
    and at the smooth acceleration (where that term is zero)."""
    from mujoco_playground_tpu_torch.physics.constraint import EQ, FRICTION
    (M, a_s, G, j_aref, j_R, j_floss, j_active, j_kind, Jn, Jt1, Jt2,
     c_aref, c_R, c_mu, c_active) = cs.as_f64(args)[:15]

    def cost(vec):
        x = torch.einsum("rvb,vb->rb", G, vec) - j_aref
        rinv = 1.0 / j_R
        quad = 0.5 * x * x * rinv
        c = torch.zeros_like(vec[0])
        for r, k in enumerate(j_kind):
            if int(k) == EQ:
                rc = quad[r]
            elif int(k) == FRICTION:
                lin = (j_floss[r] * x[r].abs()
                       - 0.5 * j_floss[r] ** 2 / rinv[r])
                rc = torch.where(x[r].abs() * rinv[r] < j_floss[r], quad[r],
                                 lin)
            else:
                rc = torch.where(x[r] < 0, quad[r], torch.zeros_like(x[r]))
            c = c + rc * j_active[r]
        an, t1, t2 = (torch.einsum("cvb,vb->cb", J, vec)
                      for J in (Jn, Jt1, Jt2))
        for k, p in enumerate((an + c_mu * t1, an - c_mu * t1,
                               an + c_mu * t2, an - c_mu * t2)):
            xk = p - c_aref[:, k]
            c = c + (torch.where(xk < 0, 0.5 * xk * xk / c_R,
                                 torch.zeros_like(xk)) * c_active).sum(0)
        return c

    d = ws.double() - a_s
    smooth = 0.5 * (d * torch.einsum("vwb,wb->vb", M, d)).sum(0)
    return cost(ws.double()) + smooth, cost(a_s)


def start_of(q, args, ws):
    """Which start an iteration-0 solve returned, per env."""
    a_s = args[1].to(q.dtype)
    return ["warm start" if torch.equal(q[:, i], ws[:, i].to(q.dtype))
            else ("a_s" if torch.equal(q[:, i], a_s[:, i]) else "neither")
            for i in range(q.shape[1])]


def _plain(args, ws):
    from mujoco_playground_tpu_torch.ops import newton as k3
    return k3.newton_solve_plain(*args, warmstart=ws)


def sweep(args, ws, n, kernels, host=None):
    """The kernel builds (name -> run(args, ws)) and the float32 and
    float64 twins at 0..n iterations on envs ``args``: per env and
    iteration, each build's distance to the float32 and the float64 twin
    and the float32 twin's to the float64 one, in units of the tolerance;
    with ``host`` (a run on CPU tensors), whether each build's qacc has the
    host build's bits."""
    rows = []
    for it in range(n + 1):
        a = at_iterations(args, it)
        outs = {name: run(a, ws) for name, run in kernels.items()}
        hq = None if host is None else host(on(a, "cpu"), ws.cpu())
        rows.append((it, _plain(a, ws), _plain(cs.as_f64(a), ws.double()),
                     outs, hq))
    c0, c1 = pick_costs(args, ws)
    for e in range(args[1].shape[1]):
        _, t32, t64, outs, _ = rows[0]
        picks = {name: start_of(q, args, ws)[e] for name, q in outs.items()}
        print(f"  env {e}: the pick at iteration 0: "
              f"{', '.join(f'{k} {v}' for k, v in picks.items())}, twin32 "
              f"{start_of(t32, args, ws)[e]}, twin64 "
              f"{start_of(t64, args, ws)[e]}; cost(warm start) - cost(a_s) "
              f"{float(c0[e] - c1[e]):.6g} of {float(c1[e]):.6g} (float64)")
        head = "".join(f" {k:>18s}/32 {k:>18s}/64" for k in outs)
        print(f"    it{head}  twin32/64" + ("  bits of the host build"
                                          if host else ""))
        for it, t32, t64, outs, hq in rows:
            cells = "".join(
                f" {float(ratio(q[:, [e]], t32[:, [e]])[0]):21.3f}"
                f" {float(ratio(q[:, [e]], t64[:, [e]])[0]):21.3f}"
                for q in outs.values())
            same = "" if hq is None else "  " + " ".join(
                f"{k}={torch.equal(q[:, e].cpu(), hq[:, e])}"
                for k, q in outs.items())
            print(f"    {it:2d}{cells} "
                  f"{float(ratio(t32[:, [e]], t64[:, [e]])[0]):10.3f}{same}")


def _launcher(lib):
    from mujoco_playground_tpu_torch.ops import newton as k3

    def run(args, ws):
        dev = args[1].device
        stream = (torch.cuda.current_stream(dev).cuda_stream
                  if dev.type == "cuda" else None)
        return k3.launch_k3(lib, *args, ws, stream)
    return run


def save_misses(path, found):
    """found: [(seed, step, env, args, ws)] -> one npz, envs batch-last."""
    out = {"seed": np.array([f[0] for f in found], np.int64),
           "step": np.array([f[1] for f in found], np.int64),
           "env": np.array([f[2] for f in found], np.int64)}
    for i, name in enumerate(cs.K3_ARG_NAMES):
        vals = [f[3][i] for f in found]
        if isinstance(vals[0], torch.Tensor):
            out[name] = torch.cat(vals, -1).cpu().numpy()
        else:
            out[name] = np.asarray(vals[0])
    out["warmstart"] = torch.cat([f[4] for f in found], -1).cpu().numpy()
    np.savez_compressed(path, **out)
    print(f"saved {len(found)} envs to {path} "
          f"({os.path.getsize(path)} B)")


def _flags(base, change):
    rest = tuple(f for f in base if not f.startswith("-fmad"))
    return {"keep": base, "+": rest + ("-fmad=false",), "-": rest}[change]


def _package(tree):
    return Path(tree).resolve() / "mujoco_playground_tpu_torch"


def _variant_source(tree, edits):
    text = (_package(tree) / "csrc" / "newton_kernel.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant edit not applicable: {old!r} is not "
                             f"in {tree}'s newton_kernel.cu")
        text = text.replace(old, new)
    return text


def _load_build(path, name):
    spec = importlib.util.spec_from_file_location(
        f"k3_variant_build_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_variants(names, tree):
    """Each variant's run on the card: a copy of ``tree``'s csrc/ and
    ops/build.py under build/k3_variants/<tree>-<name>/ with its source
    edits and newton_kernel.cu's flags changed (base of this checkout: its
    own build), all built by nvcc in parallel."""
    from mujoco_playground_tpu_torch.ops import build
    own = _package(tree) == _package(ROOT)
    tree_build = (build if own else
                  _load_build(_package(tree) / "ops" / "build.py", "tree"))
    base = tree_build.SOURCE_FLAGS.get("newton_kernel.cu", ())
    mods = {}
    for name in names:
        if name == "base" and own:
            mods[name] = build
            continue
        change, edits = VARIANTS[name]
        pkg = (ROOT / "build" / "k3_variants" / f"{Path(tree).name}-{name}" /
               "mujoco_playground_tpu_torch")
        shutil.copytree(_package(tree) / "csrc", pkg / "csrc",
                        dirs_exist_ok=True)
        (pkg / "csrc" / "newton_kernel.cu").write_text(
            _variant_source(tree, edits))
        (pkg / "ops").mkdir(parents=True, exist_ok=True)
        shutil.copy(_package(tree) / "ops" / "build.py",
                    pkg / "ops" / "build.py")
        mod = _load_build(pkg / "ops" / "build.py", name)
        mod.SOURCE_FLAGS = dict(mod.SOURCE_FLAGS)
        mod.SOURCE_FLAGS["newton_kernel.cu"] = _flags(base, change)
        mods[name] = mod
    mods = {name: mods[name] for name in names}
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        logs = dict(zip(mods, pool.map(
            lambda m: m.build(("newton_kernel.cu",)), mods.values())))
    for name, mod in mods.items():
        print(f"variant {name}: nvcc flags "
              f"{mod.SOURCE_FLAGS.get('newton_kernel.cu', ())}; "
              f"{'; '.join(cs.ptxas_report(logs[name]))}")
    return {name: _launcher(mod.load("newton_kernel.cu"))
            for name, mod in mods.items()}


def host_library(tree, text, work, name):
    """``tree``'s newton_kernel.cu with source ``text`` built as host C++
    by g++ (no contractions), run on CPU tensors."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise SystemExit("no host C++ compiler")
    csrc = Path(work) / name
    shutil.copytree(_package(tree) / "csrc", csrc)
    src, so = csrc / "newton_kernel.cu", csrc / "newton_kernel.so"
    src.write_text(text)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-x", "c++", str(src), "-o",
                    str(so)], check=True, capture_output=True, timeout=300)
    return _launcher(ctypes.CDLL(str(so)))


def host_variants(names, tree, work):
    """Each variant with a distinct source, built as host C++."""
    runs, seen = {}, {}
    for name in names:
        text = _variant_source(tree, VARIANTS[name][1])
        if text in seen:
            print(f"variant {name}: the host build of {seen[text]}'s source")
            continue
        seen[text] = name
        runs[name] = host_library(tree, text, work, name)
    return runs


def kernels_and_host(opt, names, dev, work):
    """The variants' runs (on the card, or host builds with --device cpu)
    and, with --host, the host build of the tree's source."""
    kernels = (card_variants(names, opt.tree) if dev.type == "cuda"
               else host_variants(names, opt.tree, work))
    host = (host_library(opt.tree, _variant_source(opt.tree, ()), work,
                         "host") if opt.host else None)
    return kernels, host


def check_names(names):
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name}: {sorted(VARIANTS)}")
    return names


def load_mode(opt, work):
    dev = torch.device(opt.device)
    args, ws, ids = cs.load_k3_misses(opt.load, dev)
    names = check_names(opt.variants.split(","))
    kernels, host = kernels_and_host(opt, names, dev, work)
    active = args[14].sum(0)
    for e, (seed, step, env) in enumerate(ids):
        print(f"saved env {e}: seed {seed}, step {step}, env {env}, "
              f"{int(active[e])} rows in contact")
    sweep(args, ws, opt.iterations, kernels, host)
    where = cs.gpu_name_and_limit() if dev.type == "cuda" else "host build"
    print(f"({where})")


def detail(k3, args, ws, got, want, i, active, opt, kernels):
    """One env over the tolerance with the checkout's kernel."""
    one, wi = sub(args, [i]), ws[:, [i]].contiguous()
    alone = kernels["base"](one, wi)
    B = ws.shape[1]
    blk = list(range(i // 8 * 8, min(i // 8 * 8 + 8, B)))
    inblk = kernels["base"](sub(args, blk), ws[:, blk].contiguous())
    x64 = k3.newton_solve_plain(*cs.as_f64(one), warmstart=wi.double())
    more = cs.as_f64(one)
    more[15], more[16] = 40, 20
    conv = k3.newton_solve_plain(*more, warmstart=wi.double())
    g, w = got[:, [i]], want[:, [i]]

    def rr(a, b):
        return float(ratio(a, b)[0])

    print(f"  env {i}: rows in contact {int(active[i])}; kernel alone "
          f"bitwise as in the batch: {torch.equal(alone, g)}, in its block "
          f"of 8: {torch.equal(inblk[:, i % 8:i % 8 + 1], g)}; kernel to the "
          f"float32 twin {rr(g, w):.2f}, to the float64 twin "
          f"{rr(g, x64):.2f}, to the converged one {rr(g, conv):.2f}; "
          f"float32 twin to the float64 twin {rr(w, x64):.2f}, to the "
          f"converged one {rr(w, conv):.2f}", flush=True)
    for name, q in (("kernel", g), ("twin32", w), ("twin64", x64)):
        print(f"    {name} {q.flatten().tolist()}")
    if opt.iterations is not None:
        sweep(one, wi, opt.iterations, {"base": kernels["base"]})


def time_variants(kernels, args, ws, where):
    """Each variant on the last check's inputs, in the order given and
    back (A B B A for two): ms by CUDA events around each call (the host
    path included) and device_ms from one replay of a CUDA graph of 20
    calls (the kernel alone), as chip_smoke.py times K3."""
    order = list(kernels) + list(reversed(kernels))
    for name in order:
        call = functools.partial(kernels[name], args, ws)
        print(json.dumps({"variant": name, "B": ws.shape[1],
                          "ms": cs.cuda_ms(call, 20),
                          "device_ms": cs.graph_ms(call, 20),
                          "card": where}))


def step_mode(opt, work):
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.physics import engine
    dev = torch.device(opt.device)
    names = check_names(opt.variants.split(","))
    if "base" not in names:
        names = ["base"] + names
    kernels, host = kernels_and_host(opt, names, dev, work)
    B = cs.B_MAIN
    counts = {name: dict(over=0, aside=0, refused=0, not_host_bits=0)
              for name in kernels}
    checked = 0
    found = []
    wgen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    for seed in opt.seed:
        env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                                 ls_iterations=3, seed=cs.SEED,
                                 reference_flat_manifold=True,
                                 reference_wheel_patch=True, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        st = env.reset(B)
        for step in range(1, opt.steps + 1):
            st = env.step_autoreset_batch(st, torch.rand(
                (B, 2), generator=gen, device=dev) * 2 - 1)
            if step < opt.start or step % opt.every:
                continue
            ph = st.physics
            args = engine.newton_inputs(env.model, ph)
            ws = ph.qacc_warmstart.T.contiguous()
            want = k3.newton_solve_plain(*args, warmstart=ws)
            hq = (None if host is None
                  else host(on(args, "cpu"), ws.cpu()))
            checked += B
            active = args[14].sum(0)
            for name, run in kernels.items():
                got = run(args, ws)
                r = ratio(got, want)
                aside = cs.set_aside(
                    f"{name} seed {seed} step {step}", r,
                    cs.k3_witness(args, ws, wgen), [got], [])
                over = torch.nonzero(r > 1).flatten().tolist()
                c = counts[name]
                c["over"] += len(over)
                c["aside"] += int(aside.sum())
                c["refused"] += len(over) - int(aside.sum())
                if hq is not None:
                    c["not_host_bits"] += int(
                        (got.cpu() != hq).any(0).sum())
                print(f"{name} seed {seed} step {step}: worst ratio "
                      f"{float(r.max()):.3f}; envs over {over}; contact "
                      f"rows in contact: max {int(active.max())}, mean "
                      f"{float(active.float().mean()):.2f}", flush=True)
                if name != "base":
                    continue
                for i in over:
                    found.append((seed, step, i, sub(args, [i]),
                                  ws[:, [i]].contiguous()))
                for i in over[:4]:
                    detail(k3, args, ws, got, want, i, active, opt, kernels)
        del st, env
    where = (cs.gpu_name_and_limit() if dev.type == "cuda"
             else "host builds")
    if opt.time:
        time_variants(kernels, args, ws, where)
    for name, c in counts.items():
        bits = ("" if host is None else
                f"; qacc not bitwise the host build's on "
                f"{c['not_host_bits']}")
        print(f"variant {name}: {c['over']} envs over the tolerance of "
              f"{checked} solves, {c['aside']} set aside, {c['refused']} "
              f"not admitted{bits} ({where})")
    if opt.save and found:
        save_misses(opt.save, found)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--from", dest="start", type=int, default=60)
    p.add_argument("--seed", type=int, nargs="+", default=[3])
    p.add_argument("--save", default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--load", default=None)
    p.add_argument("--variants", default="base")
    p.add_argument("--host", action="store_true")
    p.add_argument("--time", action="store_true")
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--device", default="cuda")
    opt = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    if opt.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_k3_probe: needs a CUDA card (or --device "
                         "cpu)")
    with tempfile.TemporaryDirectory() as work:
        if opt.load:
            if opt.iterations is None:
                opt.iterations = 4
            load_mode(opt, work)
        else:
            step_mode(opt, work)


if __name__ == "__main__":
    main()
