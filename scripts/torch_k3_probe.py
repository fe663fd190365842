"""K3 against its twins on path B's states, step by step.

    python3 scripts/torch_k3_probe.py [--steps 200] [--every 10] [--from 60]

Steps ``chip_smoke.py``'s path B (the umaze env with the compat manifolds
at 16384 envs, solver 4/3, seeded uniform actions) and, every ``--every``
steps from ``--from`` on, holds K3 on the step's Newton inputs against its
float32 twin with ``chip_smoke.py``'s tolerance.  For each env over it
(at most 4 a step) it prints the env's rows in contact, whether the
kernel gives the same bits for the env alone and in its block of 8 (a
test for cross-env interference), and the kernel's and the float32
twin's distances, in units of the tolerance, to the float64 twin and to
a float64 twin run to convergence (40 Newton and 20 line-search
iterations), with the three qacc vectors.  Needs one CUDA card.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def sub(args, ids):
    return tuple(a[..., ids].contiguous() if isinstance(a, torch.Tensor)
                 else a for a in args)


def f64(args):
    return [a.double() if isinstance(a, torch.Tensor)
            and a.is_floating_point() else a for a in args]


def main():
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    from mujoco_playground_tpu_torch.ops import build
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.physics import engine
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--from", dest="start", type=int, default=60)
    p.add_argument("--seed", type=int, default=3)
    args_ = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    dev = torch.device("cuda")
    B = cs.B_MAIN
    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, seed=cs.SEED,
                             reference_flat_manifold=True,
                             reference_wheel_patch=True)
    gen = torch.Generator(device=dev).manual_seed(args_.seed)
    tol = [cs.K3_TOL + (True,)]
    st = env.reset(B)
    total = checked = 0
    for step in range(1, args_.steps + 1):
        st = env.step_autoreset_batch(st, torch.rand(
            (B, 2), generator=gen, device=dev) * 2 - 1)
        if step < args_.start or step % args_.every:
            continue
        ph = st.physics
        args = engine.newton_inputs(env.model, ph)
        ws = ph.qacc_warmstart.T.contiguous()
        got = k3.newton_solve(*args, warmstart=ws)
        want = k3.newton_solve_plain(*args, warmstart=ws)
        r = cs.outputs_ratio([got], [want], tol)
        over = torch.nonzero(r > 1).flatten().tolist()
        total += len(over)
        checked += B
        active = args[14].sum(0)
        print(f"step {step}: envs over {over} (ratios "
              f"{[round(float(r[i]), 2) for i in over]}); contact rows in "
              f"contact: max {int(active.max())}, mean "
              f"{float(active.float().mean()):.2f}", flush=True)
        for i in over[:4]:
            one, wi = sub(args, [i]), ws[:, [i]].contiguous()
            alone = k3.newton_solve(*one, warmstart=wi)
            blk = list(range(i // 8 * 8, i // 8 * 8 + 8))
            inblk = k3.newton_solve(*sub(args, blk),
                                    warmstart=ws[:, blk].contiguous())
            x64 = k3.newton_solve_plain(*f64(one), warmstart=wi.double())
            more = f64(one)
            more[15], more[16] = 40, 20
            conv = k3.newton_solve_plain(*more, warmstart=wi.double())
            g, w = got[:, [i]], want[:, [i]]

            def ratio(a, b):
                return float(cs.outputs_ratio([a], [b], tol)[0])

            print(f"  env {i}: rows in contact {int(active[i])}; kernel "
                  f"alone bitwise as in the batch: {torch.equal(alone, g)}"
                  f", in its block of 8: "
                  f"{torch.equal(inblk[:, i % 8:i % 8 + 1], g)}; kernel to "
                  f"the float32 twin {ratio(g, w):.2f}, to the float64 "
                  f"twin {ratio(g, x64):.2f}, to the converged one "
                  f"{ratio(g, conv):.2f}; float32 twin to the float64 "
                  f"twin {ratio(w, x64):.2f}, to the converged one "
                  f"{ratio(w, conv):.2f}", flush=True)
            for name, q in (("kernel", g), ("twin32", w), ("twin64", x64)):
                print(f"    {name} {q.flatten().tolist()}")
    print(f"envs over the tolerance: {total} of {checked} solves "
          f"({cs.gpu_name_and_limit()})")


if __name__ == "__main__":
    main()
