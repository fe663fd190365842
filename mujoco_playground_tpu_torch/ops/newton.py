"""The Newton constraint solve: the plain twin shared by kernels K1 and K3,
and kernel K3 itself.

Ports ``newton_body`` and ``_cholesky_solve_lanes`` of the JAX package's
``ops/newton_pallas.py`` onto "lane vectors": ``(B,)`` tensors holding one
value per env, or Python floats for values that are static for the model.
The scalar helpers drop exact static zeros while the program is built, so
the tree sparsity of the robot (a wheel's Jacobian touches ~8 of 12 dofs,
a joint row 1-2) costs no arithmetic.  The CUDA step kernel
(``csrc/step_kernel.cu``) computes the same function with dense loops.

Kernel K3 (``newton_solve``, ``csrc/newton_kernel.cu``) is the standalone
solve of the staged step (``newton_solve_pallas``): the whole system
arrives from memory, batch-last, and its twin ``newton_solve_plain`` feeds
``newton_body`` dense rows exactly as the JAX kernel builds them.  K3 reads
the system in either of two layouts, as ``newton_solve_pallas`` does:
row-major (``solver_batched.newton_args``) or, with ``pre_transposed``,
the kernel layout ``physics/constraint_bl.py`` assembles, each read in
place by its own instantiation of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from mujoco_playground_tpu_torch.physics.constraint import EQ, FRICTION


def _is0(x):
    return isinstance(x, (int, float)) and x == 0.0


def _num(x):
    return isinstance(x, (int, float))


def smul(a, b):
    if _is0(a) or _is0(b):
        return 0.0
    return a * b


def sadd(*xs):
    out = None
    for x in xs:
        if _is0(x):
            continue
        out = x if out is None else out + x
    return 0.0 if out is None else out


def ssub(a, b):
    if _is0(b):
        return a
    if _is0(a):
        return -b
    return a - b


def smax(a, b):
    """Elementwise max of lanes and/or static floats."""
    if _num(a) and _num(b):
        return max(a, b)
    if _num(b):
        return torch.clamp_min(a, b)
    if _num(a):
        return torch.clamp_min(b, a)
    return torch.maximum(a, b)


def cholesky_solve_lanes(H, g, n, order=None):
    """Solve H x = g (SPD); H an n x n list-of-lists of lanes and/or static
    zeros, g a list of lanes/floats.  ``order`` permutes the elimination
    (leaves-first: wheel-chain dofs before the free joint, so the chains
    eliminate without fill-in)."""
    p = list(order) if order is not None else list(range(n))
    Hp = [[H[p[i]][p[j]] for j in range(n)] for i in range(n)]
    gp = [g[p[i]] for i in range(n)]
    L = [[0.0] * n for _ in range(n)]
    for j in range(n):
        s = [Hp[i][j] for i in range(n)]
        for k in range(j):
            ljk = L[j][k]
            if _is0(ljk):
                continue
            for i in range(j, n):
                s[i] = ssub(s[i], smul(L[i][k], ljk))
        d = torch.rsqrt(smax(s[j], 1e-30))
        for i in range(j, n):
            L[i][j] = smul(s[i], d)
    y = [0.0] * n
    for i in range(n):
        s = gp[i]
        for k in range(i):
            s = ssub(s, smul(L[i][k], y[k]))
        y[i] = s / L[i][i] if not _is0(s) else 0.0
    x = [0.0] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = ssub(s, smul(L[k][i], x[k]))
        x[i] = s / L[i][i] if not _is0(s) else 0.0
    xout = [0.0] * n
    for i in range(n):
        xout[p[i]] = x[i]
    return xout


def newton_body(nv, iterations, ls_iterations, M, a_s, jrows, cgroups,
                order=None, a0=None, ws_compare=True):
    """Fixed-iteration Newton on MuJoCo's soft-constraint primal with an
    exact (Newton) line search; returns the nv lanes of qacc.

      M        nv x nv list-of-lists of lanes / static floats.
      a_s      nv lanes: the smooth acceleration (the objective's anchor).
      jrows    joint rows: dict(G=nv lanes/floats, aref, Rinv, floss,
               active, is_eq, is_fric).
      cgroups  contact rows grouped by Jacobian sparsity pattern:
               dict(dofs, Jn/Jt1/Jt2 = per-dof (ncg, B) stacks, aref4 = 4
               (ncg, B), Rinv/active/mu = (ncg, B)); pyramidal friction.
      a0       warm start.  ``ws_compare`` picks the cheaper of a0 and a_s
               by primal cost (MuJoCo's mj_warmstart); False starts from a0
               unconditionally (the fused step's choice).
    """
    def japply(Jlist, avec):
        return sadd(*[smul(Jlist[v], avec[v]) for v in range(nv)])

    def gapply(Jg, dofs, avec):
        acc = None
        for i, v in enumerate(dofs):
            a = avec[v]
            if _is0(a):
                continue
            t = Jg[i] * (a[None, :] if isinstance(a, torch.Tensor) else a)
            acc = t if acc is None else acc + t
        return 0.0 if acc is None else acc

    def joint_force(r, x):
        raw = -x * r["Rinv"]
        if r["is_eq"]:
            f, q = raw, torch.ones_like(raw)
        elif r["is_fric"]:
            f = torch.clamp(raw, -r["floss"], r["floss"])
            q = (torch.abs(raw) < r["floss"]).to(raw.dtype)
        else:
            f = torch.clamp_min(raw, 0.0)
            q = (raw > 0).to(raw.dtype)
        return smul(f, r["active"]), smul(q, r["active"])

    def contact_forces4(g, x4):
        f4 = [torch.clamp_min(-x4[k] * g["Rinv"], 0.0) * g["active"]
              for k in range(4)]
        q4 = [(x4[k] < 0).to(f4[0].dtype) * g["active"] for k in range(4)]
        return f4, q4

    def pyr4(mu, an, at1, at2):
        return [an + mu * at1, an - mu * at1, an + mu * at2, an - mu * at2]

    def row_values(avec):
        xj = [ssub(japply(r["G"], avec), r["aref"]) for r in jrows]
        x4 = []
        for g in cgroups:
            p = pyr4(g["mu"], gapply(g["Jn"], g["dofs"], avec),
                     gapply(g["Jt1"], g["dofs"], avec),
                     gapply(g["Jt2"], g["dofs"], avec))
            x4.append([p[k] - g["aref4"][k] for k in range(4)])
        return xj, x4

    def jt_f(fj, f4):
        out = [0.0] * nv
        for r, f in zip(jrows, fj):
            for v in range(nv):
                out[v] = sadd(out[v], smul(r["G"][v], f))
        for g, fc in zip(cgroups, f4):
            fn = fc[0] + fc[1] + fc[2] + fc[3]
            ft1 = g["mu"] * (fc[0] - fc[1])
            ft2 = g["mu"] * (fc[2] - fc[3])
            for i, v in enumerate(g["dofs"]):
                out[v] = sadd(out[v],
                              (g["Jn"][i] * fn + g["Jt1"][i] * ft1
                               + g["Jt2"][i] * ft2).sum(0))
        return out

    def Mtv(dvec):
        return [sadd(*[smul(M[v][w], dvec[w]) for w in range(nv)])
                for v in range(nv)]

    a_s_vec = [a_s[v] for v in range(nv)]

    def primal_cost(vec, with_m_term):
        """Phi(vec); the smooth quadratic is exactly zero at vec == a_s."""
        xj, x4 = row_values(vec)
        c = 0.0
        for r, x in zip(jrows, xj):
            quad = 0.5 * x * x * r["Rinv"]
            if r["is_eq"]:
                rc = quad
            elif r["is_fric"]:
                lin = (r["floss"] * torch.abs(x)
                       - 0.5 * r["floss"] * r["floss"] / r["Rinv"])
                rc = torch.where(torch.abs(x) * r["Rinv"] < r["floss"],
                                 quad, lin)
            else:
                rc = torch.where(x < 0, quad, torch.zeros_like(quad))
            c = sadd(c, smul(rc, r["active"]))
        for g, x4g in zip(cgroups, x4):
            for k in range(4):
                xk = x4g[k]
                c = c + (torch.where(xk < 0, 0.5 * xk * xk * g["Rinv"],
                                     torch.zeros_like(xk))
                         * g["active"]).sum(0)
        if with_m_term:
            diff = [ssub(vec[v], a_s_vec[v]) for v in range(nv)]
            Mdiff = Mtv(diff)
            c = sadd(c, 0.5 * sadd(*[smul(diff[v], Mdiff[v])
                                     for v in range(nv)]))
        return c

    if a0 is None:
        avec = list(a_s_vec)
    elif not ws_compare:
        avec = list(a0)
    else:
        use_ws = primal_cost(list(a0), True) < primal_cost(a_s_vec, False)
        avec = [torch.where(use_ws, a0[v], a_s_vec[v]) for v in range(nv)]
    for _ in range(iterations):
        xj, x4 = row_values(avec)
        fq_j = [joint_force(r, x) for r, x in zip(jrows, xj)]
        fq_c = [contact_forces4(g, x) for g, x in zip(cgroups, x4)]
        jtf = jt_f([f for f, _ in fq_j], [f for f, _ in fq_c])
        diff = [ssub(avec[v], a_s_vec[v]) for v in range(nv)]
        Mdiff = Mtv(diff)
        grad = [ssub(Mdiff[v], jtf[v]) for v in range(nv)]

        # Hessian: M + G^T w G per joint row + J^T W J per contact group
        H = [[None] * nv for _ in range(nv)]
        for v in range(nv):
            for w in range(v, nv):
                H[v][w] = M[v][w]
        for r, (_, q) in zip(jrows, fq_j):
            wjr = smul(q, r["Rinv"])
            for v in range(nv):
                if _is0(r["G"][v]):
                    continue
                for w in range(v, nv):
                    if _is0(r["G"][w]):
                        continue
                    H[v][w] = sadd(H[v][w],
                                   smul(smul(r["G"][v], wjr), r["G"][w]))
        for g, (_, q4) in zip(cgroups, fq_c):
            w4 = [q4[k] * g["Rinv"] for k in range(4)]
            w01 = w4[0] + w4[1]
            w23 = w4[2] + w4[3]
            mu = g["mu"]
            W00 = w01 + w23
            W01 = mu * (w4[0] - w4[1])
            W02 = mu * (w4[2] - w4[3])
            W11 = mu * mu * w01
            W22 = mu * mu * w23
            dofs = g["dofs"]
            U1 = [W00 * g["Jn"][i] + W01 * g["Jt1"][i] + W02 * g["Jt2"][i]
                  for i in range(len(dofs))]
            U2 = [W01 * g["Jn"][i] + W11 * g["Jt1"][i]
                  for i in range(len(dofs))]
            U3 = [W02 * g["Jn"][i] + W22 * g["Jt2"][i]
                  for i in range(len(dofs))]
            for i, v in enumerate(dofs):
                for jj, w in enumerate(dofs):
                    if w < v:
                        continue
                    H[v][w] = sadd(H[v][w], (
                        g["Jn"][i] * U1[jj] + g["Jt1"][i] * U2[jj]
                        + g["Jt2"][i] * U3[jj]).sum(0))
        for v in range(nv):
            H[v][v] = H[v][v] + 1e-9
            for w in range(v + 1, nv):
                H[w][v] = H[v][w]
        delta = cholesky_solve_lanes(H, [ssub(0.0, g_) for g_ in grad], nv,
                                     order=order)

        # exact line search on the piecewise-quadratic 1-D restriction
        jdj = [japply(r["G"], delta) for r in jrows]
        jd4 = [pyr4(g["mu"], gapply(g["Jn"], g["dofs"], delta),
                    gapply(g["Jt1"], g["dofs"], delta),
                    gapply(g["Jt2"], g["dofs"], delta)) for g in cgroups]
        Md = Mtv(delta)
        dMd = sadd(*[smul(delta[v], Md[v]) for v in range(nv)])
        dM_as = sadd(*[smul(delta[v], Mdiff[v]) for v in range(nv)])
        alpha = torch.ones_like(dMd)
        for _ls in range(ls_iterations):
            dphi = dM_as + alpha * dMd
            ddphi = dMd
            for r, xr, jd in zip(jrows, xj, jdj):
                if _is0(jd):
                    continue
                f_a, q_a = joint_force(r, xr + alpha * jd)
                dphi = ssub(dphi, smul(jd, f_a))
                ddphi = sadd(ddphi, smul(smul(q_a, r["Rinv"]), jd * jd))
            for g, xc, jdc in zip(cgroups, x4, jd4):
                x4_a = [xc[k] + alpha[None, :] * jdc[k] for k in range(4)]
                f4_a, q4_a = contact_forces4(g, x4_a)
                acc_d = acc_dd = None
                for k in range(4):
                    td = jdc[k] * f4_a[k]
                    tdd = q4_a[k] * g["Rinv"] * jdc[k] * jdc[k]
                    acc_d = td if acc_d is None else acc_d + td
                    acc_dd = tdd if acc_dd is None else acc_dd + tdd
                dphi = dphi - acc_d.sum(0)
                ddphi = ddphi + acc_dd.sum(0)
            alpha = torch.clamp(alpha - dphi / torch.clamp_min(ddphi, 1e-12),
                                0.0, 2.0)
        avec = [avec[v] + alpha * delta[v] for v in range(nv)]
    return avec


# --------------------------------------------------------------------------
# kernel K3: the standalone Newton solve

K3_MAX_NJ = 16   # joint rows csrc/newton_kernel.cu holds per env
K3_MAX_NC = 72   # contact rows it holds per env (72 with the wheel patch)


def newton_solve_plain(Mt, a_s, G, j_aref, j_R, j_floss, j_active, j_kind,
                       Jn, Jt1, Jt2, c_aref, c_R, c_mu, c_active,
                       iterations, ls_iterations, warmstart=None,
                       pre_transposed=False):
    """Plain twin of K3: the arrays as the JAX ``newton_solve_pallas``
    takes them row-major (Mt (nv, nv, B), a_s (nv, B), G (nj, nv, B),
    j_* (nj, B), Jn/Jt1/Jt2 (nc, nv, B), c_aref (nc, 4, B), c_* (nc, B))
    or, with ``pre_transposed``, in the kernel layout (G (nv, nj, B),
    Jn/Jt1/Jt2 (nv, nc, B), c_aref (4, nc, B)), fed to ``newton_body`` as
    the JAX kernel builds its lists: every entry a lane (nothing static to
    prune), all contact rows in one all-dof group, ``Rinv = 1 / R``, and
    with a warm start the two-sided mj_warmstart pick.  Returns qacc
    (nv, B)."""
    if pre_transposed:
        G, Jn, Jt1, Jt2, c_aref = (torch.movedim(t, 0, 1)
                                   for t in (G, Jn, Jt1, Jt2, c_aref))
    nv = a_s.shape[0]
    nc = Jn.shape[0]
    M = [[Mt[v, w] for w in range(nv)] for v in range(nv)]
    jrows = [dict(G=[G[r, v] for v in range(nv)], aref=j_aref[r],
                  Rinv=1.0 / j_R[r], floss=j_floss[r], active=j_active[r],
                  is_eq=int(k) == EQ, is_fric=int(k) == FRICTION)
             for r, k in enumerate(j_kind)]
    cgroups = [dict(dofs=tuple(range(nv)), Jn=[Jn[:, v] for v in range(nv)],
                    Jt1=[Jt1[:, v] for v in range(nv)],
                    Jt2=[Jt2[:, v] for v in range(nv)],
                    aref4=[c_aref[:, k] for k in range(4)],
                    Rinv=1.0 / c_R, mu=c_mu, active=c_active)] if nc else []
    a0 = None if warmstart is None else [warmstart[v] for v in range(nv)]
    return torch.stack(newton_body(nv, iterations, ls_iterations, M,
                                   [a_s[v] for v in range(nv)], jrows,
                                   cgroups, a0=a0, ws_compare=True))


def launch_k3(lib, Mt, a_s, G, j_aref, j_R, j_floss, j_active, j_kind, Jn,
              Jt1, Jt2, c_aref, c_R, c_mu, c_active, iterations,
              ls_iterations, warmstart, stream, pre_transposed=False):
    """Run K3 from the loaded library ``lib`` on ``stream``: checks the
    inputs in the layout ``pre_transposed`` names, allocates qacc (nv, B)
    and raises if the launch fails.  The CUDA build takes device pointers
    and a CUDA stream; the host build of the same source (tests) CPU
    pointers."""
    nv, B = a_s.shape
    if pre_transposed:
        nj, nc = G.shape[1], Jn.shape[1]
    else:
        nj, nc = G.shape[0], Jn.shape[0]
    dims = lib.k3_nv
    dims.restype = ctypes.c_int
    if nv != dims():
        raise ValueError(f"Newton kernel is compiled for nv={dims()}, the "
                         f"system has {nv}")
    if nj > K3_MAX_NJ or nc > K3_MAX_NC:
        raise ValueError(f"Newton kernel holds at most {K3_MAX_NJ} joint and "
                         f"{K3_MAX_NC} contact rows; got {nj} and {nc}")
    dev = a_s.device
    g_rows, j_rows, a_rows = (((nv, nj), (nv, nc), (4, nc)) if pre_transposed
                              else ((nj, nv), (nc, nv), (nc, 4)))
    arrays = [("Mt", Mt, (nv, nv)), ("a_s", a_s, (nv,)), ("G", G, g_rows),
              ("j_aref", j_aref, (nj,)), ("j_R", j_R, (nj,)),
              ("j_floss", j_floss, (nj,)), ("j_active", j_active, (nj,)),
              ("Jn", Jn, j_rows), ("Jt1", Jt1, j_rows),
              ("Jt2", Jt2, j_rows), ("c_aref", c_aref, a_rows),
              ("c_R", c_R, (nc,)), ("c_mu", c_mu, (nc,)),
              ("c_active", c_active, (nc,))]
    if warmstart is not None:
        arrays.append(("warmstart", warmstart, (nv,)))
    for name, t, rows in arrays:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != rows + (B,):
            raise ValueError(f"{name}: expected shape {rows + (B,)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    kinds = [int(k) for k in j_kind]
    eq_mask = sum(1 << r for r, k in enumerate(kinds) if k == EQ)
    fric_mask = sum(1 << r for r, k in enumerate(kinds) if k == FRICTION)
    out = torch.empty((nv, B), dtype=torch.float32, device=dev)
    fn = lib.k3_launch_kernel_layout if pre_transposed else lib.k3_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = [t.data_ptr() for _, t, _ in arrays[:14]]
    ptr.append(warmstart.data_ptr() if warmstart is not None else None)
    ptr.append(out.data_ptr())
    err = fn(*ptr, B, nj, nc, int(iterations), int(ls_iterations), eq_mask,
             fric_mask, stream)
    if err != 0:
        raise RuntimeError(f"Newton kernel launch failed: CUDA error {err}")
    return out


def newton_solve(Mt, a_s, G, j_aref, j_R, j_floss, j_active, j_kind, Jn,
                 Jt1, Jt2, c_aref, c_R, c_mu, c_active, iterations,
                 ls_iterations, warmstart=None, pre_transposed=False):
    """K3: the batch-last Newton solve, arrays as ``newton_solve_plain``
    takes them, in either layout.  CPU tensors take the twin; CUDA tensors
    launch ``csrc/newton_kernel.cu``, which reads either layout in place.
    ``launches`` counts the kernel's launches on the row-major layout,
    ``launches_kernel_layout`` those on the kernel layout."""
    args = (Mt, a_s, G, j_aref, j_R, j_floss, j_active, j_kind, Jn, Jt1,
            Jt2, c_aref, c_R, c_mu, c_active, iterations, ls_iterations)
    if a_s.device.type == "cpu":
        return newton_solve_plain(*args, warmstart=warmstart,
                                  pre_transposed=pre_transposed)
    if a_s.device.type != "cuda":
        raise ValueError(f"newton_solve: unsupported device {a_s.device}")
    from mujoco_playground_tpu_torch.ops import build
    with torch.cuda.device(a_s.device):
        out = launch_k3(build.load("newton_kernel.cu"), *args, warmstart,
                        torch.cuda.current_stream(a_s.device).cuda_stream,
                        pre_transposed=pre_transposed)
    if pre_transposed:
        newton_solve.launches_kernel_layout += 1
    else:
        newton_solve.launches += 1
    return out


newton_solve.launches = 0
newton_solve.launches_kernel_layout = 0
