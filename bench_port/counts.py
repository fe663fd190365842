"""The yardstick's arithmetic, frozen: the float32 operations and the bytes
one env step of kernel K1 needs, and the H100's published peaks.

``k1_ops`` counts the work of the step and not of an implementation: over
the structural nonzeros of the robot's tree (each body's Jacobian over its
ancestor dofs; the tree-sparse factor and solves of M and of the Newton
Hessian in the leaves-first order) and over only the contact rows that
are active in the states measured (``slot_active``, counted by the
reference's own collision, ``slot_activity``).  The per-stage constants are
the operations of the step's code as the port's ``chip_smoke.py`` counted
them by hand (no hardware counters run on that machine).  A change to the
program moves none of it.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import step as ref_step

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BYTES = 3.35e12          # HBM3 bytes/s
PEAK_F32 = 67e12              # float32 FLOP/s outside the tensor cores


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


def k1_ops(model, slot_active):
    """Float32 operations of one env step of the fused path (an FMA counts
    2): the physics step, the step's scan and the fresh spawn's, the env
    rows; ``slot_active`` is each contact slot's mean activity over the
    envs."""
    sm = ref_step.static_model(model)
    nv, nbox, ns = sm.nv, sm.num_scene_boxes, sm.nsite
    anc = [np.flatnonzero(sm.ancestor_mask[b]) for b in range(sm.nbody)]
    n = {b: len(anc[b]) for b in range(sm.nbody)}
    m_pat = np.eye(nv, dtype=bool)
    for b in sm.bodies:
        m_pat[np.ix_(anc[b], anc[b])] = True
    h_pat = m_pat.copy()
    for d1, d2 in sm.eq_dof_pairs:
        h_pat[d1, d2] = h_pat[d2, d1] = True
    slot_body = [s[0] for s in ref_step.slot_statics(sm)]
    for b in set(slot_body):
        h_pat[np.ix_(anc[b], anc[b])] = True
    nnz_m = int(m_pat.sum())
    fac_m, sol_m = chol_ops(m_pat, sm.order)
    fac_h, sol_h = chol_ops(h_pat, sm.order)
    nj = (len(sm.eq_dof_pairs) + len(sm.friction_dofs)
          + 2 * len(sm.limited_dofs))

    def contacts(f):
        """Expected sum of f(n) over the active contact rows, n the row's
        dof count."""
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
    euler = 2 * nnz_m + 4 * nv + fac_m + sol_m + nv + 56 + 2 * (nv - 6)
    lidar = 2 * ns * (72 + 27 * nbox)
    env_rows = 60 + ns + 8 * sm.nbody
    return (2 * fk + crba + rnea + smooth + collide + rows
            + sm.iterations * newton_it + euler + lidar + env_rows)


def policy_ops(net: dict) -> int:
    """Float32 operations of the policy's action for one env (an FMA counts
    2), over the tensors of its checkpoint (``reference/policy.py``): 2 per
    observation entry for its normalisation, then per dense layer of the
    actor tower 2 x in x out, 1 per output for the bias and 1 for the
    activation, and for the action head 2 x in x out plus the bias.  The
    value tower is not counted: the action does not need it."""
    ops = 2 * net["pi_tower.dense_0.weight"].shape[1]
    i = 0
    while f"pi_tower.dense_{i}.weight" in net:
        out, inp = net[f"pi_tower.dense_{i}.weight"].shape
        ops += 2 * inp * out + 2 * out
        i += 1
    out, inp = net["action_head.weight"].shape
    return ops + 2 * inp * out + out


def k1_bytes(model):
    """Bytes one env step of K1 with the env rows and the fresh scan must
    move: qpos, qvel, ctrl, the warm start and the env inputs in; qpos,
    qvel, the body frames, qacc and the env slab (the step's rows and both
    scans) out."""
    return 4 * (model.nq + 2 * model.nv + model.nu + 7 + model.nq
                + model.nv + model.nbody * 7 + model.nv + 2 * model.nsite
                + 12)


def bound_ms(nbytes, flops):
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the float32 peak (ms), and
    which of the two."""
    t_b = nbytes / PEAK_BYTES * 1e3
    t_f = flops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def slot_activity(model, qpos) -> list:
    """Each contact slot's mean activity over a batch of states, qpos (B,
    nq), by the reference's collision (``contact_activity``)."""
    rows = qpos.T.contiguous().to(model.dtype)
    return ref_step.contact_activity(model, rows).float().mean(1).tolist()


def step_ops(model, batches) -> float:
    """Float32 operations of one env step of the fused path, with each
    slot's activity averaged over ``batches`` of states (qpos (B, nq)
    each)."""
    with torch.no_grad():
        acts = [slot_activity(model, q) for q in batches]
    mean = [sum(a[i] for a in acts) / len(acts) for i in range(len(acts[0]))]
    return float(k1_ops(model, mean))
