// Kernel K1's model constants, its lane groups (group.cuh), and the per-item
// pieces of its smooth-dynamics and collision stages (see step_kernel.cuh
// for the program and the kernel).
//
// Each piece is the dense counterpart of a lane stage of ops/step.py
// (fk_lanes, motion_subspace_lanes, spatial_inertia_lanes, crba_bias_lanes,
// actuator_lanes, collide_lanes, joint_rows_lanes, contact_rows_lanes):
// where the plain twin drops the model's static zeros while it builds its
// program, these loops skip them at run time (body_dofs, body_inert).
#pragma once

#include "group.cuh"
#include "lidar.cuh"

#define JNT_FREE 0
#define JNT_HINGE 1
#define JNT_SLIDE 2
#define ROW_EQ 0
#define ROW_FRICTION 1
#define ROW_CONE 2
#define K1_INF 1e30f  // running-min sentinel of the nearest-box/vertex picks

// G lanes compute one env (a power of two dividing 32, so a group never
// straddles a warp); a block holds K1_ENVS envs.  The host build runs the
// same G lanes one after another at every barrier.  G = 32 and 2 envs per
// block timed fastest on an H100 (PERF.md).
#define K1_G 32
#define K1_ENVS 2
#define K1_THREADS (K1_G * K1_ENVS)
// group_chol_solve keeps one row of the factor per lane
static_assert(K1_G >= NV, "K1_G lanes must hold the NV rows of a factor");

// Impedance spline and reference-acceleration parameters of one
// solref/solimp pair (mirror of ops/step.py Imp).
struct Imp {
  float d0, dmm, width, mid, a, b, power;
  int ipower;  // power as a small integer (1..4), else 0
  float bref, kden;
};

// Mirror of ops/step.py K1Const (ctypes): field order and types must match.
struct K1Const {
  int body_parent[NBODY];
  int body_inert[NBODY];
  float body_pos[NBODY][3];
  float body_quat[NBODY][4];
  float body_mass[NBODY];
  float body_ipos[NBODY][3];
  float body_iquat[NBODY][4];
  float body_inertia[NBODY][3];
  int jnt_type[NJNT];
  int jnt_body[NJNT];
  int jnt_qposadr[NJNT];
  int jnt_dofadr[NJNT];
  float jnt_axis[NJNT][3];
  float jnt_pos[NJNT][3];
  float qpos0[NQ];
  int dof_body[NV];
  int dof_qposadr[NV];
  int dof_carried[NV];
  int order[NV];
  float dof_damping[NV];
  float dof_armature[NV];
  float h_damping[NV];
  int act_dof[NU];
  int act_qadr[NU];
  float act_gain[NU];
  float act_bias[NU][3];
  float act_ctrlrange[NU][2];
  float act_forcerange[NU][2];
  int jr_kind[NJROW];
  int jr_dof1[NJROW];
  int jr_dof2[NJROW];
  int jr_qadr1[NJROW];
  int jr_qadr2[NJROW];
  float jr_q01[NJROW];
  float jr_q02[NJROW];
  float jr_coef[NJROW][5];
  float jr_side[NJROW];
  float jr_limit[NJROW];
  float jr_diag[NJROW];
  float jr_rinv[NJROW];
  float jr_floss[NJROW];
  Imp jr_imp[NJROW];
  int slot_body[NSLOT];
  float slot_mu[NSLOT];
  float slot_diag[NSLOT];
  Imp slot_imp[NSLOT];
  int wheel_body[NWHEEL];
  float wheel_pos[NWHEEL][3];
  float wheel_axis[NWHEEL][3];
  float wheel_size[NWHEEL][2];
  int hull_body[NHULL];
  uint64_t hull_quad[NHULL][4];
  float hull_verts[NHULL][NHULLV][3];
  float hull_bias[NHULL][NHULLV];
  float hull_center[NHULL][3];
  float plane_frame[9];
  float box_pos[MAX_BOXES][3];
  float box_size[MAX_BOXES][3];
  int nbox;
  int iterations;
  int ls_iterations;
  float timestep;
  float gravity[3];
  LidarConst lidar;
  float t_xpos[NBODY][3];
  float t_xquat[NBODY][4];
  float t_xy[2];
  // K1e: per slot, the wheel of a wheel slot (-1 for a hull slot) and its
  // body's invweight, so the domain-randomized build can recompute slot_mu
  // and slot_diag from each env's wheel friction
  int slot_wheel[NSLOT];
  float slot_iw[NSLOT];
  float plane_mu;
  int order_inv[NV];  // position of each dof in the elimination order
  uint32_t body_dofs[NBODY];  // per body its ancestor dofs, as bits
  int body_depth[NBODY];      // per body its depth in the tree (world: 0)
  int max_depth;
  // the (v, w), v < w, of each entry above an NV x NV diagonal, row by row
  int off_v[NV * (NV - 1) / 2];
  int off_w[NV * (NV - 1) / 2];
  int dof_jrows[NV][DOF_JROWS];  // per dof the joint rows that touch it,
                                 // ascending, -1 padded
};

// Two copies of one block.  c_k1 in __constant__ memory serves reads at
// one address for the whole warp (loop-uniform indices, the model's
// scalars, the box loops); g_k1 in global memory, cached in L1, serves
// tables that lanes index by their own item (per beam, slot, vertex, dof,
// body), which __constant__ memory would serialize.
KCONST K1Const c_k1;
#ifdef __CUDACC__
__device__ K1Const g_k1;
#else
#define g_k1 c_k1
#endif

// ---------------------------------------------------------- lane groups

// K1's groups of K1_G lanes (group.cuh).
typedef Group<K1_G> Grp;
template <class T>
using PerLane = PerLaneG<T, K1_G>;

#define FOR_ITEMS(i, lane, n) for (int i = (lane); i < (n); i += K1_G)

// Whether dof v moves body b (an ancestor dof of b).
HD bool moves(uint32_t body_dofs, int v) { return (body_dofs >> v) & 1u; }

// The column of dof v among a body's dofs (the set bits of body_dofs, in
// dof order).
HD int dof_col(uint32_t body_dofs, int v) {
  return popc32(body_dofs & ((1u << v) - 1u));
}

// ------------------------------------------------- domain-randomized scalars

// Row offsets of the per-env parameters of kernel K1e in its dr (DR_ROWS, B)
// input: the JAX package's step_pallas.DR_LAYOUT, every field, in that order
// and row-major (ops/step.py pack_dr_params).
#define DR_BODY_MASS 0
#define DR_BODY_INERTIA (DR_BODY_MASS + NBODY)
#define DR_DOF_DAMPING (DR_BODY_INERTIA + 3 * NBODY)
#define DR_DOF_ARMATURE (DR_DOF_DAMPING + NV)
#define DR_DOF_FRICTIONLOSS (DR_DOF_ARMATURE + NV)
#define DR_ACT_GAIN (DR_DOF_FRICTIONLOSS + NV)
#define DR_ACT_BIAS (DR_ACT_GAIN + NU)
#define DR_WHEEL_FRICTION (DR_ACT_BIAS + 3 * NU)
#define DR_PLANE_Z (DR_WHEEL_FRICTION + NWHEEL)
#define DR_ROWS (DR_PLANE_Z + 1)

// Access to one env's randomized parameters.  DRP<false> is empty: the
// non-randomized builds read K1Const and carry nothing.  DRP<true> points at
// the env's DR_ROWS parameters, copied into its workspace once.
template <bool DR>
struct DRP {};
template <>
struct DRP<true> {
  const float* p;
};

// Parameter row `row` of the env under DR, else the model's value `base`.
template <bool DR>
HD float param(const DRP<DR>& d, int row, float base) {
  if constexpr (DR) return d.p[row];
  else return base;
}

// ---------------------------------------------------------------- kinematics

// The frame of body b from its parent's (world: the identity).
HD void fk_body(int b, const float* q, float (*xpos)[3], float (*xquat)[4]) {
  const K1Const& C = g_k1;
  int p = C.body_parent[b];
  float pp[3] = {0.0f, 0.0f, 0.0f}, pq[4] = {1.0f, 0.0f, 0.0f, 0.0f};
  if (p != 0) {
    for (int k = 0; k < 3; ++k) pp[k] = xpos[p][k];
    for (int k = 0; k < 4; ++k) pq[k] = xquat[p][k];
  }
  float pos[3], quat[4], r[3];
  qrot(pq, C.body_pos[b], r);
  for (int k = 0; k < 3; ++k) pos[k] = pp[k] + r[k];
  qmul(pq, C.body_quat[b], quat);
  for (int j = 0; j < NJNT; ++j) {
    if (c_k1.jnt_body[j] != b) continue;
    int adr = C.jnt_qposadr[j];
    int t = C.jnt_type[j];
    if (t == JNT_FREE) {
      for (int k = 0; k < 3; ++k) pos[k] = q[adr + k];
      const float* qq = q + adr + 3;
      float norm = sqrtf(qq[0] * qq[0] + qq[1] * qq[1] + qq[2] * qq[2] +
                         qq[3] * qq[3]);
      for (int k = 0; k < 4; ++k) quat[k] = qq[k] / norm;
    } else if (t == JNT_HINGE) {
      float theta = q[adr] - C.qpos0[adr];
      const float* jp = C.jnt_pos[j];
      const float* ax = C.jnt_axis[j];
      bool has_jp = jp[0] != 0.0f || jp[1] != 0.0f || jp[2] != 0.0f;
      float anchor[3];
      qrot(quat, jp, r);
      for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + r[k];
      float s, c;
      sincosf(theta * 0.5f, &s, &c);
      float aa[4] = {c, ax[0] * s, ax[1] * s, ax[2] * s};
      float nq[4];
      qmul(quat, aa, nq);
      for (int k = 0; k < 4; ++k) quat[k] = nq[k];
      if (has_jp) {
        qrot(quat, jp, r);
        for (int k = 0; k < 3; ++k) pos[k] = anchor[k] - r[k];
      }
    } else {  // slide
      qrot(quat, C.jnt_axis[j], r);
      float dq = q[adr] - C.qpos0[adr];
      for (int k = 0; k < 3; ++k) pos[k] = pos[k] + dq * r[k];
    }
  }
  for (int k = 0; k < 3; ++k) xpos[b][k] = pos[k];
  for (int k = 0; k < 4; ++k) xquat[b][k] = quat[k];
}

// Every body's frame, one tree level per stage and one lane per body.
HD void group_fk(const Grp& g, const float* q, float (*xpos)[3],
                 float (*xquat)[4]) {
  for (int d = 1; d <= c_k1.max_depth; ++d)
    stage(g, [&](int lane) {
      if (d == 1 && lane == 0) {
        for (int k = 0; k < 3; ++k) xpos[0][k] = 0.0f;
        xquat[0][0] = 1.0f;
        xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
      }
      FOR_ITEMS(b, lane, NBODY) {
        if (g_k1.body_depth[b] == d) fk_body(b, q, xpos, xquat);
      }
    });
}

// S[v] = (angular, linear) motion about anchor of the dofs of joint j.
HD void joint_subspace(int j, const float (*xpos)[3], const float (*xquat)[4],
                       const float* anchor, float (*S)[6]) {
  const K1Const& C = g_k1;
  int b = C.jnt_body[j];
  int da = C.jnt_dofadr[j];
  int t = C.jnt_type[j];
  if (t == JNT_FREE) {
    for (int k = 0; k < 3; ++k)
      for (int l = 0; l < 6; ++l) S[da + k][l] = (l == 3 + k) ? 1.0f : 0.0f;
    float R[9], rel[3];
    qmat(xquat[b], R);
    for (int k = 0; k < 3; ++k) rel[k] = anchor[k] - xpos[b][k];
    for (int k = 0; k < 3; ++k) {
      float w[3] = {R[k], R[3 + k], R[6 + k]};
      float* s = S[da + 3 + k];
      s[0] = w[0];
      s[1] = w[1];
      s[2] = w[2];
      v3cross(w, rel, s + 3);
    }
  } else {
    float aw[3], anch[3], r[3];
    qrot(xquat[b], C.jnt_axis[j], aw);
    const float* jp = C.jnt_pos[j];
    for (int k = 0; k < 3; ++k) anch[k] = xpos[b][k];
    if (jp[0] != 0.0f || jp[1] != 0.0f || jp[2] != 0.0f) {
      qrot(xquat[b], jp, r);
      for (int k = 0; k < 3; ++k) anch[k] = anch[k] + r[k];
    }
    float* s = S[da];
    if (t == JNT_HINGE) {
      float rel[3];
      for (int k = 0; k < 3; ++k) rel[k] = anchor[k] - anch[k];
      for (int k = 0; k < 3; ++k) s[k] = aw[k];
      v3cross(aw, rel, s + 3);
    } else {
      for (int k = 0; k < 3; ++k) {
        s[k] = 0.0f;
        s[3 + k] = aw[k];
      }
    }
  }
}

// 6x6 spatial inertia of body b about anchor.
template <bool DR>
HD void spatial_inertia(int b, const float* xpos_b, const float* xquat_b,
                        const float* anchor, float (*I6)[6],
                        const DRP<DR>& dr) {
  const K1Const& C = g_k1;
  float iq[4], R[9], com[3], c[3];
  qmul(xquat_b, C.body_iquat[b], iq);
  qmat(iq, R);
  float diag[3];
  for (int k = 0; k < 3; ++k)
    diag[k] = param(dr, DR_BODY_INERTIA + 3 * b + k, C.body_inertia[b][k]);
  qrot(xquat_b, C.body_ipos[b], com);
  for (int k = 0; k < 3; ++k) c[k] = (xpos_b[k] + com[k]) - anchor[k];
  float m = param(dr, DR_BODY_MASS + b, C.body_mass[b]);
  float cx[3][3] = {{0.0f, -c[2], c[1]}, {c[2], 0.0f, -c[0]},
                    {-c[1], c[0], 0.0f}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float iw = R[3 * i] * diag[0] * R[3 * j] +
                 R[3 * i + 1] * diag[1] * R[3 * j + 1] +
                 R[3 * i + 2] * diag[2] * R[3 * j + 2];
      float cc = cx[i][0] * cx[j][0] + cx[i][1] * cx[j][1] +
                 cx[i][2] * cx[j][2];
      I6[i][j] = iw + m * cc;
      I6[i][3 + j] = m * cx[i][j];
      I6[3 + i][j] = m * cx[j][i];
      I6[3 + i][3 + j] = (i == j) ? m : 0.0f;
    }
}

HD void mat6_vec(const float (*A)[6], const float* x, float* y) {
  for (int k = 0; k < 6; ++k) {
    float s = 0.0f;
    for (int l = 0; l < 6; ++l) s = s + A[k][l] * x[l];
    y[k] = s;
  }
}

// Velocity-product acceleration of carried dof d (zero otherwise):
// (vbody of the dof's body) x S[d] * qvel[d].
HD void dof_cdot(int d, const float (*vbody)[6], const float* s, float vel_d,
                 float* out) {
  const K1Const& C = g_k1;
  int db = C.dof_body[d];
  if (C.dof_carried[d] && C.body_inert[db]) {
    const float* vb = vbody[db];
    float mc[6], t[3];
    v3cross(vb, s, mc);
    v3cross(vb + 3, s, mc + 3);
    v3cross(vb, s + 3, t);
    for (int k = 0; k < 3; ++k) mc[3 + k] = mc[3 + k] + t[k];
    for (int k = 0; k < 6; ++k) out[k] = mc[k] * vel_d;
  } else {
    for (int k = 0; k < 6; ++k) out[k] = 0.0f;
  }
}

// ctrl -> generalized actuator force on dof v.
template <bool DR>
HD float actuator_force(int v, const float* q, const float* vel,
                        const float* ctrl, const DRP<DR>& dr) {
  const K1Const& C = c_k1;
  float out = 0.0f;
  for (int u = 0; u < NU; ++u) {
    int d = C.act_dof[u];
    if (d != v) continue;
    float c = fminf(fmaxf(ctrl[u], C.act_ctrlrange[u][0]),
                    C.act_ctrlrange[u][1]);
    float gain = param(dr, DR_ACT_GAIN + u, C.act_gain[u]);
    float b0 = param(dr, DR_ACT_BIAS + 3 * u, C.act_bias[u][0]);
    float b1 = param(dr, DR_ACT_BIAS + 3 * u + 1, C.act_bias[u][1]);
    float b2 = param(dr, DR_ACT_BIAS + 3 * u + 2, C.act_bias[u][2]);
    float f = gain * c + b0 + b1 * q[C.act_qadr[u]] + b2 * vel[d];
    f = fminf(fmaxf(f, C.act_forcerange[u][0]), C.act_forcerange[u][1]);
    out = out + f;
  }
  return out;
}

// ------------------------------------------------- the group's Cholesky

// An SPD system in the model's leaves-first elimination order (wheel-chain
// dofs before the free joint): A[i][k] = H[p[i]][p[k]] for i >= k and
// t[i] = g[p[i]], p = C.order.
struct Chol {
  float A[NV][NV];
  float t[NV];
};

// Solve the system the previous stage wrote into c; x[p[i]] = z[i].
// Lane i < NV holds row i and t[i] in registers.  Right-looking: step j
// takes the pivot and column j from their lanes by shuffles, and each lane
// updates its row's trailing entries and its right-hand side, so the
// forward solve rides along.  Column j is scaled by the pivot's rsqrt one
// step later, when no lane reads it any more: row i becomes row i of the
// factor L, and t[i] becomes y[i].  The back substitution, a chain of NV
// divisions, runs on every lane alike, each term's L[k][i] taken from lane
// k.
HD void group_chol_solve(const Grp& g, Chol& c, float* x) {
  PerLane<float[NV]> row;
  PerLane<float> t;
  lanes(g, [&](int lane) {
    float* r = row.at(lane);
    UNROLL for (int k = 0; k < NV; ++k)
      r[k] = (lane < NV && k <= lane) ? c.A[lane][k] : 0.0f;
    t.at(lane) = lane < NV ? c.t[lane] : 0.0f;
  });
  float d_prev = 1.0f, y_prev = 0.0f;  // step j - 1's pivot rsqrt and y
  UNROLL for (int j = 0; j < NV; ++j) {
    float d_j = 0.0f, y_j = 0.0f;
    lanes(g, [&](int lane) {
      float* r = row.at(lane);
      float ajj = from_lane(g, j, [&](int l) { return row.at(l)[j]; });
      float tj = from_lane(g, j, [&](int l) { return t.at(l); });
      float lkj[NV];
      UNROLL for (int k = j + 1; k < NV; ++k)
        lkj[k] = from_lane(g, k, [&](int l) { return row.at(l)[j]; });
      float d = rsqrtf(fmaxf(ajj, 1e-30f));
      float yj = tj / (ajj * d);
      float lij = r[j] * d;
      UNROLL for (int k = j + 1; k < NV; ++k)
        if (k <= lane) r[k] = r[k] - lij * (lkj[k] * d);
      if (lane > j) t.at(lane) = t.at(lane) - lij * yj;
      if (j > 0) {
        r[j - 1] = r[j - 1] * d_prev;
        if (lane == j - 1) t.at(lane) = y_prev;
      }
      d_j = d;
      y_j = yj;
    });
    d_prev = d_j;
    y_prev = y_j;
  }
  lanes(g, [&](int lane) {
    float* r = row.at(lane);
    r[NV - 1] = r[NV - 1] * d_prev;
    if (lane == NV - 1) t.at(lane) = y_prev;
  });
  stage(g, [&](int lane) {
    float z[NV];
    UNROLL for (int i = NV - 1; i >= 0; --i) {
      float s = from_lane(g, i, [&](int l) { return t.at(l); });
      UNROLL for (int k = i + 1; k < NV; ++k)
        s = s - from_lane(g, k, [&](int l) { return row.at(l)[i]; }) * z[k];
      z[i] = s / from_lane(g, i, [&](int l) { return row.at(l)[i]; });
    }
    if (lane == 0)
      UNROLL for (int i = 0; i < NV; ++i) x[c_k1.order[i]] = z[i];
  });
}

// ----------------------------------------------------------------- collision

// One contact candidate: point, normal, distance (the row's frame is
// make_frame of the normal; the plane's normal gives plane_frame exactly).
struct Slot {
  float pos[3];
  float n[3];
  float dist;
};

HD void plane_slot(const float* p, float plane_z, Slot& s) {
  float dist = p[2] - plane_z;
  s.pos[0] = p[0];
  s.pos[1] = p[1];
  s.pos[2] = p[2] - 0.5f * dist;
  s.dist = dist;
  for (int k = 0; k < 3; ++k) s.n[k] = c_k1.plane_frame[k];
}

// Tangent frame rows [n, t1, t2] of a contact normal.
HD void make_frame(const float* n, float* frame) {
  bool cond = fabsf(n[0]) < 0.5f;
  float a[3] = {cond ? 1.0f : 0.0f, cond ? 0.0f : 1.0f, 0.0f};
  float t1[3];
  v3cross(n, a, t1);
  float t1n = fmaxf(sqrtf(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]),
                    1e-12f);
  for (int k = 0; k < 3; ++k) t1[k] = t1[k] / t1n;
  for (int k = 0; k < 3; ++k) {
    frame[k] = n[k];
    frame[3 + k] = t1[k];
  }
  v3cross(n, t1, frame + 6);
}

// Point vs AABB: distance, outward normal and contact point.
HD void point_box(const float* p, const float* bp, const float* bs,
                  float* dist, float* n, float* pos) {
  float rel[3], q[3];
  for (int k = 0; k < 3; ++k) {
    rel[k] = p[k] - bp[k];
    q[k] = fabsf(rel[k]) - bs[k];
  }
  bool inside = q[0] < 0.0f && q[1] < 0.0f && q[2] < 0.0f;
  float qp[3];
  for (int k = 0; k < 3; ++k) qp[k] = fmaxf(q[k], 0.0f);
  float dist_out = sqrtf(qp[0] * qp[0] + qp[1] * qp[1] + qp[2] * qp[2]);
  bool is0 = q[0] >= q[1] && q[0] >= q[2];
  bool is1 = !is0 && q[1] >= q[2];
  bool is2 = !is0 && !is1;
  bool axsel[3] = {is0, is1, is2};
  float qmax = is0 ? q[0] : (is1 ? q[1] : q[2]);
  float delta[3];
  for (int k = 0; k < 3; ++k)
    delta[k] = rel[k] - fminf(fmaxf(rel[k], -bs[k]), bs[k]);
  float dn = sqrtf(delta[0] * delta[0] + delta[1] * delta[1] +
                   delta[2] * delta[2]);
  float dsafe = fmaxf(dn, 1e-9f);
  for (int k = 0; k < 3; ++k) {
    float sgn = (float)(rel[k] > 0.0f) - (float)(rel[k] < 0.0f);
    n[k] = inside ? (axsel[k] ? sgn : 0.0f) : delta[k] / dsafe;
  }
  float d = inside ? qmax : dist_out;
  *dist = d;
  for (int k = 0; k < 3; ++k) pos[k] = p[k] - 0.5f * d * n[k];
}

// The nearest scene box to point c by squared surface distance, and the
// second nearest: a strictly closer box replaces the best and the old best
// moves to second; ties keep the earlier box (the order of top_k(-d2)).
HD void nearest_boxes(const float* c, int* best, int* second) {
  const K1Const& C = c_k1;
  float d2b = K1_INF, d2s = K1_INF;
  int ib = 0, is = 0;
  for (int k = 0; k < C.nbox; ++k) {
    float d2 = 0.0f;
    for (int l = 0; l < 3; ++l) {
      float q = fmaxf(fabsf(c[l] - C.box_pos[k][l]) - C.box_size[k][l], 0.0f);
      d2 = d2 + q * q;
    }
    bool isb = d2 < d2b;
    bool iss = !isb && d2 < d2s;
    if (isb) {
      d2s = d2b;
      is = ib;
      d2b = d2;
      ib = k;
    } else if (iss) {
      d2s = d2;
      is = k;
    }
  }
  *best = ib;
  *second = is;
}

// Cylinder (center c, unit axis a, radius r, half-height h) vs box k at
// disc end e: the rim point nearest the box (two fixed-point iterations),
// collided as a point.
HD void cylinder_box_end(const float* c, const float* a, float r, float h,
                         int k, int e, Slot& out) {
  const float* bp = g_k1.box_pos[k];
  const float* bs = g_k1.box_size[k];
  float fx[3] = {1.0f - a[0] * a[0], -(a[0] * a[1]), -(a[0] * a[2])};
  float fy[3] = {-(a[1] * a[0]), 1.0f - a[1] * a[1], -(a[1] * a[2])};
  float fxn = sqrtf(fx[0] * fx[0] + fx[1] * fx[1] + fx[2] * fx[2]);
  float fall[3];
  for (int l = 0; l < 3; ++l) fall[l] = fxn > 0.1f ? fx[l] : fy[l];
  float fn = fmaxf(sqrtf(fall[0] * fall[0] + fall[1] * fall[1] +
                         fall[2] * fall[2]), 1e-12f);
  for (int l = 0; l < 3; ++l) fall[l] = fall[l] / fn;
  float eh = (e == 0 ? -1.0f : 1.0f) * h;
  float ce[3], q[3];
  for (int l = 0; l < 3; ++l) q[l] = ce[l] = c[l] + eh * a[l];
  for (int it = 0; it < 2; ++it) {
    float d[3];
    for (int l = 0; l < 3; ++l)
      d[l] = (bp[l] + fminf(fmaxf(q[l] - bp[l], -bs[l]), bs[l])) - ce[l];
    float da = d[0] * a[0] + d[1] * a[1] + d[2] * a[2];
    float dp[3];
    for (int l = 0; l < 3; ++l) dp[l] = d[l] - da * a[l];
    float dn = sqrtf(dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2]);
    float dsafe = fmaxf(dn, 1e-9f);
    for (int l = 0; l < 3; ++l)
      q[l] = ce[l] + r * (dn > 1e-9f ? dp[l] / dsafe : fall[l]);
  }
  point_box(q, bp, bs, &out.dist, out.n, out.pos);
}

// Per wheel, what its slots share: center, axis, its two nearest boxes.
struct WheelGeom {
  float c[3], a[3];
  int nb[2];
};

// Per hull: rotation, nearest box to its center, and per vertex its world
// position and its plane and box scores (distance minus the vertex bias).
struct HullGeom {
  float R[9];
  int nb;
  float v[NHULLV][3];
  float plane_score[NHULLV];
  float box_score[NHULLV];
};

// Item i of NWHEEL + NHULL: a wheel's center and axis, or a hull's
// rotation, and the nearest boxes to the wheel's or the hull's center (one
// nearest_boxes call that wheel and hull lanes share).
HD void geom_item(int i, const float (*xpos)[3], const float (*xquat)[4],
                  WheelGeom* wg, HullGeom* hg) {
  const K1Const& C = g_k1;
  bool wheel = i < NWHEEL;
  int h = i - NWHEEL;
  int b = wheel ? C.wheel_body[i] : C.hull_body[h];
  float ctr[3];
  if (wheel) {
    WheelGeom& o = wg[i];
    qrot(xquat[b], C.wheel_pos[i], o.c);
    for (int k = 0; k < 3; ++k) ctr[k] = o.c[k] = xpos[b][k] + o.c[k];
    qrot(xquat[b], C.wheel_axis[i], o.a);
  } else {
    qmat(xquat[b], hg[h].R);
    qrot(xquat[b], C.hull_center[h], ctr);
    for (int k = 0; k < 3; ++k) ctr[k] = xpos[b][k] + ctr[k];
  }
  int best = 0, second = 0;
  if (c_k1.nbox > 0) nearest_boxes(ctr, &best, &second);
  if (wheel) {
    wg[i].nb[0] = best;
    wg[i].nb[1] = second;
  } else {
    hg[h].nb = best;
  }
}

// Hull i's vertex kv in the world, and its scores.
HD void hull_vertex(int i, int kv, const float (*xpos)[3], float plane_z,
                    HullGeom& o) {
  const K1Const& C = g_k1;
  const float* l = C.hull_verts[i][kv];
  const float* xp = xpos[C.hull_body[i]];
  const float* R = o.R;
  float v[3];
  for (int r = 0; r < 3; ++r) {
    v[r] = xp[r] + (R[3 * r] * l[0] + R[3 * r + 1] * l[1] +
                    R[3 * r + 2] * l[2]);
    o.v[kv][r] = v[r];
  }
  float bias = C.hull_bias[i][kv];
  o.plane_score[kv] = (v[2] - plane_z) - bias;
  float score = K1_INF;
  if (c_k1.nbox > 0) {
    float d, n[3], cp[3];
    point_box(v, C.box_pos[o.nb], C.box_size[o.nb], &d, n, cp);
    score = d - bias;
  }
  o.box_score[kv] = score;
}

// Contact slot s in the kernel's fixed layout: per wheel 4 plane slots,
// then per wheel 4 box slots (2 nearest boxes x 2 disc ends), then per
// hull 4 plane and 4 box quadrant slots (the deepest vertex of each
// body-frame xy quadrant; the lowest vertex index wins a tie).  Slots a
// scene cannot fill get a positive distance, which leaves them inactive.
HD void collide_slot(int s, const WheelGeom* wg, const HullGeom* hg,
                     float plane_z, Slot& out) {
  const K1Const& C = g_k1;
  out.dist = 1.0f;
  if (s < 4 * NWHEEL) {  // wheel vs plane: two rim candidates + the
    int w = s / 4, e = s % 4;  // deep-face +-120 degree pair
    const float *c = wg[w].c, *a = wg[w].a;
    float r = C.wheel_size[w][0], h = C.wheel_size[w][1];
    float az = a[2];
    float proj[3] = {-(az * a[0]), -(az * a[1]), 1.0f - az * a[2]};
    float pn = sqrtf(proj[0] * proj[0] + proj[1] * proj[1] +
                     proj[2] * proj[2]);
    float pns = fmaxf(pn, 1e-9f);
    // degenerate fallback -x: deepest candidate at +x (MuJoCo's pick)
    float rd[3] = {pn > 1e-9f ? proj[0] / pns : -1.0f,
                   pn > 1e-9f ? proj[1] / pns : 0.0f,
                   pn > 1e-9f ? proj[2] / pns : 0.0f};
    float p[3];
    if (e < 2) {
      float sh = (e == 0 ? -1.0f : 1.0f) * h;
      for (int k = 0; k < 3; ++k) p[k] = (c[k] + sh * a[k]) - r * rd[k];
    } else {
      float deep = h * (az > 0.0f ? -1.0f : 1.0f);
      float dc[3], t[3];
      for (int k = 0; k < 3; ++k) dc[k] = c[k] + deep * a[k];
      v3cross(a, rd, t);
      float ss = e == 2 ? -0.86602540378443865f : 0.86602540378443865f;
      for (int k = 0; k < 3; ++k)
        p[k] = dc[k] + r * (0.5f * rd[k] + ss * t[k]);
    }
    plane_slot(p, plane_z, out);
  } else if (s < 8 * NWHEEL) {  // wheel vs its 2 nearest boxes
    int k = s - 4 * NWHEEL;
    int w = k / 4, ci = (k % 4) / 2, e = k % 2;
    int ncand = c_k1.nbox < 2 ? c_k1.nbox : 2;
    if (ci < ncand)
      cylinder_box_end(wg[w].c, wg[w].a, C.wheel_size[w][0],
                       C.wheel_size[w][1], wg[w].nb[ci], e, out);
  } else {  // hull quadrants vs the plane, then vs the nearest box
    int k = s - 8 * NWHEEL;
    int i = k / 8, qd = k % 4;
    bool box = (k % 8) >= 4;
    if (box && c_k1.nbox == 0) return;
    const HullGeom& o = hg[i];
    const float* score = box ? o.box_score : o.plane_score;
    uint64_t quad = C.hull_quad[i][qd];
    float best = K1_INF;
    int kb = -1;
    for (int kv = 0; kv < NHULLV; ++kv) {
      if (!((quad >> kv) & 1ull)) continue;
      if (score[kv] < best) {
        best = score[kv];
        kb = kv;
      }
    }
    if (!box) {
      if (kb >= 0) plane_slot(o.v[kb], plane_z, out);
    } else if (best < K1_INF) {
      point_box(o.v[kb], C.box_pos[o.nb], C.box_size[o.nb], &out.dist,
                out.n, out.pos);
    }
  }
}

// MuJoCo's impedance d(r) of one solimp.
HD float impedance(const Imp& p, float r) {
  float x = fminf(fmaxf(fabsf(r) / p.width, 0.0f), 1.0f);
  float y;
  if (x <= p.mid) {
    float xp = x;
    if (p.ipower > 0)
      for (int i = 1; i < p.ipower; ++i) xp = xp * x;
    else
      xp = powf(x, p.power);
    y = p.a * xp;
  } else {
    float u = 1.0f - x, up = u;
    if (p.ipower > 0)
      for (int i = 1; i < p.ipower; ++i) up = up * u;
    else
      up = powf(u, p.power);
    y = 1.0f - p.b * up;
  }
  return p.d0 + y * p.dmm;
}

// One beam of the scan of K1: site i given its body's frame.  The site's
// constants are per lane (g_k1), the box loop reads one address for the
// whole warp (c_k1); the arithmetic is lidar.cuh's lidar_site.
HD float k1_beam(int i, const float* bp, const float* bq, float plane_z) {
  const LidarConst& L = g_k1.lidar;
  float o[3], q[4];
  qrot(bq, L.site_pos[i], o);
  for (int k = 0; k < 3; ++k) o[k] = bp[k] + o[k];
  qmul(bq, L.site_quat[i], q);
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float d[3] = {2.0f * (x * z + w * y), 2.0f * (y * z - w * x),
                1.0f - 2.0f * (x * x + y * y)};
  return lidar_beam(c_k1.lidar, o, d, L.cutoff[i], plane_z);
}
