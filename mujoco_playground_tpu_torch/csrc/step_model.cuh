// Kernel K1's model constants and its smooth-dynamics and collision stages,
// for one env per thread (see step_kernel.cu for the kernel itself).
//
// Each function is the dense counterpart of a lane stage of ops/step.py
// (fk_lanes, motion_subspace_lanes, spatial_inertia_lanes, crba_bias_lanes,
// actuator_lanes, collide_lanes, joint_rows_lanes, contact_rows_lanes):
// where the plain twin drops the model's static zeros while it builds its
// program, these loops multiply by them.
#pragma once

#include "lidar.cuh"

#define JNT_FREE 0
#define JNT_HINGE 1
#define JNT_SLIDE 2
#define ROW_EQ 0
#define ROW_FRICTION 1
#define ROW_CONE 2
#define K1_INF 1e30f  // running-min sentinel of the nearest-box/vertex picks

#ifdef __CUDACC__
#define NOINLINE __device__ __noinline__
#else
#define NOINLINE static
#endif

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
  float mask[NBODY][NV];
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
};

KCONST K1Const c_k1;

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
// column b of dr; row r is read where it is used (coalesced across the
// warp, cached in L1) rather than held in 85 registers.
template <bool DR>
struct DRP {};
template <>
struct DRP<true> {
  const float* p;  // dr + b
  long B;
};

// Parameter row `row` of the env under DR, else the model's value `base`.
template <bool DR>
HD float param(const DRP<DR>& d, int row, float base) {
  if constexpr (DR) return d.p[row * d.B];
  else return base;
}

// ---------------------------------------------------------------- kinematics

HD void fk(const float* q, float (*xpos)[3], float (*xquat)[4]) {
  const K1Const& C = c_k1;
  for (int k = 0; k < 3; ++k) xpos[0][k] = 0.0f;
  xquat[0][0] = 1.0f;
  xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
  for (int b = 1; b < NBODY; ++b) {
    int p = C.body_parent[b];
    float pos[3], quat[4], r[3];
    qrot(xquat[p], C.body_pos[b], r);
    for (int k = 0; k < 3; ++k) pos[k] = xpos[p][k] + r[k];
    qmul(xquat[p], C.body_quat[b], quat);
    for (int j = 0; j < NJNT; ++j) {
      if (C.jnt_body[j] != b) continue;
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
        float half = theta * 0.5f;
        float s = sinf(half);
        float aa[4] = {cosf(half), ax[0] * s, ax[1] * s, ax[2] * s};
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
}

// S[v] = (angular, linear) motion of dof v about anchor.
HD void motion_subspace(const float (*xpos)[3], const float (*xquat)[4],
                        const float* anchor, float (*S)[6]) {
  const K1Const& C = c_k1;
  for (int j = 0; j < NJNT; ++j) {
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
}

// 6x6 spatial inertia of body b about anchor.
template <bool DR>
HD void spatial_inertia(int b, const float* xpos_b, const float* xquat_b,
                        const float* anchor, float (*I6)[6],
                        const DRP<DR>& dr) {
  const K1Const& C = c_k1;
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

// Rows k of the body Jacobian J_b (6 x NV): S masked by b's ancestor dofs.
HD void body_jacobian(int b, const float (*S)[6], float (*J)[NV]) {
  for (int k = 0; k < 6; ++k)
    for (int v = 0; v < NV; ++v)
      J[k][v] = c_k1.mask[b][v] != 0.0f ? S[v][k] : 0.0f;
}

HD void mat6_vec(const float (*A)[6], const float* x, float* y) {
  for (int k = 0; k < 6; ++k) {
    float s = 0.0f;
    for (int l = 0; l < 6; ++l) s = s + A[k][l] * x[l];
    y[k] = s;
  }
}

// Mass matrix by CRBA (sum_b J_b^T I_b J_b + armature) and bias forces by
// RNEA, about anchor = the chassis origin.
template <bool DR>
NOINLINE void crba_bias(const float (*xpos)[3], const float (*xquat)[4],
                        const float* vel, const float (*S)[6],
                        const float* anchor, float (*M)[NV], float* fbias,
                        DRP<DR> dr) {
  const K1Const& C = c_k1;
  float J[6][NV], IJ[6][NV], I6[6][6];
  float vbody[NBODY][6];
  for (int v = 0; v < NV; ++v)
    for (int w = 0; w < NV; ++w) M[v][w] = 0.0f;
  for (int b = 0; b < NBODY; ++b) {
    for (int k = 0; k < 6; ++k) vbody[b][k] = 0.0f;
    if (!C.body_inert[b]) continue;
    body_jacobian(b, S, J);
    spatial_inertia(b, xpos[b], xquat[b], anchor, I6, dr);
    for (int k = 0; k < 6; ++k)
      for (int v = 0; v < NV; ++v) {
        float s = 0.0f;
        for (int l = 0; l < 6; ++l) s = s + I6[k][l] * J[l][v];
        IJ[k][v] = s;
      }
    for (int v = 0; v < NV; ++v)
      for (int w = v; w < NV; ++w) {
        float s = M[v][w];
        for (int k = 0; k < 6; ++k) s = s + J[k][v] * IJ[k][w];
        M[v][w] = s;
      }
    for (int k = 0; k < 6; ++k) {
      float s = 0.0f;
      for (int v = 0; v < NV; ++v) s = s + J[k][v] * vel[v];
      vbody[b][k] = s;
    }
  }
  for (int v = 0; v < NV; ++v) {
    for (int w = 0; w < v; ++w) M[v][w] = M[w][v];
    M[v][v] = M[v][v] + param(dr, DR_DOF_ARMATURE + v, C.dof_armature[v]);
  }

  // velocity-product accelerations of the carried (non-free-translation)
  // dofs: (vbody of the dof's body) x S[d] * qvel[d]
  float cdot[NV][6];
  for (int d = 0; d < NV; ++d) {
    int db = C.dof_body[d];
    if (C.dof_carried[d] && C.body_inert[db]) {
      const float* vb = vbody[db];
      const float* s = S[d];
      float mc[6], t[3];
      v3cross(vb, s, mc);
      v3cross(vb + 3, s, mc + 3);
      v3cross(vb, s + 3, t);
      for (int k = 0; k < 3; ++k) mc[3 + k] = mc[3 + k] + t[k];
      for (int k = 0; k < 6; ++k) cdot[d][k] = mc[k] * vel[d];
    } else {
      for (int k = 0; k < 6; ++k) cdot[d][k] = 0.0f;
    }
  }
  for (int v = 0; v < NV; ++v) fbias[v] = 0.0f;
  for (int b = 0; b < NBODY; ++b) {
    if (!C.body_inert[b]) continue;
    body_jacobian(b, S, J);
    spatial_inertia(b, xpos[b], xquat[b], anchor, I6, dr);
    float ab[6], Iv[6], Ia[6], fc[6], t[3];
    for (int k = 0; k < 6; ++k) {
      float s = k < 3 ? 0.0f : -C.gravity[k - 3];
      for (int v = 0; v < NV; ++v)
        if (C.mask[b][v] != 0.0f) s = s + cdot[v][k];
      ab[k] = s;
    }
    mat6_vec(I6, vbody[b], Iv);
    mat6_vec(I6, ab, Ia);
    // force cross product vbody x* (I vbody)
    v3cross(vbody[b], Iv, fc);
    v3cross(vbody[b] + 3, Iv + 3, t);
    for (int k = 0; k < 3; ++k) fc[k] = fc[k] + t[k];
    v3cross(vbody[b], Iv + 3, fc + 3);
    for (int v = 0; v < NV; ++v) {
      float s = fbias[v];
      for (int k = 0; k < 6; ++k) s = s + J[k][v] * (Ia[k] + fc[k]);
      fbias[v] = s;
    }
  }
}

// ctrl -> generalized actuator force per dof.
template <bool DR>
HD void actuator_force(const float* q, const float* vel, const float* ctrl,
                       float* out, const DRP<DR>& dr) {
  const K1Const& C = c_k1;
  for (int v = 0; v < NV; ++v) out[v] = 0.0f;
  for (int u = 0; u < NU; ++u) {
    int d = C.act_dof[u];
    float c = fminf(fmaxf(ctrl[u], C.act_ctrlrange[u][0]),
                    C.act_ctrlrange[u][1]);
    float gain = param(dr, DR_ACT_GAIN + u, C.act_gain[u]);
    float b0 = param(dr, DR_ACT_BIAS + 3 * u, C.act_bias[u][0]);
    float b1 = param(dr, DR_ACT_BIAS + 3 * u + 1, C.act_bias[u][1]);
    float b2 = param(dr, DR_ACT_BIAS + 3 * u + 2, C.act_bias[u][2]);
    float f = gain * c + b0 + b1 * q[C.act_qadr[u]] + b2 * vel[d];
    f = fminf(fmaxf(f, C.act_forcerange[u][0]), C.act_forcerange[u][1]);
    out[d] = out[d] + f;
  }
}

// Solve H x = g (SPD) by a Cholesky factorization in the model's
// leaves-first elimination order (wheel-chain dofs before the free joint).
HD void chol_solve(const float (*H)[NV], const float* g, float* x) {
  const int* p = c_k1.order;
  float L[NV][NV], y[NV], z[NV];
  for (int j = 0; j < NV; ++j) {
    float s[NV];
    for (int i = j; i < NV; ++i) {
      float t = H[p[i]][p[j]];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      s[i] = t;
    }
    float d = rsqrtf(fmaxf(s[j], 1e-30f));
    for (int i = j; i < NV; ++i) L[i][j] = s[i] * d;
  }
  for (int i = 0; i < NV; ++i) {
    float t = g[p[i]];
    for (int k = 0; k < i; ++k) t = t - L[i][k] * y[k];
    y[i] = t / L[i][i];
  }
  for (int i = NV - 1; i >= 0; --i) {
    float t = y[i];
    for (int k = i + 1; k < NV; ++k) t = t - L[k][i] * z[k];
    z[i] = t / L[i][i];
  }
  for (int i = 0; i < NV; ++i) x[p[i]] = z[i];
}

// ----------------------------------------------------------------- collision

// One contact candidate: point, frame rows (normal, t1, t2), distance.
struct Slot {
  float pos[3];
  float frame[9];
  float dist;
};

HD void plane_slot(const float* p, float plane_z, Slot& s) {
  float dist = p[2] - plane_z;
  s.pos[0] = p[0];
  s.pos[1] = p[1];
  s.pos[2] = p[2] - 0.5f * dist;
  s.dist = dist;
  for (int k = 0; k < 9; ++k) s.frame[k] = c_k1.plane_frame[k];
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

// Cylinder (center c, unit axis a, radius r, half-height h) vs box k: one
// candidate per disc end, the rim point nearest the box (two fixed-point
// iterations), collided as a point.
HD void cylinder_box(const float* c, const float* a, float r, float h, int k,
                     Slot* out) {
  const float* bp = c_k1.box_pos[k];
  const float* bs = c_k1.box_size[k];
  float fx[3] = {1.0f - a[0] * a[0], -(a[0] * a[1]), -(a[0] * a[2])};
  float fy[3] = {-(a[1] * a[0]), 1.0f - a[1] * a[1], -(a[1] * a[2])};
  float fxn = sqrtf(fx[0] * fx[0] + fx[1] * fx[1] + fx[2] * fx[2]);
  float fall[3];
  for (int l = 0; l < 3; ++l) fall[l] = fxn > 0.1f ? fx[l] : fy[l];
  float fn = fmaxf(sqrtf(fall[0] * fall[0] + fall[1] * fall[1] +
                         fall[2] * fall[2]), 1e-12f);
  for (int l = 0; l < 3; ++l) fall[l] = fall[l] / fn;
  for (int e = 0; e < 2; ++e) {
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
    float n[3];
    point_box(q, bp, bs, &out[e].dist, n, out[e].pos);
    make_frame(n, out[e].frame);
  }
}

// All NSLOT contact slots in the kernel's fixed layout: per wheel 4 plane
// slots, then per wheel 4 box slots (2 nearest boxes x 2 disc ends), then
// per hull 4 plane and 4 box quadrant slots.  Slots a scene cannot fill get
// a positive distance, which leaves them inactive.
template <bool DR>
NOINLINE void collide(const float (*xpos)[3], const float (*xquat)[4],
                      Slot* slots, DRP<DR> dr) {
  const K1Const& C = c_k1;
  const float plane_z = param(dr, DR_PLANE_Z, C.lidar.plane_z);
  for (int s = 0; s < NSLOT; ++s) slots[s].dist = 1.0f;
  for (int w = 0; w < NWHEEL; ++w) {
    int b = C.wheel_body[w];
    float c[3], a[3];
    qrot(xquat[b], C.wheel_pos[w], c);
    for (int k = 0; k < 3; ++k) c[k] = xpos[b][k] + c[k];
    qrot(xquat[b], C.wheel_axis[w], a);
    float r = C.wheel_size[w][0], h = C.wheel_size[w][1];

    // wheel vs plane: two rim candidates + the deep-face +-120 degree pair
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
    for (int e = 0; e < 2; ++e) {
      float sh = (e == 0 ? -1.0f : 1.0f) * h;
      for (int k = 0; k < 3; ++k) p[k] = (c[k] + sh * a[k]) - r * rd[k];
      plane_slot(p, plane_z, slots[4 * w + e]);
    }
    float deep = h * (az > 0.0f ? -1.0f : 1.0f);
    float dc[3], t[3];
    for (int k = 0; k < 3; ++k) dc[k] = c[k] + deep * a[k];
    v3cross(a, rd, t);
    for (int e = 0; e < 2; ++e) {
      float ss = e == 0 ? -0.86602540378443865f : 0.86602540378443865f;
      for (int k = 0; k < 3; ++k)
        p[k] = dc[k] + r * (0.5f * rd[k] + ss * t[k]);
      plane_slot(p, plane_z, slots[4 * w + 2 + e]);
    }

    // wheel vs its 2 nearest boxes
    if (C.nbox > 0) {
      int nb[2];
      nearest_boxes(c, &nb[0], &nb[1]);
      int ncand = C.nbox < 2 ? C.nbox : 2;
      for (int ci = 0; ci < ncand; ++ci)
        cylinder_box(c, a, r, h, nb[ci], slots + 4 * NWHEEL + 4 * w + 2 * ci);
    }
  }

  // chassis hulls: the deepest vertex per body-frame xy quadrant, vs the
  // plane and vs the nearest box
  for (int i = 0; i < NHULL; ++i) {
    int b = C.hull_body[i];
    float R[9];
    qmat(xquat[b], R);
    float verts[NHULLV][3];
    for (int kv = 0; kv < NHULLV; ++kv) {
      const float* l = C.hull_verts[i][kv];
      for (int r = 0; r < 3; ++r)
        verts[kv][r] = xpos[b][r] +
                       (R[3 * r] * l[0] + R[3 * r + 1] * l[1] +
                        R[3 * r + 2] * l[2]);
    }
    Slot* hs = slots + 8 * NWHEEL + 8 * i;
    for (int qd = 0; qd < 4; ++qd) {
      uint64_t quad = C.hull_quad[i][qd];
      float best = K1_INF;
      int kb = -1;
      for (int kv = 0; kv < NHULLV; ++kv) {
        if (!((quad >> kv) & 1ull)) continue;
        float score = (verts[kv][2] - plane_z) - C.hull_bias[i][kv];
        if (score < best) {
          best = score;
          kb = kv;
        }
      }
      if (kb >= 0) plane_slot(verts[kb], plane_z, hs[qd]);
    }
    if (C.nbox > 0) {
      float ctr[3];
      qrot(xquat[b], C.hull_center[i], ctr);
      for (int k = 0; k < 3; ++k) ctr[k] = xpos[b][k] + ctr[k];
      int nb, unused;
      nearest_boxes(ctr, &nb, &unused);
      for (int qd = 0; qd < 4; ++qd) {
        uint64_t quad = C.hull_quad[i][qd];
        float best = K1_INF, bd = 0.0f, bn[3] = {0, 0, 0}, bpos[3] = {0, 0, 0};
        for (int kv = 0; kv < NHULLV; ++kv) {
          if (!((quad >> kv) & 1ull)) continue;
          float d, n[3], cp[3];
          point_box(verts[kv], C.box_pos[nb], C.box_size[nb], &d, n, cp);
          float score = d - C.hull_bias[i][kv];
          if (score < best) {
            best = score;
            bd = d;
            for (int k = 0; k < 3; ++k) {
              bn[k] = n[k];
              bpos[k] = cp[k];
            }
          }
        }
        Slot& s = hs[4 + qd];
        if (best < K1_INF) {
          s.dist = bd;
          for (int k = 0; k < 3; ++k) s.pos[k] = bpos[k];
          make_frame(bn, s.frame);
        }
      }
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
