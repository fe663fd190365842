// Kernel K1's constraint rows and Newton solve, for one env per thread.
//
// Dense counterpart of ops/newton.py newton_body: fixed-iteration Newton on
// MuJoCo's soft-constraint primal (pyramidal friction cones), an exact
// Newton line search on the piecewise-quadratic restriction, and the
// leaves-first Cholesky of step_model.cuh.  Contact slots that are not in
// contact (dist >= 0) carry zero force, zero Hessian weight and zero cost,
// so they are dropped while the rows are assembled: only the active rows
// enter the iterations.
#pragma once

#include "step_model.cuh"

// One joint row: G has at most two entries (g1 at dof d1, g2 at dof d2).
struct JRow {
  float g1, g2, aref, rinv, floss, active;
};

// One active contact slot: the Jacobians of its normal and two tangents,
// the reference accelerations of its 4 pyramid edges, 1/R and friction.
struct CRow {
  float J[3][NV];
  float aref4[4];
  float rinv, mu;
};

template <bool DR>
HD void joint_rows(const float* q, const float* vel, JRow* rows,
                   const DRP<DR>& dr) {
  const K1Const& C = c_k1;
  for (int r = 0; r < NJROW; ++r) {
    const Imp& imp = C.jr_imp[r];
    int d1 = C.jr_dof1[r];
    JRow& o = rows[r];
    o.floss = 0.0f;
    o.active = 1.0f;
    o.g2 = 0.0f;
    if (C.jr_kind[r] == ROW_EQ) {
      const float* c = C.jr_coef[r];
      float q2 = q[C.jr_qadr2[r]] - C.jr_q02[r];
      float q22 = q2 * q2;
      float poly = c[0] + c[1] * q2 + c[2] * q22 + c[3] * (q22 * q2) +
                   c[4] * (q22 * q22);
      float dpoly = c[1] + (2.0f * c[2]) * q2 + (3.0f * c[3]) * q22 +
                    (4.0f * c[4]) * (q22 * q2);
      float pos = (q[C.jr_qadr1[r]] - C.jr_q01[r]) - poly;
      float v = vel[d1] - dpoly * vel[C.jr_dof2[r]];
      float d = impedance(imp, pos);
      o.aref = (-imp.bref) * v - (d / imp.kden) * pos;
      o.rinv = 1.0f / fmaxf((1.0f - d) / d * C.jr_diag[r], 1e-10f);
      o.g1 = 1.0f;
      o.g2 = -dpoly;
    } else if (C.jr_kind[r] == ROW_FRICTION) {
      o.aref = (-imp.bref) * vel[d1];
      o.rinv = C.jr_rinv[r];
      o.floss = param(dr, DR_DOF_FRICTIONLOSS + d1, C.jr_floss[r]);
      o.g1 = 1.0f;
    } else {  // joint limit, one side
      float side = C.jr_side[r];
      float qv = q[C.jr_qadr1[r]];
      float dist = side > 0.0f ? qv - C.jr_limit[r] : C.jr_limit[r] - qv;
      float pos = fminf(dist, 0.0f);
      float d = impedance(imp, pos);
      o.aref = (-imp.bref) * (side * vel[d1]) - (d / imp.kden) * pos;
      o.rinv = 1.0f / fmaxf((1.0f - d) / d * C.jr_diag[r], 1e-10f);
      o.active = dist < 0.0f ? 1.0f : 0.0f;
      o.g1 = side;
    }
  }
}

// Rows of the active slots; returns their count.  Under DR a wheel slot's
// friction is max(the env's wheel friction, the plane's), and its diagonal
// approximation iw 2 mu^2 (1 + mu^2) follows it.
template <bool DR>
HD int contact_rows(const Slot* slots, const float (*S)[6],
                    const float* anchor, const float* vel, CRow* rows,
                    const DRP<DR>& dr) {
  const K1Const& C = c_k1;
  int n = 0;
  for (int s = 0; s < NSLOT; ++s) {
    const Slot& sl = slots[s];
    float dist = sl.dist;
    if (!(dist < 0.0f)) continue;
    CRow& o = rows[n++];
    int body = C.slot_body[s];
    float arm[3];
    for (int k = 0; k < 3; ++k) arm[k] = sl.pos[k] - anchor[k];
    float vr[3] = {0.0f, 0.0f, 0.0f};
    for (int v = 0; v < NV; ++v) {
      if (C.mask[body][v] != 0.0f) {
        float jp[3];
        v3cross(S[v], arm, jp);
        for (int k = 0; k < 3; ++k) jp[k] = S[v][3 + k] + jp[k];
        for (int r = 0; r < 3; ++r) o.J[r][v] = v3dot(jp, sl.frame + 3 * r);
      } else {
        for (int r = 0; r < 3; ++r) o.J[r][v] = 0.0f;
      }
      for (int r = 0; r < 3; ++r) vr[r] = vr[r] + o.J[r][v] * vel[v];
    }
    const Imp& imp = C.slot_imp[s];
    float d = impedance(imp, dist);
    float kc = d / imp.kden;
    float mu = C.slot_mu[s], diag = C.slot_diag[s];
    if constexpr (DR) {
      int w = C.slot_wheel[s];
      if (w >= 0) {
        mu = fmaxf(param(dr, DR_WHEEL_FRICTION + w, 0.0f), C.plane_mu);
        diag = fmaxf(C.slot_iw[s] * 2.0f * (mu * mu) * (1.0f + mu * mu),
                     1e-12f);
      }
    }
    o.mu = mu;
    o.rinv = 1.0f / fmaxf((1.0f - d) / d * diag, 1e-10f);
    float vel4[4] = {vr[0] + mu * vr[1], vr[0] - mu * vr[1],
                     vr[0] + mu * vr[2], vr[0] - mu * vr[2]};
    for (int k = 0; k < 4; ++k) o.aref4[k] = (-imp.bref) * vel4[k] - kc * dist;
  }
  return n;
}

HD float jrow_apply(int r, const JRow& o, const float* a) {
  int d1 = c_k1.jr_dof1[r], d2 = c_k1.jr_dof2[r];
  if (c_k1.jr_kind[r] != ROW_EQ) return o.g1 * a[d1];
  return d1 < d2 ? o.g1 * a[d1] + o.g2 * a[d2] : o.g2 * a[d2] + o.g1 * a[d1];
}

// The 4 pyramid-edge values of row o applied to a.
HD void crow_apply(const CRow& o, const float* a, float* x4) {
  float an = 0.0f, at1 = 0.0f, at2 = 0.0f;
  for (int v = 0; v < NV; ++v) {
    an = an + o.J[0][v] * a[v];
    at1 = at1 + o.J[1][v] * a[v];
    at2 = at2 + o.J[2][v] * a[v];
  }
  x4[0] = an + o.mu * at1;
  x4[1] = an - o.mu * at1;
  x4[2] = an + o.mu * at2;
  x4[3] = an - o.mu * at2;
}

// Force and Hessian weight of joint row r at constraint value x.
HD void joint_force(int r, const JRow& o, float x, float* f, float* q) {
  float raw = -x * o.rinv;
  int kind = c_k1.jr_kind[r];
  if (kind == ROW_EQ) {
    *f = raw;
    *q = 1.0f;
  } else if (kind == ROW_FRICTION) {
    *f = fminf(fmaxf(raw, -o.floss), o.floss);
    *q = fabsf(raw) < o.floss ? 1.0f : 0.0f;
  } else {
    *f = fmaxf(raw, 0.0f);
    *q = raw > 0.0f ? 1.0f : 0.0f;
  }
  *f = *f * o.active;
  *q = *q * o.active;
}

HD void mat_vec(const float (*M)[NV], const float* x, float* y) {
  for (int v = 0; v < NV; ++v) {
    float s = 0.0f;
    for (int w = 0; w < NV; ++w) s = s + M[v][w] * x[w];
    y[v] = s;
  }
}

// Primal cost of the rows at a, plus the smooth quadratic when with_m.
HD float primal_cost(const float (*M)[NV], const float* a_s, const JRow* jr,
                     const CRow* cr, int nc, const float* a, bool with_m) {
  float c = 0.0f;
  for (int r = 0; r < NJROW; ++r) {
    const JRow& o = jr[r];
    float x = jrow_apply(r, o, a) - o.aref;
    float quad = 0.5f * x * x * o.rinv;
    float rc;
    int kind = c_k1.jr_kind[r];
    if (kind == ROW_EQ) {
      rc = quad;
    } else if (kind == ROW_FRICTION) {
      float lin = o.floss * fabsf(x) - 0.5f * o.floss * o.floss / o.rinv;
      rc = fabsf(x) * o.rinv < o.floss ? quad : lin;
    } else {
      rc = x < 0.0f ? quad : 0.0f;
    }
    c = c + rc * o.active;
  }
  for (int i = 0; i < nc; ++i) {
    float x4[4];
    crow_apply(cr[i], a, x4);
    for (int k = 0; k < 4; ++k) {
      float x = x4[k] - cr[i].aref4[k];
      if (x < 0.0f) c = c + 0.5f * x * x * cr[i].rinv;
    }
  }
  if (with_m) {
    float diff[NV], Md[NV];
    for (int v = 0; v < NV; ++v) diff[v] = a[v] - a_s[v];
    mat_vec(M, diff, Md);
    float s = 0.0f;
    for (int v = 0; v < NV; ++v) s = s + diff[v] * Md[v];
    c = c + 0.5f * s;
  }
  return c;
}

// The Newton solve: qacc from the warm start a0 (or, with WS_COMPARE, from
// the cheaper of a0 and a_s by primal cost: MuJoCo's mj_warmstart pick).
template <bool WS_COMPARE>
NOINLINE void newton(const float (*M)[NV], const float* a_s, const float* a0,
                     const JRow* jr, const CRow* cr, int nc, float* a) {
  const K1Const& C = c_k1;
  bool use_ws = true;
  if (WS_COMPARE)
    use_ws = primal_cost(M, a_s, jr, cr, nc, a0, true) <
             primal_cost(M, a_s, jr, cr, nc, a_s, false);
  for (int v = 0; v < NV; ++v) a[v] = use_ws ? a0[v] : a_s[v];

  float xj[NJROW], jdj[NJROW];
  float x4[NSLOT][4], jd4[NSLOT][4];
  float H[NV][NV];
  for (int it = 0; it < C.iterations; ++it) {
    float jtf[NV], diff[NV], Mdiff[NV], grad[NV], delta[NV];
    for (int v = 0; v < NV; ++v) jtf[v] = 0.0f;
    for (int v = 0; v < NV; ++v)
      for (int w = v; w < NV; ++w) H[v][w] = M[v][w];

    // joint rows: values, forces, J^T f and G^T w G
    for (int r = 0; r < NJROW; ++r) {
      const JRow& o = jr[r];
      xj[r] = jrow_apply(r, o, a) - o.aref;
      float f, q;
      joint_force(r, o, xj[r], &f, &q);
      int d1 = C.jr_dof1[r], d2 = C.jr_dof2[r];
      bool two = C.jr_kind[r] == ROW_EQ;
      jtf[d1] = jtf[d1] + o.g1 * f;
      if (two) jtf[d2] = jtf[d2] + o.g2 * f;
      float wr = q * o.rinv;
      int lo = d1, hi = d2;
      float glo = o.g1, ghi = o.g2;
      if (two && d2 < d1) {
        lo = d2;
        hi = d1;
        glo = o.g2;
        ghi = o.g1;
      }
      H[lo][lo] = H[lo][lo] + glo * wr * glo;
      if (two) {
        H[lo][hi] = H[lo][hi] + glo * wr * ghi;
        H[hi][hi] = H[hi][hi] + ghi * wr * ghi;
      }
    }
    // contact rows: values, forces, J^T f and the pyramid Hessian blocks
    for (int i = 0; i < nc; ++i) {
      const CRow& o = cr[i];
      float p4[4], f4[4], w4[4];
      crow_apply(o, a, p4);
      for (int k = 0; k < 4; ++k) {
        x4[i][k] = p4[k] - o.aref4[k];
        f4[k] = fmaxf(-x4[i][k] * o.rinv, 0.0f);
        w4[k] = (x4[i][k] < 0.0f ? 1.0f : 0.0f) * o.rinv;
      }
      float fn = f4[0] + f4[1] + f4[2] + f4[3];
      float ft1 = o.mu * (f4[0] - f4[1]);
      float ft2 = o.mu * (f4[2] - f4[3]);
      for (int v = 0; v < NV; ++v)
        jtf[v] = jtf[v] + (o.J[0][v] * fn + o.J[1][v] * ft1 +
                           o.J[2][v] * ft2);
      float w01 = w4[0] + w4[1], w23 = w4[2] + w4[3];
      float W00 = w01 + w23;
      float W01 = o.mu * (w4[0] - w4[1]);
      float W02 = o.mu * (w4[2] - w4[3]);
      float W11 = o.mu * o.mu * w01;
      float W22 = o.mu * o.mu * w23;
      for (int w = 0; w < NV; ++w) {
        float jn = o.J[0][w], jt1 = o.J[1][w], jt2 = o.J[2][w];
        if (jn == 0.0f && jt1 == 0.0f && jt2 == 0.0f) continue;
        float u1 = W00 * jn + W01 * jt1 + W02 * jt2;
        float u2 = W01 * jn + W11 * jt1;
        float u3 = W02 * jn + W22 * jt2;
        for (int v = 0; v <= w; ++v)
          H[v][w] = H[v][w] + (o.J[0][v] * u1 + o.J[1][v] * u2 +
                               o.J[2][v] * u3);
      }
    }
    for (int v = 0; v < NV; ++v) diff[v] = a[v] - a_s[v];
    mat_vec(M, diff, Mdiff);
    for (int v = 0; v < NV; ++v) grad[v] = -(Mdiff[v] - jtf[v]);
    for (int v = 0; v < NV; ++v) {
      H[v][v] = H[v][v] + 1e-9f;
      for (int w = v + 1; w < NV; ++w) H[w][v] = H[v][w];
    }
    chol_solve(H, grad, delta);

    // exact line search on the piecewise-quadratic 1-D restriction
    for (int r = 0; r < NJROW; ++r) jdj[r] = jrow_apply(r, jr[r], delta);
    for (int i = 0; i < nc; ++i) crow_apply(cr[i], delta, jd4[i]);
    float Md[NV];
    mat_vec(M, delta, Md);
    float dMd = 0.0f, dMas = 0.0f;
    for (int v = 0; v < NV; ++v) {
      dMd = dMd + delta[v] * Md[v];
      dMas = dMas + delta[v] * Mdiff[v];
    }
    float alpha = 1.0f;
    for (int ls = 0; ls < C.ls_iterations; ++ls) {
      float dphi = dMas + alpha * dMd;
      float ddphi = dMd;
      for (int r = 0; r < NJROW; ++r) {
        float f, q;
        joint_force(r, jr[r], xj[r] + alpha * jdj[r], &f, &q);
        dphi = dphi - jdj[r] * f;
        ddphi = ddphi + q * jr[r].rinv * (jdj[r] * jdj[r]);
      }
      for (int i = 0; i < nc; ++i) {
        float sd = 0.0f, sdd = 0.0f;
        for (int k = 0; k < 4; ++k) {
          float jd = jd4[i][k];
          float x = x4[i][k] + alpha * jd;
          float f = fmaxf(-x * cr[i].rinv, 0.0f);
          float q = x < 0.0f ? 1.0f : 0.0f;
          sd = sd + jd * f;
          sdd = sdd + q * cr[i].rinv * jd * jd;
        }
        dphi = dphi - sd;
        ddphi = ddphi + sdd;
      }
      alpha = fminf(fmaxf(alpha - dphi / fmaxf(ddphi, 1e-12f), 0.0f), 2.0f);
    }
    for (int v = 0; v < NV; ++v) a[v] = a[v] + alpha * delta[v];
  }
}
