// Kernel K1's constraint rows and its Newton solve, split across the lanes
// of the env's group.
//
// Dense counterpart of ops/newton.py newton_body: fixed-iteration Newton on
// MuJoCo's soft-constraint primal (pyramidal friction cones), an exact
// Newton line search on the piecewise-quadratic restriction, and the
// leaves-first Cholesky of step_model.cuh.  Every sum runs in the twin's
// order, so a row that sits on its kink (a stiff contact's pyramid edge, a
// friction row's bound) is classified as the twin classifies it.  Contact
// slots that are not in contact (dist >= 0) carry zero force, zero Hessian
// weight and zero cost, so they are dropped while the rows are assembled:
// only the active rows enter the iterations.
#pragma once

#include "step_model.cuh"

// One joint row: G has at most two entries (g1 at dof d1, g2 at dof d2).
struct JRow {
  float g1, g2, aref, rinv, floss, active;
};

// One active contact slot: the Jacobians of its normal and two tangents
// over the dofs that move its body (column dof_col(dofs, v) is dof v; the
// others are zero), the reference accelerations of its 4 pyramid edges,
// 1/R and friction.
struct CRow {
  float J[3][NBDOF];
  float aref4[4];
  float rinv, mu;
  uint32_t dofs;  // the dofs that move its body, as bits, and ROW_RUN
};

// Set in a row's dofs where it opens a run (K1Const slot_run): the sums
// over the contact rows (the Hessian's entries, J^T f, the line search's
// slopes) add each run's rows into a partial that joins the total when the
// run ends, as the twin adds each run's stack row after row (ops/newton.py
// rowsum), so the two give the same bits.
#define ROW_RUN (1u << 31)
static_assert(NV < 31, "ROW_RUN shares the bits of CRow::dofs");
// the line search adds each run's rows on a lane of its own, and keeps the
// run's partial in cw[run][2..3]: at most NRUN runs (the slot layout's
// runs of one body: a wheel's plane slots, its box slots, a hull's)
#define NRUN (2 * NWHEEL + NHULL)
static_assert(NRUN <= K1_G && NRUN <= NSLOT, "a run a lane and a cw row");

template <bool DR>
HD void joint_row(int r, const float* q, const float* vel, JRow& o,
                  const DRP<DR>& dr) {
  const K1Const& C = g_k1;
  const Imp& imp = C.jr_imp[r];
  int d1 = C.jr_dof1[r];
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

// The row of active slot s (sl.dist < 0).  Under DR a wheel slot's
// friction is max(the env's wheel friction, the plane's), and its diagonal
// approximation iw 2 mu^2 (1 + mu^2) follows it.
template <bool DR>
HD void contact_row(int s, const Slot& sl, const float (*S)[6],
                    const float* anchor, const float* vel, CRow& o,
                    const DRP<DR>& dr) {
  const K1Const& C = g_k1;
  float dist = sl.dist;
  int body = C.slot_body[s];
  float arm[3];
  for (int k = 0; k < 3; ++k) arm[k] = sl.pos[k] - anchor[k];
  float vr[3] = {0.0f, 0.0f, 0.0f};
  uint32_t dofs = C.body_dofs[body];
  o.dofs = dofs;
  float frame[9];
  make_frame(sl.n, frame);
  int c = 0;
  for (uint32_t m = dofs; m; m &= m - 1u, ++c) {
    int v = lowest_bit(m);
    float jp[3];
    v3cross(S[v], arm, jp);
    for (int k = 0; k < 3; ++k) jp[k] = S[v][3 + k] + jp[k];
    for (int r = 0; r < 3; ++r) o.J[r][c] = v3dot(jp, frame + 3 * r);
    for (int r = 0; r < 3; ++r) vr[r] = vr[r] + o.J[r][c] * vel[v];
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

HD float jrow_apply(int r, const JRow& o, const float* a) {
  int d1 = g_k1.jr_dof1[r], d2 = g_k1.jr_dof2[r];
  if (g_k1.jr_kind[r] != ROW_EQ) return o.g1 * a[d1];
  return d1 < d2 ? o.g1 * a[d1] + o.g2 * a[d2] : o.g2 * a[d2] + o.g1 * a[d1];
}

// The 4 pyramid-edge values of row o applied to a.
HD void crow_apply(const CRow& o, const float* a, float* x4) {
  float an = 0.0f, at1 = 0.0f, at2 = 0.0f;
  int c = 0;
  for (uint32_t m = o.dofs & ~ROW_RUN; m; m &= m - 1u, ++c) {
    int v = lowest_bit(m);
    an = an + o.J[0][c] * a[v];
    at1 = at1 + o.J[1][c] * a[v];
    at2 = at2 + o.J[2][c] * a[v];
  }
  x4[0] = an + o.mu * at1;
  x4[1] = an - o.mu * at1;
  x4[2] = an + o.mu * at2;
  x4[3] = an - o.mu * at2;
}

// Force and Hessian weight of joint row r at constraint value x.
HD void joint_force(int r, const JRow& o, float x, float* f, float* q) {
  float raw = -x * o.rinv;
  int kind = g_k1.jr_kind[r];
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

#define NOFF (NV * (NV - 1) / 2)  // entries above an NV x NV diagonal

// Item `item` of a stage over an NV x NV symmetric matrix's upper triangle
// (the entries above the diagonal first, then the diagonal): its (v, w),
// v <= w.
HD void sym_entry(int item, int* v, int* w) {
  bool diag = item >= NOFF;
  *v = diag ? item - NOFF : g_k1.off_v[item];
  *w = diag ? item - NOFF : g_k1.off_w[item];
}

// The Newton solve's scratch.  Per contact row, cw holds the pyramid's
// normal and tangent forces (fn, ft1, ft2) and its Hessian weights (W00,
// W01, W02, W11, W22).
struct NewtonWs {                // 4,064 B
  Chol ch;                       // the Hessian and gradient    624 B
  float xj[NJROW], jf[NJROW], jw[NJROW], jdj[NJROW];  //        176 B
  float x4[NSLOT][4], jd4[NSLOT][4];  // per row and edge     1,536 B
  float cw[NSLOT][8];            // per row                   1,536 B
  float diff[NV], mdiff[NV], delta[NV], md[NV];  //             192 B
};

// The Newton solve: qacc a from the warm start a0 (or, with WS_COMPARE,
// from the cheaper of a0 and a_s by primal cost: MuJoCo's mj_warmstart
// pick).  Per iteration: the rows' values, forces and weights (one item per
// row); the Hessian's upper entries and J^T f per dof (one item each); the
// group's Cholesky; the search direction's row values; the line search,
// whose sums run in the twin's order (the joint rows one by one, then each
// run's partial, the partials on a lane each), so the iterate is the
// twin's.
template <bool WS_COMPARE>
HD void group_newton(const Grp& g, const float (*M)[NV], const float* a_s,
                     const float* a0, const JRow* jr, const CRow* cr, int nc,
                     float* a, NewtonWs& s) {
  const K1Const& C = c_k1;
  // (a0 may share the union with s: it is read only here)
  stage(g, [&](int lane) {
    bool use_ws = !WS_COMPARE || primal_cost(M, a_s, jr, cr, nc, a0, true) <
                                     primal_cost(M, a_s, jr, cr, nc, a_s, false);
    FOR_ITEMS(v, lane, NV) a[v] = use_ws ? a0[v] : a_s[v];
  });
  // the contact rows' runs (ROW_RUN): lane k keeps run k's first row and
  // its count, every lane the number of runs
  struct {
    PerLane<int> lo, n;
    int count;
  } runs;
  runs.count = 0;
  lanes(g, [&](int lane) {
    int k = -1, lo = 0, n = 0;
    for (int i = 0; i < nc; ++i) {
      if (cr[i].dofs & ROW_RUN) ++k;
      if (k == lane) {
        lo = n == 0 ? i : lo;
        ++n;
      }
    }
    runs.lo.at(lane) = lo;
    runs.n.at(lane) = n;
    runs.count = k + 1;
  });
  for (int it = 0; it < C.iterations; ++it) {
    // the rows at a: values, forces and Hessian weights
    stage(g, [&](int lane) {
      FOR_ITEMS(item, lane, NJROW + nc + NV) {
        if (item < NJROW) {
          const JRow& o = jr[item];
          float x = jrow_apply(item, o, a) - o.aref;
          float f, q;
          joint_force(item, o, x, &f, &q);
          s.xj[item] = x;
          s.jf[item] = f;
          s.jw[item] = q * o.rinv;
        } else if (item < NJROW + nc) {
          int i = item - NJROW;
          const CRow& o = cr[i];
          float p4[4], f4[4], w4[4];
          crow_apply(o, a, p4);
          for (int k = 0; k < 4; ++k) {
            float x = p4[k] - o.aref4[k];
            s.x4[i][k] = x;
            f4[k] = fmaxf(-x * o.rinv, 0.0f);
            w4[k] = (x < 0.0f ? 1.0f : 0.0f) * o.rinv;
          }
          float* cw = s.cw[i];
          cw[0] = f4[0] + f4[1] + f4[2] + f4[3];
          cw[1] = o.mu * (f4[0] - f4[1]);
          cw[2] = o.mu * (f4[2] - f4[3]);
          float w01 = w4[0] + w4[1], w23 = w4[2] + w4[3];
          cw[3] = w01 + w23;
          cw[4] = o.mu * (w4[0] - w4[1]);
          cw[5] = o.mu * (w4[2] - w4[3]);
          cw[6] = o.mu * o.mu * w01;
          cw[7] = o.mu * o.mu * w23;
        } else {
          int v = item - NJROW - nc;
          s.diff[v] = a[v] - a_s[v];
        }
      }
    });
    // the Hessian M + J^T W J (+1e-9 I) into the Cholesky's order, and the
    // gradient -(M (a - a_s) - J^T f).  The entries above the diagonal come
    // first, so that only the last pass runs the per-dof joint-row loops of
    // the diagonal and the gradient.
    stage(g, [&](int lane) {
      const int* pinv = g_k1.order_inv;
      FOR_ITEMS(item, lane, NOFF + 2 * NV) {
        if (item < NOFF + NV) {
          int v, w;
          sym_entry(item, &v, &w);
          float h = M[v][w];
          if (v == w) {
            for (int q = 0; q < DOF_JROWS; ++q) {
              int r = g_k1.dof_jrows[v][q];
              if (r < 0) break;
              float gr = C.jr_dof1[r] == v ? jr[r].g1 : jr[r].g2;
              h = h + gr * s.jw[r] * gr;
            }
          } else {
            // off the diagonal only the two-dof (equality) rows, which lead
            for (int r = 0; r < NEQ; ++r) {
              bool fwd = C.jr_dof1[r] < C.jr_dof2[r];
              int lo = fwd ? C.jr_dof1[r] : C.jr_dof2[r];
              int hi = fwd ? C.jr_dof2[r] : C.jr_dof1[r];
              if (v == lo && w == hi) {
                float glo = fwd ? jr[r].g1 : jr[r].g2;
                float ghi = fwd ? jr[r].g2 : jr[r].g1;
                h = h + glo * s.jw[r] * ghi;
              }
            }
          }
          float run = 0.0f;  // the current run's rows
          for (int i = 0; i < nc; ++i) {
            const CRow& o = cr[i];
            if (o.dofs & ROW_RUN) {
              h = h + run;
              run = 0.0f;
            }
            if (!moves(o.dofs, v) || !moves(o.dofs, w)) continue;
            int cv = dof_col(o.dofs, v), cw_ = dof_col(o.dofs, w);
            float jn = o.J[0][cw_], jt1 = o.J[1][cw_], jt2 = o.J[2][cw_];
            if (jn == 0.0f && jt1 == 0.0f && jt2 == 0.0f) continue;
            const float* cw = s.cw[i];
            float u1 = cw[3] * jn + cw[4] * jt1 + cw[5] * jt2;
            float u2 = cw[4] * jn + cw[6] * jt1;
            float u3 = cw[5] * jn + cw[7] * jt2;
            run = run + (o.J[0][cv] * u1 + o.J[1][cv] * u2 + o.J[2][cv] * u3);
          }
          h = h + run;
          if (v == w) h = h + 1e-9f;
          int pv = pinv[v], pw = pinv[w];
          s.ch.A[pv > pw ? pv : pw][pv > pw ? pw : pv] = h;
        } else {
          int v = item - NOFF - NV;
          float jtf = 0.0f;
          for (int q = 0; q < DOF_JROWS; ++q) {
            int r = g_k1.dof_jrows[v][q];
            if (r < 0) break;
            float f = s.jf[r];
            if (C.jr_dof1[r] == v) jtf = jtf + jr[r].g1 * f;
            if (C.jr_kind[r] == ROW_EQ && C.jr_dof2[r] == v)
              jtf = jtf + jr[r].g2 * f;
          }
          float run = 0.0f;
          for (int i = 0; i < nc; ++i) {
            if (cr[i].dofs & ROW_RUN) {
              jtf = jtf + run;
              run = 0.0f;
            }
            if (!moves(cr[i].dofs, v)) continue;
            const float* cw = s.cw[i];
            const float(*J)[NBDOF] = cr[i].J;
            int c = dof_col(cr[i].dofs, v);
            run = run + (J[0][c] * cw[0] + J[1][c] * cw[1] + J[2][c] * cw[2]);
          }
          jtf = jtf + run;
          float md = 0.0f;
          for (int w = 0; w < NV; ++w) md = md + M[v][w] * s.diff[w];
          s.mdiff[v] = md;
          s.ch.t[pinv[v]] = -(md - jtf);
        }
      }
    });
    group_chol_solve(g, s.ch, s.delta);

    // exact line search on the piecewise-quadratic 1-D restriction
    stage(g, [&](int lane) {
      FOR_ITEMS(item, lane, NJROW + nc + NV) {
        if (item < NJROW) {
          s.jdj[item] = jrow_apply(item, jr[item], s.delta);
        } else if (item < NJROW + nc) {
          crow_apply(cr[item - NJROW], s.delta, s.jd4[item - NJROW]);
        } else {
          int v = item - NJROW - nc;
          float m = 0.0f;
          for (int w = 0; w < NV; ++w) m = m + M[v][w] * s.delta[w];
          s.md[v] = m;
        }
      }
    });
    float dMd = 0.0f, dMas = 0.0f;
    for (int v = 0; v < NV; ++v) {
      dMd = dMd + s.delta[v] * s.md[v];
      dMas = dMas + s.delta[v] * s.mdiff[v];
    }
    float alpha = 1.0f;
    for (int ls = 0; ls < C.ls_iterations; ++ls) {
      // each row's slope and curvature terms at alpha (the joint rows' in
      // jf and jw, the contact rows' in cw[i][0..1]: free since the
      // Hessian), then lane k adds run k's rows in order into cw[k][2..3]
      stage(g, [&](int lane) {
        FOR_ITEMS(item, lane, NJROW + nc) {
          if (item < NJROW) {
            float jd = s.jdj[item], f, q;
            joint_force(item, jr[item], s.xj[item] + alpha * jd, &f, &q);
            s.jf[item] = jd * f;
            s.jw[item] = q * jr[item].rinv * (jd * jd);
          } else {
            int i = item - NJROW;
            float rinv = cr[i].rinv, sd = 0.0f, sdd = 0.0f;
            for (int k = 0; k < 4; ++k) {
              float jd = s.jd4[i][k];
              float x = s.x4[i][k] + alpha * jd;
              float f = fmaxf(-x * rinv, 0.0f);
              float q = x < 0.0f ? 1.0f : 0.0f;
              float td = jd * f, tdd = q * rinv * jd * jd;
              sd = k == 0 ? td : sd + td;
              sdd = k == 0 ? tdd : sdd + tdd;
            }
            s.cw[i][0] = sd;
            s.cw[i][1] = sdd;
          }
        }
      });
      stage(g, [&](int lane) {
        if (lane >= runs.count) return;
        int lo = runs.lo.at(lane), n = runs.n.at(lane);
        float rd = s.cw[lo][0], rdd = s.cw[lo][1];
        for (int i = lo + 1; i < lo + n; ++i) {
          rd = rd + s.cw[i][0];
          rdd = rdd + s.cw[i][1];
        }
        s.cw[lane][2] = rd;
        s.cw[lane][3] = rdd;
      });
      // the sums in the twin's order: the joint rows, then the runs
      float dphi = dMas + alpha * dMd, ddphi = dMd;
      UNROLL for (int r = 0; r < NJROW; ++r) {
        dphi = dphi - s.jf[r];
        ddphi = ddphi + s.jw[r];
      }
      UNROLL for (int k = 0; k < NRUN; ++k) {
        if (k >= runs.count) break;
        dphi = dphi - s.cw[k][2];
        ddphi = ddphi + s.cw[k][3];
      }
      alpha = fminf(fmaxf(alpha - dphi / fmaxf(ddphi, 1e-12f), 0.0f), 2.0f);
    }
    stage(g, [&](int lane) {
      FOR_ITEMS(v, lane, NV) a[v] = a[v] + alpha * s.delta[v];
    });
  }
}
