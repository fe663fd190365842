// Kernel K3: the standalone Newton constraint solve of the staged step.
//
// Replaces the TPU kernel mujoco_playground_tpu/ops/newton_pallas.py
// (newton_solve_pallas -> _newton_kernel): fixed-iteration Newton on
// MuJoCo's soft-constraint primal (pyramidal friction cones), an exact
// Newton line search on the piecewise-quadratic restriction, an NV x NV
// Cholesky in the natural order, and, with a warm start, MuJoCo's two-sided
// mj_warmstart pick.  The whole system arrives from memory, with every dof
// in one dense group (no static sparsity to prune).
//
// I/O is batch-last float32, as ops/newton.py newton_solve takes it: Mt
// (NV, NV, B), a_s (NV, B), j_aref / j_R / j_floss / j_active (nj, B), c_R /
// c_mu / c_active (nc, B), ws (NV, B) or null; out qacc (NV, B); and the
// rows in one of two layouts, each read in place by its own instantiation
// of the kernel (template parameter KL): row-major, G (nj, NV, B), Jn / Jt1
// / Jt2 (nc, NV, B), c_aref (nc, 4, B), as solver_batched.newton_args lays
// them out; or the kernel layout of newton_solve_pallas(pre_transposed=
// True), G (NV, nj, B), Jn / Jt1 / Jt2 (NV, nc, B), c_aref (4, nc, B), as
// physics/constraint_bl.py assembles them.  The layout changes only where
// the loads read (k3_*_row); the block's workspace and everything after the
// loads are the same.  nj and nc are runtime values (nc = 48 on a maze, 72
// with the wheel patch); the joint-row kinds come as bit masks.
//
// What bounds it on an H100: the inputs hold ~13.8 KB per env at nc = 72
// (the dense Jacobians dominate), but an env needs only M, a_s, the warm
// start, the joint rows and the nc active flags (~1.7 KB) and 172 B per row
// in contact; the iterations on those rows are chains of dependent small
// steps, so latency, not bytes, sets the time unless enough envs are in
// flight.
//
// Design.  A block takes K3_ENVS = 8 consecutive envs, a group of K3_G =
// 4 lanes each (group.cuh): a block is one warp, and every instruction
// serves eight envs.  (1) The block copies its envs' M, a_s, warm start,
// joint rows and contact flags into shared memory, env index fastest, by
// asynchronous copies that are all in flight at once.  (2) Each group lists
// its env's rows in contact (active flag != 0, ascending) by a ballot over
// the flags.  (3) The block's pool holds K3_POOL rows in contact (6 per
// env on average; path B has ~2.5).  Env by env, an env takes a window of
// the pool for all its rows if that leaves K3_MIN_WINDOW rows for each env
// after it, else what is left beyond those (at least K3_MIN_WINDOW rows).
// An env whose rows fit copies them in once.  An env whose rows do not fit
// runs them through its window in chunks: at every pass over its rows it
// copies each chunk in and recomputes what a resident row keeps, by the
// same code.  So every env is right up to K3_MAX_NC rows in contact.  Rows
// not in contact carry zero force, Hessian weight and cost, so skipping
// them is exact.  (4) The solve: the rows' values and M (a - a_s), one
// item per row or dof over the lanes; lane l builds rows l, l + 4, l + 8
// of the Hessian and the same entries of the gradient in registers (the
// joint rows that touch each dof, then the rows in contact in order) and a
// register Cholesky factors it there (columns trade by shuffles); the line
// search's sums over rows are per-lane partials added by a fixed
// butterfly.  The iterate and the step live in shared memory.  (5) The
// block writes qacc, env index fastest.  No atomics, so two launches give
// the same bits.  Shared memory caps the blocks on an SM: a pool row keeps
// only its values (a row's forces and weights are recomputed where they
// are used), so that 8 blocks of 28,000 B fit.  The code avoids branches
// that lanes take differently (selects instead).
#include "group.cuh"

#define K3_MAX_NJ 16  // joint rows per env (the robot has 11)
#define K3_MAX_NC 72  // contact rows per env (4x4 wheel-plane, 4x2x5
                      // wheel-box with the patch, 2x8 hull)
#define K3_G 4        // lanes per env
#define K3_ENVS 8     // envs per block
#define K3_THREADS (K3_G * K3_ENVS)
#define K3_POOL (6 * K3_ENVS)  // rows in contact the block holds
#define K3_MIN_WINDOW 2        // pool rows every env is left
// lane l of an env's group holds rows l, l + K3_G, ... of the Hessian and
// its factor: K3_RPL row slots
#define K3_RPL ((NV + K3_G - 1) / K3_G)

typedef Group<K3_G> K3Grp;
typedef PerLaneG<float, K3_G> K3Lane;
typedef PerLaneG<float[K3_RPL], K3_G> K3Slots;  // a value per row slot
typedef PerLaneG<float[K3_RPL][NV], K3_G> K3Rows;

struct K3Args {
  const float *M, *a_s, *G, *j_aref, *j_R, *j_floss, *j_active;
  const float *Jn, *Jt1, *Jt2, *c_aref, *c_R, *c_mu, *c_active, *ws;
  float* qacc;
  long B;
  int nj, nc, iterations, ls_iterations, eq_mask, fric_mask;
};

// One env's system and scratch in shared memory (2,276 B).
struct K3Ws {
  float M[NV][NV];
  float a_s[NV], a0[NV];
  float a[NV], delta[NV];  // the iterate, the step
  float G[K3_MAX_NJ][NV];
  uint32_t dof_rows[NV];  // per dof, the joint rows nonzero there, as bits
  float jaref[K3_MAX_NJ], jrinv[K3_MAX_NJ], jfloss[K3_MAX_NJ],
      jact[K3_MAX_NJ];
  union {
    float cact[K3_MAX_NC];  // the contact rows' active flags, until listed
    struct {
      // per joint row: value at the iterate, force, Hessian weight, value
      // of the step; M (a - a_s), M delta
      float xj[K3_MAX_NJ], jf[K3_MAX_NJ], jw[K3_MAX_NJ], jdj[K3_MAX_NJ];
      float mdiff[NV], md[NV];
    };
  };
  uint8_t idx[K3_MAX_NC];  // the rows in contact, ascending
  int na;                  // their count (0 past the block's last env)
  int off, cap;            // its window of the pool: first row and size
};

// One row in contact in the pool (204 B): the K3_ROWF values read from
// memory (R then replaced by 1/R), then its pyramid values at the iterate
// (x4) and along the step (jd4).
struct K3Row {
  float J[3][NV];
  float aref4[4];
  float rinv, mu, act;
  float x4[4], jd4[4];
};
#define K3_ROWF (3 * NV + 7)

struct K3Block {
  K3Ws env[K3_ENVS];
  K3Row pool[K3_POOL];
};

// Copy one float from global to shared memory without a register: the
// copies of a thread stay in flight together until k3_copy_wait.
HD void k3_copy(float* dst, const float* src) {
#ifdef __CUDACC__
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

HD void k3_copy_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Close the thread's copies so far into a group; wait for all groups but
// the newest.
HD void k3_copy_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
HD void k3_copy_wait_prior() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

HD float k3_dot(const float* x, const float* y) {
  float s = 0.0f;
  UNROLL for (int v = 0; v < NV; ++v) s = s + x[v] * y[v];
  return s;
}

// The 4 pyramid-edge values of a row applied to a.
HD void k3_pyr4(const K3Row& o, const float* a, float* p4) {
  float an = 0.0f, at1 = 0.0f, at2 = 0.0f;
  UNROLL for (int v = 0; v < NV; ++v) {
    an = an + o.J[0][v] * a[v];
    at1 = at1 + o.J[1][v] * a[v];
    at2 = at2 + o.J[2][v] * a[v];
  }
  p4[0] = an + o.mu * at1;
  p4[1] = an - o.mu * at1;
  p4[2] = an + o.mu * at2;
  p4[3] = an - o.mu * at2;
}

// A row's values at the iterate a.
HD void k3_keep_at(K3Row& o, const float* a) {
  float p4[4];
  k3_pyr4(o, a, p4);
  UNROLL for (int k = 0; k < 4; ++k) o.x4[k] = p4[k] - o.aref4[k];
}

// A row's forces and Hessian weights at its values x4: cw = fn, ft1, ft2,
// W00, W01, W02, W11, W22.
HD void k3_weights(const K3Row& o, float* cw) {
  float f4[4], w4[4];
  UNROLL for (int k = 0; k < 4; ++k) {
    float x = o.x4[k];
    f4[k] = fmaxf(-x * o.rinv, 0.0f) * o.act;
    w4[k] = (x < 0.0f ? o.act : 0.0f) * o.rinv;
  }
  cw[0] = f4[0] + f4[1] + f4[2] + f4[3];
  cw[1] = o.mu * (f4[0] - f4[1]);
  cw[2] = o.mu * (f4[2] - f4[3]);
  float w01 = w4[0] + w4[1], w23 = w4[2] + w4[3];
  cw[3] = w01 + w23;
  cw[4] = o.mu * (w4[0] - w4[1]);
  cw[5] = o.mu * (w4[2] - w4[3]);
  cw[6] = o.mu * o.mu * w01;
  cw[7] = o.mu * o.mu * w23;
}

// The row of a B-long slab that holds an entry of the system, in the
// layout KL names (false: row-major; true: the kernel layout).
template <bool KL>
HD long k3_g_row(const K3Args& A, int r, int v) {  // G[r][v]
  return KL ? (long)v * A.nj + r : (long)r * NV + v;
}
template <bool KL>
HD long k3_j_row(const K3Args& A, long c, int v) {  // Jn[c][v], ...
  return KL ? (long)v * A.nc + c : c * NV + v;
}
template <bool KL>
HD long k3_a_row(const K3Args& A, long c, int k) {  // c_aref[c][k]
  return KL ? (long)k * A.nc + c : c * 4 + k;
}

HD int k3_kind(const K3Args& A, int r) {
  return (A.eq_mask >> r) & 1 ? 0 : ((A.fric_mask >> r) & 1 ? 1 : 2);
}

// Force and Hessian weight of joint row r at constraint value x.
HD void k3_joint_force(const K3Args& A, const K3Ws& w, int r, float x,
                       float* f, float* q) {
  float raw = -x * w.jrinv[r];
  float floss = w.jfloss[r];
  int kind = k3_kind(A, r);  // selects, not branches: lanes differ in kind
  float fr = fminf(fmaxf(raw, -floss), floss);
  float qr = fabsf(raw) < floss ? 1.0f : 0.0f;
  float fs = fmaxf(raw, 0.0f), qs = raw > 0.0f ? 1.0f : 0.0f;
  *f = (kind == 0 ? raw : (kind == 1 ? fr : fs)) * w.jact[r];
  *q = (kind == 0 ? 1.0f : (kind == 1 ? qr : qs)) * w.jact[r];
}

// Primal cost of joint row r at vec.
HD float k3_joint_cost(const K3Args& A, const K3Ws& w, int r,
                       const float* vec) {
  float x = k3_dot(w.G[r], vec) - w.jaref[r];
  float rinv = w.jrinv[r], floss = w.jfloss[r];
  float quad = 0.5f * x * x * rinv;
  float rc;
  int kind = k3_kind(A, r);
  if (kind == 0) {
    rc = quad;
  } else if (kind == 1) {
    float lin = floss * fabsf(x) - 0.5f * floss * floss / rinv;
    rc = fabsf(x) * rinv < floss ? quad : lin;
  } else {
    rc = x < 0.0f ? quad : 0.0f;
  }
  return rc * w.jact[r];
}

// Primal cost of a row in contact at vec.
HD float k3_contact_cost(const K3Row& o, const float* vec) {
  float p4[4], c = 0.0f;
  k3_pyr4(o, vec, p4);
  UNROLL for (int k = 0; k < 4; ++k) {
    float x = p4[k] - o.aref4[k];
    if (x < 0.0f) c = c + 0.5f * x * x * o.rinv * o.act;
  }
  return c;
}

// Solve H x = g (SPD) by a Cholesky factorization in the natural order;
// x is uniform.  Row i of H (entries k <= i; those past it are not read)
// and g[i] sit in slot i / K3_G of lane i % K3_G's registers.
// Right-looking: step j takes the pivot and column j from their lanes by
// shuffles, and each lane updates its rows' trailing entries and right-hand
// sides, so the forward solve rides along; each entry subtracts the same
// products in the same order as a left-looking factorization.  Column j is
// scaled by the pivot's rsqrt one step later, when no lane reads it any
// more.  The forward and back substitutions multiply by that rsqrt, 1 /
// L[j][j] to within a few ulp, instead of dividing by L[j][j].  The back
// substitution runs on every lane alike, each term's L[k][i] taken from
// the lane that holds row k.
HD void k3_chol_solve(const K3Grp& g, K3Rows& row, K3Slots& t, float* x) {
  K3Slots inv;  // row i's pivot rsqrt, where t holds row i's entry
  float d_prev = 1.0f, y_prev = 0.0f;  // step j - 1's pivot rsqrt and y
  UNROLL for (int j = 0; j < NV; ++j) {
    float d_j = 0.0f, y_j = 0.0f;
    lanes(g, [&](int lane) {
      float ajj = from_lane(g, j % K3_G,
                            [&](int l) { return row.at(l)[j / K3_G][j]; });
      float tj = from_lane(g, j % K3_G,
                           [&](int l) { return t.at(l)[j / K3_G]; });
      float d = rsqrtf(fmaxf(ajj, 1e-30f));
      float yj = tj * d;
      float lij[K3_RPL];
      UNROLL for (int q = 0; q < K3_RPL; ++q) lij[q] = row.at(lane)[q][j] * d;
      UNROLL for (int k = j + 1; k < NV; ++k) {
        float lkj = from_lane(g, k % K3_G,
                              [&](int l) { return row.at(l)[k / K3_G][j]; });
        UNROLL for (int q = 0; q < K3_RPL; ++q) {
          float* r = row.at(lane)[q];
          r[k] = k <= lane + q * K3_G ? r[k] - lij[q] * (lkj * d) : r[k];
        }
      }
      UNROLL for (int q = 0; q < K3_RPL; ++q) {
        int i = lane + q * K3_G;
        float* r = row.at(lane)[q];
        float& ti = t.at(lane)[q];
        ti = i > j ? ti - lij[q] * yj : ti;
        if (j > 0) {
          r[j - 1] = r[j - 1] * d_prev;
          if (i == j - 1) ti = y_prev;
        }
        if (i == j) inv.at(lane)[q] = d;
      }
      d_j = d;
      y_j = yj;
    });
    d_prev = d_j;
    y_prev = y_j;
  }
  lanes(g, [&](int lane) {
    UNROLL for (int q = 0; q < K3_RPL; ++q) {
      row.at(lane)[q][NV - 1] = row.at(lane)[q][NV - 1] * d_prev;
      if (lane + q * K3_G == NV - 1) t.at(lane)[q] = y_prev;
    }
  });
  UNROLL for (int i = NV - 1; i >= 0; --i) {
    float s = from_lane(g, i % K3_G, [&](int l) { return t.at(l)[i / K3_G]; });
    UNROLL for (int k = i + 1; k < NV; ++k)
      s = s - from_lane(g, k % K3_G,
                        [&](int l) { return row.at(l)[k / K3_G][i]; }) *
                  x[k];
    x[i] = s * from_lane(g, i % K3_G,
                         [&](int l) { return inv.at(l)[i / K3_G]; });
  }
}

// The block's envs b0 .. b0 + K3_ENVS - 1 copy their systems into their
// workspaces: thread tid of nthr takes entries tid, tid + nthr, ... of
// each workspace array, env fastest.  The contact flags go first, as
// a group of their own, so the rows in contact can be listed while the rest
// arrives.
template <bool KL>
HD void k3_load_block(K3Block& blk, const K3Args& A, long b0, int tid,
                      int nthr) {
  const long B = A.B;
  // entry r of the workspace array dst comes from row at(r) of src
  auto rows = [&](const float* src, int n, auto dst, auto at) {
    for (int i = tid; i < n * K3_ENVS; i += nthr) {
      int r = i / K3_ENVS, e = i % K3_ENVS;
      if (b0 + e < B) k3_copy(dst(blk.env[e]) + r, src + at(r) * B + b0 + e);
    }
  };
  auto same = [](int r) { return r; };
  // w.G[j][v], entry r = j * NV + v: G's row r, or v * nj + j in the
  // kernel layout
  auto g_at = [&](int r) {
    return KL ? (int)k3_g_row<KL>(A, r / NV, r % NV) : r;
  };
  rows(A.c_active, A.nc, [](K3Ws& w) { return w.cact; }, same);
  k3_copy_commit();
  rows(A.M, NV * NV, [](K3Ws& w) { return &w.M[0][0]; }, same);
  rows(A.a_s, NV, [](K3Ws& w) { return w.a_s; }, same);
  if (A.ws != nullptr) rows(A.ws, NV, [](K3Ws& w) { return w.a0; }, same);
  rows(A.G, A.nj * NV, [](K3Ws& w) { return &w.G[0][0]; }, g_at);
  rows(A.j_aref, A.nj, [](K3Ws& w) { return w.jaref; }, same);
  rows(A.j_R, A.nj, [](K3Ws& w) { return w.jrinv; }, same);  // R for now
  rows(A.j_floss, A.nj, [](K3Ws& w) { return w.jfloss; }, same);
  rows(A.j_active, A.nj, [](K3Ws& w) { return w.jact; }, same);
  k3_copy_commit();
}

// The env's rows in contact, ascending, by a ballot over K3_G flags at a
// time.  Returns their count.
HD int k3_list_rows(const K3Grp& g, const K3Args& A, K3Ws& w) {
  int na = 0;
  for (int c0 = 0; c0 < A.nc; c0 += K3_G) {
    uint32_t m = group_ballot(
        g, [&](int l) { return c0 + l < A.nc && w.cact[c0 + l] != 0.0f; });
    lanes(g, [&](int lane) {
      if ((m >> lane) & 1u)
        w.idx[na + popc32(m & ((1u << lane) - 1u))] = (uint8_t)(c0 + lane);
    });
    na = na + popc32(m);
  }
  return na;
}

// Each env's window of the pool, env by env (see the design note).
HD void k3_place(K3Block& blk) {
  int used = 0;
  for (int e = 0; e < K3_ENVS; ++e) {
    K3Ws& w = blk.env[e];
    int left = K3_POOL - used - (K3_ENVS - 1 - e) * K3_MIN_WINDOW;
    w.off = used;
    w.cap = w.na <= left ? w.na : left;
    used = used + w.cap;
  }
}

// Pointer to value f of contact row c of env b, f in K3Row's order (J,
// aref4, R, mu, active).
template <bool KL>
HD const float* k3_row_src(const K3Args& A, long c, int f, long b) {
  const long B = A.B;
  if (f < 3 * NV) {
    const float* J = f < NV ? A.Jn : (f < 2 * NV ? A.Jt1 : A.Jt2);
    return J + k3_j_row<KL>(A, c, f % NV) * B + b;
  }
  if (f < 3 * NV + 4)
    return A.c_aref + k3_a_row<KL>(A, c, f - 3 * NV) * B + b;
  const float* src = f == 3 * NV + 4 ? A.c_R
                                     : (f == 3 * NV + 5 ? A.c_mu : A.c_active);
  return src + c * B + b;
}

// What a pass over the env's rows in contact needs each row to hold
#define K3_KEEP_NONE 0  // the copied values
#define K3_KEEP_AT 1    // and x4 at the iterate
#define K3_KEEP_STEP 2  // and x4, and jd4 along the step

// Rows j0 .. j0 + n - 1 of the env's rows in contact into its window:
// lane l starts the copies of values l, l + K3_G, ... of every row.  In
// the kernel layout a value's slabs of consecutive contact rows are
// consecutive.
template <bool KL>
HD void k3_copy_rows(const K3Grp& g, const K3Args& A, K3Block& blk,
                     const K3Ws& w, long b, int j0, int n) {
  lanes(g, [&](int lane) {
    for (int f = lane; f < K3_ROWF; f += K3_G) {
      const float* src = k3_row_src<KL>(A, 0, f, b);
      long stride = KL ? A.B
                       : (f < 3 * NV ? NV * A.B
                                     : (f < 3 * NV + 4 ? 4 * A.B : A.B));
      for (int i = 0; i < n; ++i)
        k3_copy(reinterpret_cast<float*>(&blk.pool[w.off + i]) + f,
                src + w.idx[j0 + i] * stride);
    }
  });
}

// After the copies of n rows: per row 1/R and what `keep` asks for.
HD void k3_finish_rows(const K3Grp& g, K3Block& blk, const K3Ws& w, int n,
                       int keep) {
  stage(g, [&](int lane) {
    for (int i = lane; i < n; i += K3_G) {
      K3Row& o = blk.pool[w.off + i];
      o.rinv = 1.0f / o.rinv;
      if (keep >= K3_KEEP_AT) k3_keep_at(o, w.a);
      if (keep >= K3_KEEP_STEP) k3_pyr4(o, w.delta, o.jd4);
    }
  });
}

// A pass over the env's rows in contact: f(j0, n) with rows j0 .. j0 + n -
// 1 in the pool at rows w.off .. w.off + n - 1.  An env whose rows all fit
// holds them from the start and is one call, with what the iteration
// keeps; otherwise each chunk of its window is copied in and computed
// first, so f may hold per-lane state across calls only in PerLane values.
// A barrier opens each chunk, so its copies never race a lane still
// reading the rows of the chunk before.
template <bool KL, class F>
HD void k3_pass(const K3Grp& g, const K3Args& A, K3Block& blk, K3Ws& w,
                long b, int keep, F&& f) {
  if (w.cap >= w.na) {
    f(0, w.na);
    return;
  }
  for (int j0 = 0; j0 < w.na; j0 += w.cap) {
    int n = w.na - j0 < w.cap ? w.na - j0 : w.cap;
    // every lane has done with the window's rows before any lane's copies
    // overwrite them (f and the code before the pass may end in lanes())
    stage(g, [](int) {});
    k3_copy_rows<KL>(g, A, blk, w, b, j0, n);
    stage(g, [](int) { k3_copy_wait(); });
    k3_finish_rows(g, blk, w, n, keep);
    f(j0, n);
  }
}

// The solve of env b; the result in w.a.
template <bool KL>
HD void k3_solve(const K3Grp& g, const K3Args& A, K3Block& blk, int e,
                 long b) {
  K3Ws& w = blk.env[e];
  const int nj = A.nj, na = w.na;
  const bool resident = w.cap >= na;
  K3Row* pool = blk.pool + w.off;
  // the rows copied in by the kernel (resident) take 1/R; per dof the
  // joint rows that touch it, and each joint row's 1/R
  if (resident) k3_finish_rows(g, blk, w, na, K3_KEEP_NONE);
  stage(g, [&](int lane) {
    for (int v = lane; v < NV; v += K3_G) {
      uint32_t rows = 0;
      for (int r = 0; r < nj; ++r)
        if (w.G[r][v] != 0.0f) rows |= 1u << r;
      w.dof_rows[v] = rows;
    }
    for (int r = lane; r < nj; r += K3_G) w.jrinv[r] = 1.0f / w.jrinv[r];
  });

  // start: the warm start, or with MuJoCo's pick the cheaper of it and a_s
  if (A.ws != nullptr) {
    K3Lane p0, p1;
    lanes(g, [&](int lane) {
      float s0 = 0.0f, s1 = 0.0f;
      for (int r = lane; r < nj; r += K3_G) {
        s0 = s0 + k3_joint_cost(A, w, r, w.a0);
        s1 = s1 + k3_joint_cost(A, w, r, w.a_s);
      }
      for (int v = lane; v < NV; v += K3_G) {  // the smooth quadratic
        float md = 0.0f;
        UNROLL for (int u = 0; u < NV; ++u)
          md = md + w.M[v][u] * (w.a0[u] - w.a_s[u]);
        s0 = s0 + 0.5f * ((w.a0[v] - w.a_s[v]) * md);
      }
      p0.at(lane) = s0;
      p1.at(lane) = s1;
    });
    k3_pass<KL>(g, A, blk, w, b, K3_KEEP_NONE, [&](int, int n) {
      lanes(g, [&](int lane) {
        for (int i = lane; i < n; i += K3_G) {
          p0.at(lane) = p0.at(lane) + k3_contact_cost(pool[i], w.a0);
          p1.at(lane) = p1.at(lane) + k3_contact_cost(pool[i], w.a_s);
        }
      });
    });
    bool use_ws = group_sum(g, p0) < group_sum(g, p1);
    stage(g, [&](int lane) {
      for (int v = lane; v < NV; v += K3_G)
        w.a[v] = use_ws ? w.a0[v] : w.a_s[v];
    });
  } else {
    stage(g, [&](int lane) {
      for (int v = lane; v < NV; v += K3_G) w.a[v] = w.a_s[v];
    });
  }

  for (int it = 0; it < A.iterations; ++it) {
    // the rows at a: values, forces and Hessian weights; and M (a - a_s)
    stage(g, [&](int lane) {
      int nr = resident ? na : 0;
      for (int item = lane; item < nj + nr + NV; item += K3_G) {
        if (item < nj) {
          float x = k3_dot(w.G[item], w.a) - w.jaref[item], f, q;
          k3_joint_force(A, w, item, x, &f, &q);
          w.xj[item] = x;
          w.jf[item] = f;
          w.jw[item] = q * w.jrinv[item];
        } else if (item < nj + nr) {
          k3_keep_at(pool[item - nj], w.a);
        } else {
          int v = item - nj - nr;
          float md = 0.0f;
          UNROLL for (int u = 0; u < NV; ++u)
            md = md + w.M[v][u] * (w.a[u] - w.a_s[u]);
          w.mdiff[v] = md;
        }
      }
    });
    // the Hessian M + J^T W J (+1e-9 I) and the gradient -(M (a - a_s) -
    // J^T f), lane i row i and entry i: the joint rows that touch dof i,
    // then the rows in contact, each adding J[k] . (W J[i]) to entry (k,
    // i) and J[i] . (fn, ft1, ft2) to J^T f.  A zero in J adds zeros, so
    // the loops need no tests for them; entries k > i are computed as well
    // (no branches) and the factorization reads only k <= i.
    K3Rows row;
    K3Slots t;
    lanes(g, [&](int lane) {
      UNROLL for (int q = 0; q < K3_RPL; ++q) {
        float* h = row.at(lane)[q];
        int i = lane + q * K3_G;
        t.at(lane)[q] = 0.0f;
        UNROLL for (int k = 0; k < NV; ++k) h[k] = i < NV ? w.M[k][i] : 0.0f;
        if (i >= NV) continue;
        float jtf = 0.0f;
        for (uint32_t m = w.dof_rows[i]; m; m &= m - 1u) {
          int r = lowest_bit(m);
          const float* G = w.G[r];
          float gi = G[i], wr = w.jw[r];
          UNROLL for (int k = 0; k < NV; ++k)
            h[k] = h[k] + (G[k] * wr) * gi;
          jtf = jtf + gi * w.jf[r];
        }
        t.at(lane)[q] = jtf;
      }
    });
    k3_pass<KL>(g, A, blk, w, b, K3_KEEP_AT, [&](int, int n) {
      lanes(g, [&](int lane) {
        for (int c = 0; c < n; ++c) {
          const K3Row& o = pool[c];
          float cw[8];
          k3_weights(o, cw);
          UNROLL for (int q = 0; q < K3_RPL; ++q) {
            int i = lane + q * K3_G;
            if (i >= NV) continue;
            float* h = row.at(lane)[q];
            float jn = o.J[0][i], jt1 = o.J[1][i], jt2 = o.J[2][i];
            float u1 = cw[3] * jn + cw[4] * jt1 + cw[5] * jt2;
            float u2 = cw[4] * jn + cw[6] * jt1;
            float u3 = cw[5] * jn + cw[7] * jt2;
            UNROLL for (int k = 0; k < NV; ++k)
              h[k] = h[k] + (o.J[0][k] * u1 + o.J[1][k] * u2 +
                             o.J[2][k] * u3);
            t.at(lane)[q] =
                t.at(lane)[q] + (jn * cw[0] + jt1 * cw[1] + jt2 * cw[2]);
          }
        }
      });
    });
    lanes(g, [&](int lane) {
      UNROLL for (int q = 0; q < K3_RPL; ++q) {
        int i = lane + q * K3_G;
        if (i >= NV) continue;
        float* h = row.at(lane)[q];
        UNROLL for (int k = 0; k < NV; ++k)
          if (k == i) h[k] = h[k] + 1e-9f;
        t.at(lane)[q] = -(w.mdiff[i] - t.at(lane)[q]);
      }
    });
    {
      float x[NV];
      k3_chol_solve(g, row, t, x);
      single(g, [&] {
        UNROLL for (int v = 0; v < NV; ++v) w.delta[v] = x[v];
      });
    }

    // exact line search on the piecewise-quadratic 1-D restriction: the
    // step's row values and M delta, then per-lane partial sums over rows
    stage(g, [&](int lane) {
      int nr = resident ? na : 0;
      for (int item = lane; item < nj + nr + NV; item += K3_G) {
        if (item < nj) {
          w.jdj[item] = k3_dot(w.G[item], w.delta);
        } else if (item < nj + nr) {
          K3Row& o = pool[item - nj];
          k3_pyr4(o, w.delta, o.jd4);
        } else {
          int v = item - nj - nr;
          w.md[v] = k3_dot(w.M[v], w.delta);
        }
      }
    });
    float dMd = 0.0f, dMas = 0.0f;
    for (int v = 0; v < NV; ++v) {
      dMd = dMd + w.delta[v] * w.md[v];
      dMas = dMas + w.delta[v] * w.mdiff[v];
    }
    float alpha = 1.0f;
    for (int ls = 0; ls < A.ls_iterations; ++ls) {
      K3Lane pd, pdd;
      lanes(g, [&](int lane) {
        float sd = 0.0f, sdd = 0.0f;
        for (int r = lane; r < nj; r += K3_G) {
          float jd = w.jdj[r], f, q;
          k3_joint_force(A, w, r, w.xj[r] + alpha * jd, &f, &q);
          sd = sd + jd * f;
          sdd = sdd + q * w.jrinv[r] * (jd * jd);
        }
        pd.at(lane) = sd;
        pdd.at(lane) = sdd;
      });
      k3_pass<KL>(g, A, blk, w, b, K3_KEEP_STEP, [&](int, int n) {
        lanes(g, [&](int lane) {
          float sd = pd.at(lane), sdd = pdd.at(lane);
          for (int i = lane; i < n; i += K3_G) {
            const K3Row& o = pool[i];
            UNROLL for (int k = 0; k < 4; ++k) {
              float jd = o.jd4[k];
              float x = o.x4[k] + alpha * jd;
              float f = fmaxf(-x * o.rinv, 0.0f) * o.act;
              float q = x < 0.0f ? o.act : 0.0f;
              sd = sd + jd * f;
              sdd = sdd + q * o.rinv * jd * jd;
            }
          }
          pd.at(lane) = sd;
          pdd.at(lane) = sdd;
        });
      });
      float dphi = (dMas + alpha * dMd) - group_sum(g, pd);
      float ddphi = dMd + group_sum(g, pdd);
      alpha = fminf(fmaxf(alpha - dphi / fmaxf(ddphi, 1e-12f), 0.0f), 2.0f);
    }
    stage(g, [&](int lane) {
      for (int v = lane; v < NV; v += K3_G)
        w.a[v] = w.a[v] + alpha * w.delta[v];
    });
  }
}

// The block's qacc out, env index fastest.
HD void k3_store_block(K3Block& blk, const K3Args& A, long b0, int tid,
                       int nthr) {
  for (int i = tid; i < NV * K3_ENVS; i += nthr) {
    int v = i / K3_ENVS, e = i % K3_ENVS;
    if (b0 + e < A.B) A.qacc[v * A.B + b0 + e] = blk.env[e].a[v];
  }
}

#ifdef __CUDACC__

template <bool KL>
__global__ void __launch_bounds__(K3_THREADS) k3_kernel(K3Args A) {
  __shared__ K3Block blk;
  long b0 = (long)blockIdx.x * K3_ENVS;
  k3_load_block<KL>(blk, A, b0, threadIdx.x, K3_THREADS);
  k3_copy_wait_prior();  // the contact flags
  __syncthreads();
  int e = threadIdx.x / K3_G;
  long b = b0 + e;
  K3Grp g = group_of<K3_G>(threadIdx.x);
  int na = b < A.B ? k3_list_rows(g, A, blk.env[e]) : 0;
  if (g.lane == 0) blk.env[e].na = na;
  __syncthreads();
  if (threadIdx.x == 0) k3_place(blk);
  __syncthreads();
  K3Ws& w = blk.env[e];
  if (b < A.B && w.cap >= w.na) k3_copy_rows<KL>(g, A, blk, w, b, 0, w.na);
  k3_copy_wait();  // the systems and the resident rows
  __syncthreads();
  if (b < A.B) k3_solve<KL>(g, A, blk, e, b);
  __syncthreads();
  k3_store_block(blk, A, b0, threadIdx.x, K3_THREADS);
}

#define K3_LAUNCH_ERROR() ((int)cudaGetLastError())

#else  // host build: the card's blocks one after another, each group's
       // lanes one after another at every barrier

#include <vector>

typedef void* cudaStream_t;
#define K3_LAUNCH_ERROR() 0

template <bool KL>
static void k3_host(const K3Args& A) {
  std::vector<K3Block> blk(1);
  K3Block& k = blk[0];
  K3Grp g{0, 0u};
  for (long b0 = 0; b0 < A.B; b0 += K3_ENVS) {
    k3_load_block<KL>(k, A, b0, 0, 1);
    for (int e = 0; e < K3_ENVS; ++e)
      k.env[e].na = b0 + e < A.B ? k3_list_rows(g, A, k.env[e]) : 0;
    k3_place(k);
    for (int e = 0; e < K3_ENVS && b0 + e < A.B; ++e)
      if (k.env[e].cap >= k.env[e].na)
        k3_copy_rows<KL>(g, A, k, k.env[e], b0 + e, 0, k.env[e].na);
    for (int e = 0; e < K3_ENVS && b0 + e < A.B; ++e)
      k3_solve<KL>(g, A, k, e, b0 + e);
    k3_store_block(k, A, b0, 0, 1);
  }
}

#endif  // __CUDACC__

template <bool KL>
static int k3_launch_layout(K3Args A, cudaStream_t stream) {
  if (A.nj < 0 || A.nj > K3_MAX_NJ || A.nc < 0 || A.nc > K3_MAX_NC) {
#ifdef __CUDACC__
    return (int)cudaErrorInvalidValue;
#else
    return 1;
#endif
  }
#ifdef __CUDACC__
  unsigned blocks = (unsigned)((A.B + K3_ENVS - 1) / K3_ENVS);
  if (A.B > 0) k3_kernel<KL><<<blocks, K3_THREADS, 0, stream>>>(A);
#else
  (void)stream;
  if (A.B > 0) k3_host<KL>(A);
#endif
  return K3_LAUNCH_ERROR();
}

// out[0] shared bytes per block, out[1] threads per block, out[2] resident
// blocks per SM (0 in the host build) of the instantiation KL.  Returns the
// CUDA error, 0 on success.
template <bool KL>
static int k3_occupancy_of(int* out) {
  out[0] = (int)sizeof(K3Block);
  out[1] = K3_THREADS;
#ifdef __CUDACC__
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], k3_kernel<KL>, K3_THREADS, 0);
#else
  out[2] = 0;
  return 0;
#endif
}

extern "C" {

int k3_nv() { return NV; }

// Launches K3 on the stream (the host build runs it in place) with G, Jn /
// Jt1 / Jt2 and c_aref row-major (k3_launch) or in the kernel layout
// (k3_launch_kernel_layout).  Returns the CUDA error of the launch, 0 on
// success; nj or nc beyond what the kernel holds returns
// cudaErrorInvalidValue (1 on the host).
int k3_launch(const float* M, const float* a_s, const float* G,
              const float* j_aref, const float* j_R, const float* j_floss,
              const float* j_active, const float* Jn, const float* Jt1,
              const float* Jt2, const float* c_aref, const float* c_R,
              const float* c_mu, const float* c_active, const float* ws,
              float* qacc, int B, int nj, int nc, int iterations,
              int ls_iterations, int eq_mask, int fric_mask,
              cudaStream_t stream) {
  K3Args A = {M,     a_s,  G,      j_aref,   j_R,        j_floss,
              j_active, Jn, Jt1,   Jt2,      c_aref,     c_R,
              c_mu,  c_active, ws, qacc,     B,          nj,
              nc,    iterations, ls_iterations, eq_mask, fric_mask};
  return k3_launch_layout<false>(A, stream);
}

int k3_launch_kernel_layout(const float* M, const float* a_s, const float* G,
                            const float* j_aref, const float* j_R,
                            const float* j_floss, const float* j_active,
                            const float* Jn, const float* Jt1,
                            const float* Jt2, const float* c_aref,
                            const float* c_R, const float* c_mu,
                            const float* c_active, const float* ws,
                            float* qacc, int B, int nj, int nc,
                            int iterations, int ls_iterations, int eq_mask,
                            int fric_mask, cudaStream_t stream) {
  K3Args A = {M,     a_s,  G,      j_aref,   j_R,        j_floss,
              j_active, Jn, Jt1,   Jt2,      c_aref,     c_R,
              c_mu,  c_active, ws, qacc,     B,          nj,
              nc,    iterations, ls_iterations, eq_mask, fric_mask};
  return k3_launch_layout<true>(A, stream);
}

int k3_occupancy(int* out) { return k3_occupancy_of<false>(out); }

int k3_occupancy_kernel_layout(int* out) {
  return k3_occupancy_of<true>(out);
}

}  // extern "C"
