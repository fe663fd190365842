// Kernel K3: the standalone Newton constraint solve of the staged step.
//
// Replaces the TPU kernel mujoco_playground_tpu/ops/newton_pallas.py
// (newton_solve_pallas -> _newton_kernel): fixed-iteration Newton on
// MuJoCo's soft-constraint primal (pyramidal friction cones), an exact
// Newton line search on the piecewise-quadratic restriction, an unrolled
// NV x NV Cholesky in the natural order, and, with a warm start, MuJoCo's
// two-sided mj_warmstart pick.  The whole system arrives from memory, with
// every dof in one dense group (no static sparsity to prune).
//
// I/O is batch-last float32, row-major as ops/newton.py newton_solve takes
// it: Mt (NV, NV, B), a_s (NV, B), G (nj, NV, B), j_aref / j_R / j_floss /
// j_active (nj, B), Jn / Jt1 / Jt2 (nc, NV, B), c_aref (nc, 4, B), c_R /
// c_mu / c_active (nc, B), ws (NV, B) or null; out qacc (NV, B).  nj and nc
// are runtime values (nc = 48 on a maze, 72 with the wheel patch); the
// joint-row kinds come as bit masks.  Thread b reads x[i*B + b], so every
// load coalesces across the warp.
//
// What bounds it on an H100: the inputs hold ~13.8 KB per env at nc = 72
// (the dense Jacobians dominate), but a thread reads only M, a_s, the warm
// start, the joint rows and the nc active flags (~1.7 KB) and 168 B per row
// in contact, then iterates on those rows: the reads bound the batch while
// the iterations are latency-bound dependency chains.  Design: one env per
// thread; the thread reads each contact row's active flag and copies only
// the active rows (a few of nc) into its local memory, so the Newton
// iterations never touch device memory again; inactive rows carry zero
// force, Hessian weight and cost, so skipping them is exact.
#include "lanes.cuh"

#define K3_MAX_NJ 16  // joint rows per env (the robot has 11)
#define K3_MAX_NC 72  // contact rows per env (4x4 wheel-plane, 4x2x5
                      // wheel-box with the patch, 2x8 hull)

struct K3Args {
  const float *M, *a_s, *G, *j_aref, *j_R, *j_floss, *j_active;
  const float *Jn, *Jt1, *Jt2, *c_aref, *c_R, *c_mu, *c_active, *ws;
  float* qacc;
  long B;
  int nj, nc, iterations, ls_iterations, eq_mask, fric_mask;
};

struct K3Joint {
  float G[NV];
  float aref, rinv, floss, active;
  int kind;  // 0 equality, 1 dry friction, 2 one-sided
};

// One contact row in contact: Jacobian rows, pyramid reference
// accelerations, 1/R, friction and activity, and its values at the current
// iterate (x4) and along the step (jd4).
struct K3Contact {
  float J[3][NV];
  float aref4[4];
  float rinv, mu, active;
  float x4[4], jd4[4];
};

// Solve H x = g (SPD) by a Cholesky factorization in the natural order.
HD void k3_chol_solve(const float (*H)[NV], const float* g, float* x) {
  float L[NV][NV], y[NV];
  for (int j = 0; j < NV; ++j) {
    float s[NV];
    for (int i = j; i < NV; ++i) {
      float t = H[i][j];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      s[i] = t;
    }
    float d = rsqrtf(fmaxf(s[j], 1e-30f));
    for (int i = j; i < NV; ++i) L[i][j] = s[i] * d;
  }
  for (int i = 0; i < NV; ++i) {
    float t = g[i];
    for (int k = 0; k < i; ++k) t = t - L[i][k] * y[k];
    y[i] = t / L[i][i];
  }
  for (int i = NV - 1; i >= 0; --i) {
    float t = y[i];
    for (int k = i + 1; k < NV; ++k) t = t - L[k][i] * x[k];
    x[i] = t / L[i][i];
  }
}

HD float k3_dot(const float* a, const float* b) {
  float s = 0.0f;
  for (int v = 0; v < NV; ++v) s = s + a[v] * b[v];
  return s;
}

// Force and Hessian weight of a joint row at constraint value x.
HD void k3_joint_force(const K3Joint& o, float x, float* f, float* q) {
  float raw = -x * o.rinv;
  if (o.kind == 0) {
    *f = raw;
    *q = 1.0f;
  } else if (o.kind == 1) {
    *f = fminf(fmaxf(raw, -o.floss), o.floss);
    *q = fabsf(raw) < o.floss ? 1.0f : 0.0f;
  } else {
    *f = fmaxf(raw, 0.0f);
    *q = raw > 0.0f ? 1.0f : 0.0f;
  }
  *f = *f * o.active;
  *q = *q * o.active;
}

// The 4 pyramid-edge values of a contact row applied to a.
HD void k3_pyr4(const K3Contact& o, const float* a, float* p4) {
  float an = k3_dot(o.J[0], a), at1 = k3_dot(o.J[1], a),
        at2 = k3_dot(o.J[2], a);
  p4[0] = an + o.mu * at1;
  p4[1] = an - o.mu * at1;
  p4[2] = an + o.mu * at2;
  p4[3] = an - o.mu * at2;
}

HD void k3_mat_vec(const float (*M)[NV], const float* x, float* y) {
  for (int v = 0; v < NV; ++v) y[v] = k3_dot(M[v], x);
}

// Primal cost of the rows at a, plus the smooth quadratic when with_m.
HD float k3_cost(const float (*M)[NV], const float* a_s, const K3Joint* jr,
                 int nj, const K3Contact* cr, int na, const float* a,
                 bool with_m) {
  float c = 0.0f;
  for (int r = 0; r < nj; ++r) {
    const K3Joint& o = jr[r];
    float x = k3_dot(o.G, a) - o.aref;
    float quad = 0.5f * x * x * o.rinv;
    float rc;
    if (o.kind == 0) {
      rc = quad;
    } else if (o.kind == 1) {
      float lin = o.floss * fabsf(x) - 0.5f * o.floss * o.floss / o.rinv;
      rc = fabsf(x) * o.rinv < o.floss ? quad : lin;
    } else {
      rc = x < 0.0f ? quad : 0.0f;
    }
    c = c + rc * o.active;
  }
  for (int i = 0; i < na; ++i) {
    float p4[4];
    k3_pyr4(cr[i], a, p4);
    for (int k = 0; k < 4; ++k) {
      float x = p4[k] - cr[i].aref4[k];
      if (x < 0.0f) c = c + 0.5f * x * x * cr[i].rinv * cr[i].active;
    }
  }
  if (with_m) {
    float diff[NV], Md[NV];
    for (int v = 0; v < NV; ++v) diff[v] = a[v] - a_s[v];
    k3_mat_vec(M, diff, Md);
    c = c + 0.5f * k3_dot(diff, Md);
  }
  return c;
}

// The solve of env b.
HD void k3_env(int b, const K3Args& A) {
  const long B = A.B;
  float M[NV][NV], a_s[NV], a[NV];
  for (int v = 0; v < NV; ++v)
    for (int w = 0; w < NV; ++w) M[v][w] = A.M[(v * NV + w) * B + b];
  for (int v = 0; v < NV; ++v) a_s[v] = A.a_s[v * B + b];

  K3Joint jr[K3_MAX_NJ];
  for (int r = 0; r < A.nj; ++r) {
    K3Joint& o = jr[r];
    for (int v = 0; v < NV; ++v) o.G[v] = A.G[(r * NV + v) * B + b];
    o.aref = A.j_aref[r * B + b];
    o.rinv = 1.0f / A.j_R[r * B + b];
    o.floss = A.j_floss[r * B + b];
    o.active = A.j_active[r * B + b];
    o.kind = (A.eq_mask >> r) & 1 ? 0 : ((A.fric_mask >> r) & 1 ? 1 : 2);
  }
  // contact rows: only those in contact
  K3Contact cr[K3_MAX_NC];
  int na = 0;
  for (int c = 0; c < A.nc; ++c) {
    float act = A.c_active[c * B + b];
    if (act == 0.0f) continue;
    K3Contact& o = cr[na++];
    for (int v = 0; v < NV; ++v) {
      o.J[0][v] = A.Jn[(c * NV + v) * B + b];
      o.J[1][v] = A.Jt1[(c * NV + v) * B + b];
      o.J[2][v] = A.Jt2[(c * NV + v) * B + b];
    }
    for (int k = 0; k < 4; ++k) o.aref4[k] = A.c_aref[(c * 4 + k) * B + b];
    o.rinv = 1.0f / A.c_R[c * B + b];
    o.mu = A.c_mu[c * B + b];
    o.active = act;
  }

  // start: the warm start, or with MuJoCo's pick the cheaper of it and a_s
  for (int v = 0; v < NV; ++v) a[v] = a_s[v];
  if (A.ws != nullptr) {
    float a0[NV];
    for (int v = 0; v < NV; ++v) a0[v] = A.ws[v * B + b];
    if (k3_cost(M, a_s, jr, A.nj, cr, na, a0, true) <
        k3_cost(M, a_s, jr, A.nj, cr, na, a_s, false))
      for (int v = 0; v < NV; ++v) a[v] = a0[v];
  }

  float xj[K3_MAX_NJ], jdj[K3_MAX_NJ];
  float H[NV][NV];
  for (int it = 0; it < A.iterations; ++it) {
    float jtf[NV], diff[NV], Mdiff[NV], grad[NV], delta[NV];
    for (int v = 0; v < NV; ++v) jtf[v] = 0.0f;
    for (int v = 0; v < NV; ++v)
      for (int w = v; w < NV; ++w) H[v][w] = M[v][w];

    // joint rows: values, forces, J^T f and G^T w G
    for (int r = 0; r < A.nj; ++r) {
      const K3Joint& o = jr[r];
      xj[r] = k3_dot(o.G, a) - o.aref;
      float f, q;
      k3_joint_force(o, xj[r], &f, &q);
      float wr = q * o.rinv;
      for (int v = 0; v < NV; ++v) {
        if (o.G[v] == 0.0f) continue;
        jtf[v] = jtf[v] + o.G[v] * f;
        float gw = o.G[v] * wr;
        for (int w = v; w < NV; ++w)
          if (o.G[w] != 0.0f) H[v][w] = H[v][w] + gw * o.G[w];
      }
    }
    // contact rows: values, forces, J^T f and the pyramid Hessian blocks
    for (int i = 0; i < na; ++i) {
      K3Contact& o = cr[i];
      float p4[4], f4[4], w4[4];
      k3_pyr4(o, a, p4);
      for (int k = 0; k < 4; ++k) {
        o.x4[k] = p4[k] - o.aref4[k];
        f4[k] = fmaxf(-o.x4[k] * o.rinv, 0.0f) * o.active;
        w4[k] = (o.x4[k] < 0.0f ? o.active : 0.0f) * o.rinv;
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
    k3_mat_vec(M, diff, Mdiff);
    for (int v = 0; v < NV; ++v) grad[v] = -(Mdiff[v] - jtf[v]);
    for (int v = 0; v < NV; ++v) {
      H[v][v] = H[v][v] + 1e-9f;
      for (int w = v + 1; w < NV; ++w) H[w][v] = H[v][w];
    }
    k3_chol_solve(H, grad, delta);

    // exact line search on the piecewise-quadratic 1-D restriction
    for (int r = 0; r < A.nj; ++r) jdj[r] = k3_dot(jr[r].G, delta);
    for (int i = 0; i < na; ++i) k3_pyr4(cr[i], delta, cr[i].jd4);
    float Md[NV];
    k3_mat_vec(M, delta, Md);
    float dMd = k3_dot(delta, Md), dMas = k3_dot(delta, Mdiff);
    float alpha = 1.0f;
    for (int ls = 0; ls < A.ls_iterations; ++ls) {
      float dphi = dMas + alpha * dMd;
      float ddphi = dMd;
      for (int r = 0; r < A.nj; ++r) {
        float f, q;
        k3_joint_force(jr[r], xj[r] + alpha * jdj[r], &f, &q);
        dphi = dphi - jdj[r] * f;
        ddphi = ddphi + q * jr[r].rinv * (jdj[r] * jdj[r]);
      }
      for (int i = 0; i < na; ++i) {
        const K3Contact& o = cr[i];
        float sd = 0.0f, sdd = 0.0f;
        for (int k = 0; k < 4; ++k) {
          float jd = o.jd4[k];
          float x = o.x4[k] + alpha * jd;
          float f = fmaxf(-x * o.rinv, 0.0f) * o.active;
          float q = x < 0.0f ? o.active : 0.0f;
          sd = sd + jd * f;
          sdd = sdd + q * o.rinv * jd * jd;
        }
        dphi = dphi - sd;
        ddphi = ddphi + sdd;
      }
      alpha = fminf(fmaxf(alpha - dphi / fmaxf(ddphi, 1e-12f), 0.0f), 2.0f);
    }
    for (int v = 0; v < NV; ++v) a[v] = a[v] + alpha * delta[v];
  }
  for (int v = 0; v < NV; ++v) A.qacc[v * B + b] = a[v];
}

#ifdef __CUDACC__

#define K3_THREADS 64

__global__ void __launch_bounds__(K3_THREADS) k3_kernel(K3Args A) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < A.B) k3_env(b, A);
}

#define K3_LAUNCH_ERROR() ((int)cudaGetLastError())

#else  // host build: the same per-env program, one env after another

typedef void* cudaStream_t;
#define K3_LAUNCH_ERROR() 0

#endif  // __CUDACC__

extern "C" {

int k3_nv() { return NV; }

// Launches K3 on the stream (the host build runs it in place).  Returns the
// CUDA error of the launch, 0 on success; nj or nc beyond what the kernel
// holds returns cudaErrorInvalidValue (1 on the host).
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
  if (nj < 0 || nj > K3_MAX_NJ || nc < 0 || nc > K3_MAX_NC) {
#ifdef __CUDACC__
    return (int)cudaErrorInvalidValue;
#else
    return 1;
#endif
  }
#ifdef __CUDACC__
  if (B > 0)
    k3_kernel<<<(B + K3_THREADS - 1) / K3_THREADS, K3_THREADS, 0, stream>>>(A);
#else
  for (int b = 0; b < B; ++b) k3_env(b, A);
#endif
  return K3_LAUNCH_ERROR();
}

}  // extern "C"
