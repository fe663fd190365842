// Kernel K1: one full 0.002 s physics step of a batch of envs, with the
// Ackermann env's lidar, observation, reward and auto-reset spawn scan
// fused in.  The per-env program and the kernel template, shared by the
// two libraries that instantiate it: step_kernel.cu (the model's own
// parameters, sub-slices a-d) and step_kernel_dr.cu (K1e, sub-slice e:
// per-env domain-randomized parameters).
//
// Replaces the TPU kernel mujoco_playground_tpu/ops/step_pallas.py
// (build_step_fn -> _step_kernel): (a) FK, CRBA/RNEA, actuators, smooth
// solve, collision (48 slots), joint and contact rows, Newton,
// implicit-damping Euler, FK; (b) the lidar on the new frames; (c)
// observation, reward, goal distance, min lidar, collision and termination;
// (d) the lidar at each env's fresh spawn pose; (e) with dr_fields, the nine
// DR_LAYOUT scalars per env from a packed (DR_ROWS, B) input, the floor
// height a per-env value in the collision and in both scans.
//
// I/O is batch-last float32: in qpos (NQ, B), qvel (NV, B), ctrl (NU, B),
// warmstart (NV, B), env_in (5 or 7, B), dr (DR_ROWS, B); out qpos, qvel,
// xpos (NBODY*3, B), xquat (NBODY*4, B), qacc (NV, B) and the env slab
// (NSITE + 12 [+ NSITE], B).  Thread b reads x[i*B + b], so every load and
// store coalesces.
//
// What bounds it on an H100: operations and their latency, not bytes.  Per
// env and step it moves ~1.2 KB (K1e: +340 B of parameters) but runs tens
// of kFLOP of small dense linear algebra (12x12 Cholesky factorizations,
// Hessian assembly over the active contact rows, the 72-beam scans) through
// data-dependent branches.  Design: one env per thread, every intermediate
// in registers or the thread's local memory (cached in L1/L2), never in
// device memory; the model and scene live in __constant__ memory, read by
// all threads of a warp at the same address; K1e reads each parameter from
// dr[row*B + b] where it is used; inactive contact slots are dropped before
// the Newton iterations.  At 16384 envs there are only ~4 warps per SM, so
// the kernel is latency-bound; splitting one env across a warp is later
// work.
#pragma once

#include "step_newton.cuh"

#define ENV_ROWS 12  // x, y, heading, dx, dy, dist, angle, reward, gd, min,
                     // collision, terminated
#define FLAG_ALIASING 1     // obs slots 0-9 read beam 71 (the reference's bug)
#define FLAG_IGNORE_NOHIT 2  // -1 readings do not count toward min lidar

struct K1Args {
  const float *qpos, *qvel, *ctrl, *ws, *env_in, *dr;
  float *qpos_out, *qvel_out, *xpos_out, *xquat_out, *qacc_out, *slab;
  long B;
  int flags;
  float coll_th, goal_th, prog_scale, coll_pen;
};

// Env b's view of the randomized parameters (nothing without DR).
template <bool DR>
HD DRP<DR> env_params(int b, const K1Args& A) {
  if constexpr (DR) return DRP<true>{A.dr + b, A.B};
  else return DRP<false>{};
}

// Integrate a quaternion by a local angular velocity, normalized.
HD void quat_integrate(const float* q, const float* w, float dt, float* out) {
  float w2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  float angle = sqrtf(w2);
  bool nz = angle > 1e-14f;
  float half = angle * dt * 0.5f;
  float s = nz ? sinf(half) / angle : 0.0f;
  float dq[4] = {cosf(half), w[0] * s, w[1] * s, w[2] * s};
  float o[4];
  qmul(q, dq, o);
  float norm = sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
  for (int k = 0; k < 4; ++k) out[k] = o[k] / norm;
}

// Stage (a): the physics step of env b.  Writes qpos, qvel, xpos, xquat
// and qacc, and returns the new frames for the fused env stages.
template <bool WS_COMPARE, bool DR>
NOINLINE void k1_physics(int b, const K1Args& A, float (*xpos_new)[3],
                         float (*xquat_new)[4]) {
  const K1Const& C = c_k1;
  const long B = A.B;
  const DRP<DR> dr = env_params<DR>(b, A);
  float q[NQ], vel[NV], ctrl[NU], a0[NV];
  for (int i = 0; i < NQ; ++i) q[i] = A.qpos[i * B + b];
  for (int i = 0; i < NV; ++i) vel[i] = A.qvel[i * B + b];
  for (int i = 0; i < NU; ++i) ctrl[i] = A.ctrl[i * B + b];
  for (int i = 0; i < NV; ++i) a0[i] = A.ws[i * B + b];

  // FK + smooth dynamics
  float xpos[NBODY][3], xquat[NBODY][4], S[NV][6], M[NV][NV], fbias[NV];
  fk(q, xpos, xquat);
  const float* anchor = xpos[1];
  motion_subspace(xpos, xquat, anchor, S);
  crba_bias<DR>(xpos, xquat, vel, S, anchor, M, fbias, dr);
  float qfrc[NV], a_s[NV];
  actuator_force<DR>(q, vel, ctrl, qfrc, dr);
  for (int v = 0; v < NV; ++v)
    qfrc[v] = (qfrc[v] - param(dr, DR_DOF_DAMPING + v, C.dof_damping[v]) *
                             vel[v]) - fbias[v];
  chol_solve(M, qfrc, a_s);

  // collision, constraint rows, Newton
  Slot slots[NSLOT];
  collide<DR>(xpos, xquat, slots, dr);
  JRow jr[NJROW];
  joint_rows<DR>(q, vel, jr, dr);
  CRow cr[NSLOT];
  int nc = contact_rows<DR>(slots, S, anchor, vel, cr, dr);
  float qacc[NV];
  newton<WS_COMPARE>(M, a_s, a0, jr, cr, nc, qacc);

  // implicit-damping Euler: (M + h D) v' = M (v + h a) + h D v
  const float h = C.timestep;
  float MhD[NV][NV], rhs[NV], vnew[NV];
  for (int v = 0; v < NV; ++v) {
    float s = 0.0f;
    for (int w = 0; w < NV; ++w) {
      MhD[v][w] = M[v][w];
      s = s + M[v][w] * (vel[w] + h * qacc[w]);
    }
    float hd = C.h_damping[v];
    if constexpr (DR) hd = h * param(dr, DR_DOF_DAMPING + v, 0.0f);
    MhD[v][v] = MhD[v][v] + hd;
    rhs[v] = s + hd * vel[v];
  }
  chol_solve(MhD, rhs, vnew);

  float qn[NQ];
  for (int j = 0; j < NJNT; ++j) {
    int adr = C.jnt_qposadr[j], da = C.jnt_dofadr[j];
    if (C.jnt_type[j] == JNT_FREE) {
      for (int k = 0; k < 3; ++k) qn[adr + k] = q[adr + k] + h * vnew[da + k];
      quat_integrate(q + adr + 3, vnew + da + 3, h, qn + adr + 3);
    } else {
      qn[adr] = q[adr] + h * vnew[da];
    }
  }
  fk(qn, xpos_new, xquat_new);

  for (int i = 0; i < NQ; ++i) A.qpos_out[i * B + b] = qn[i];
  for (int i = 0; i < NV; ++i) A.qvel_out[i * B + b] = vnew[i];
  for (int i = 0; i < NV; ++i) A.qacc_out[i * B + b] = qacc[i];
  for (int i = 0; i < NBODY; ++i) {
    for (int k = 0; k < 3; ++k) A.xpos_out[(3 * i + k) * B + b] = xpos_new[i][k];
    for (int k = 0; k < 4; ++k)
      A.xquat_out[(4 * i + k) * B + b] = xquat_new[i][k];
  }
}

HD void alias_beams(int flags, float* lid) {
  if (flags & FLAG_ALIASING)
    for (int i = 0; i < 10; ++i) lid[i] = lid[71];
}

// Stages (b)-(d) on the new frames of env b.
template <bool WITH_FRESH, bool DR>
HD void k1_env_rows(int b, const K1Args& A, const float (*xpos)[3],
                    const float (*xquat)[4]) {
  const K1Const& C = c_k1;
  const long B = A.B;
  const float plane_z =
      param(env_params<DR>(b, A), DR_PLANE_Z, C.lidar.plane_z);
  float* slab = A.slab + b;
  float lid[NSITE];
  lidar_scan(C.lidar, xpos, xquat, lid, 1, plane_z);
  alias_beams(A.flags, lid);
  float mn = 0.0f;
  for (int i = 0; i < NSITE; ++i) {
    slab[i * B] = lid[i];
    float r = ((A.flags & FLAG_IGNORE_NOHIT) && lid[i] < 0.0f) ? INFINITY
                                                                : lid[i];
    mn = i == 0 ? r : fminf(mn, r);
  }
  float in[7];
  for (int i = 0; i < (WITH_FRESH ? 7 : 5); ++i) in[i] = A.env_in[i * B + b];
  float px = xpos[1][0] - in[0], py = xpos[1][1] - in[1];
  float qw = xquat[1][0], qx = xquat[1][1], qy = xquat[1][2],
        qz = xquat[1][3];
  float heading = atan2f(2.0f * (qw * qz + qx * qy),
                         1.0f - 2.0f * (qy * qy + qz * qz));
  float gx = in[2] - px, gy = in[3] - py;
  float gd = sqrtf(gx * gx + gy * gy);
  float ga = atan2f(gy, gx) - heading;
  // wrap to [-pi, pi)
  const float two_pi = 6.28318530717958647692f, pi = 3.14159265358979323846f;
  ga = ga - two_pi * floorf((ga + pi) / two_pi);
  bool collision = mn < A.coll_th;
  bool terminated = gd < A.goal_th;
  float reward = -gd * 0.1f + (terminated ? 100.0f : 0.0f) +
                 (collision ? A.coll_pen : 0.0f) - 0.01f +
                 A.prog_scale * (in[4] - gd);
  float rows[ENV_ROWS] = {px, py, heading, gx, gy, gd, ga, reward, gd, mn,
                          collision ? 1.0f : 0.0f, terminated ? 1.0f : 0.0f};
  for (int i = 0; i < ENV_ROWS; ++i) slab[(NSITE + i) * B] = rows[i];

  if (WITH_FRESH) {
    // the lidar at the fresh spawn pose: the template frames shifted in xy
    float offx = in[5] - C.t_xy[0], offy = in[6] - C.t_xy[1];
    float fp[NBODY][3];
    for (int i = 0; i < NBODY; ++i) {
      fp[i][0] = C.t_xpos[i][0] + offx;
      fp[i][1] = C.t_xpos[i][1] + offy;
      fp[i][2] = C.t_xpos[i][2];
    }
    lidar_scan(C.lidar, fp, C.t_xquat, lid, 1, plane_z);
    alias_beams(A.flags, lid);
    for (int i = 0; i < NSITE; ++i) slab[(NSITE + ENV_ROWS + i) * B] = lid[i];
  }
}

template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
HD void k1_env(int b, const K1Args& A) {
  float xpos[NBODY][3], xquat[NBODY][4];
  k1_physics<WS_COMPARE, DR>(b, A, xpos, xquat);
  if (WITH_ENV) k1_env_rows<WITH_FRESH, DR>(b, A, xpos, xquat);
}

#ifdef __CUDACC__

#define K1_THREADS 64

template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
__global__ void __launch_bounds__(K1_THREADS) k1_kernel(K1Args A) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < A.B) k1_env<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>(b, A);
}

template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
static void k1_run(const K1Args& A, cudaStream_t stream) {
  int blocks = (int)((A.B + K1_THREADS - 1) / K1_THREADS);
  k1_kernel<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>
      <<<blocks, K1_THREADS, 0, stream>>>(A);
}

#define K1_BAD_FLAGS ((int)cudaErrorInvalidValue)
#define K1_LAUNCH_ERROR() ((int)cudaGetLastError())

static int k1_upload(const void* blob, size_t size) {
  if (size != sizeof(K1Const)) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(c_k1, blob, size);
}

#else  // host build: the same per-env program, one env after another

template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
static void k1_run(const K1Args& A, void*) {
  for (int b = 0; b < A.B; ++b)
    k1_env<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>(b, A);
}
typedef void* cudaStream_t;
#define K1_BAD_FLAGS 1
#define K1_LAUNCH_ERROR() 0

static int k1_upload(const void* blob, size_t size) {
  if (size != sizeof(K1Const)) return 1;
  memcpy(&c_k1, blob, size);
  return 0;
}

#endif  // __CUDACC__
