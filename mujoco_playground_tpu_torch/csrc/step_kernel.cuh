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
// (NSITE + 12 [+ NSITE], B).
//
// What bounds it on an H100: operations and their latency, not bytes.  Per
// env and step it moves ~1.2 KB (K1e: +340 B of parameters) but runs tens
// of kFLOP of small dense linear algebra (12x12 Cholesky factorizations,
// Hessian assembly over the active contact rows, the 72-beam scans) through
// data-dependent branches.
//
// Design.  A group of K1_G lanes (one warp at G = 32) computes each env;
// a block holds K1_ENVS envs.  The env's state and every intermediate live
// in its workspace (Ws) in shared memory; a lane keeps only the scalars of
// the item it is on.  The program is a sequence of stages (stage() in
// step_model.cuh): in each, the lanes take the items lane, lane + G, ...
// (beams, slots, hull vertices, rows, dofs, Hessian entries, Cholesky rows),
// then the group waits at __syncwarp.  The six 12x12 Cholesky solves keep
// one row per lane in registers and trade columns by warp shuffles, with no
// barrier between their steps (group_chol_solve in step_model.cuh).
// Reductions add per-lane partials in a fixed order (a serial loop or a
// fixed shuffle butterfly), never by atomics, so two launches on the same
// inputs give the same bits.  Scalar tails with no parallelism worth a
// barrier (the env rows) run on lane 0.
// Tables that lanes index by their own item are read from a global copy of
// the model (g_k1, through L1); reads at one address for the warp stay in
// __constant__ memory (c_k1).  The block loads its envs' inputs (and K1e's
// 85 parameters) into the workspaces once, consecutive threads on
// consecutive envs of a row.
//
// Left out, and why: tensor cores (wgmma, mma): the products are 12 wide,
// and TF32 keeps about three digits, which would break the float32
// tolerance K1 is held to (3e-4 of each env's scale, strict at B=16384).
// TMA: K1 reads 47 floats per env; there is no tile to stream.
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

// The workspace of one env, 11,136 B (K1e 11,472 B), sized for the worst
// case of all NSLOT slots in contact.  Persistent fields live for the whole
// step; the phases before the Newton solve (PreWs), the solve (NewtonWs)
// and the phases after it (PostWs) share one union, and within PreWs the
// smooth dynamics, its solve and the collision share another.
struct SmoothWs {               // CRBA, RNEA and the smooth force
  float I6[NBODY][6][6];        // spatial inertias          1,152 B
  float IJ[NBODY][NBDOF][6];    // I6 times each dof of the body 1,536 B
  float vbody[NBODY][6];        // body velocities             192 B
  float cdot[NV][6];            // velocity products           288 B
  float f6[NBODY][6];           // RNEA body forces            192 B
};
struct CollideWs {              // collision
  WheelGeom wheel[NWHEEL];      //                             128 B
  HullGeom hull[NHULL];         // vertices and scores       1,520 B
  Slot slot[NSLOT];             // candidates                1,344 B
  int act[NSLOT];               // active slots, slot order    192 B
};
struct PreWs {                  // until the rows are built    3,932 B
  float ctrl[NU], a0[NV];       // inputs                       60 B
  float xpos[NBODY][3], xquat[NBODY][4];  // frames            224 B
  float S[NV][6];               // motion subspace             288 B
  union {                       // largest: SmoothWs         3,360 B
    SmoothWs sm;
    Chol ch;                    // the smooth solve
    CollideWs co;
  };
};
struct PostWs {                 // the Euler step's frames and the env rows
  float xpos[NBODY][3], xquat[NBODY][4];  // the new frames    224 B
  float qn[NQ];                 // the new qpos                 52 B
  float lid[2][NSITE];          // the two scans               576 B
  float mn[K1_G];               // per-lane min lidar          128 B
};
template <bool DR>
struct Ws {
  float q[NQ], vel[NV], env_in[7];  // inputs                  128 B
  float dr[DR ? DR_ROWS : 1];   // K1e's parameters            340 B
  float M[NV][NV];              // mass matrix                 576 B
  float a_s[NV], qacc[NV], vnew[NV];  //                       144 B
  JRow jr[NJROW];               // joint rows                  264 B
  CRow cr[NSLOT];               // active contact rows       5,952 B
  int nc;                       // their count                   4 B
  union {                       // largest: NewtonWs         4,064 B
    PreWs pre;
    NewtonWs nw;
    PostWs post;
  };
};

// Integrate a quaternion by a local angular velocity, normalized.
HD void quat_integrate(const float* q, const float* w, float dt, float* out) {
  float w2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  float angle = sqrtf(w2);
  bool nz = angle > 1e-14f;
  float sh, ch;
  sincosf(angle * dt * 0.5f, &sh, &ch);
  float s = nz ? sh / angle : 0.0f;
  float dq[4] = {ch, w[0] * s, w[1] * s, w[2] * s};
  float o[4];
  qmul(q, dq, o);
  float norm = sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
  for (int k = 0; k < 4; ++k) out[k] = o[k] / norm;
}

// The block's envs b0 .. b0 + K1_ENVS - 1 read their inputs into their
// workspaces: thread tid of nthr takes elements tid, tid + nthr, ... of
// each input, env fastest.
template <bool WITH_ENV, bool WITH_FRESH, bool DR>
HD void load_block(Ws<DR>* ws, const K1Args& A, long b0, int tid, int nthr) {
  const long B = A.B;
  auto rows = [&](const float* src, int n, auto dst) {
    for (int i = tid; i < n * K1_ENVS; i += nthr) {
      int r = i / K1_ENVS, e = i % K1_ENVS;
      if (b0 + e < B) dst(ws[e])[r] = src[r * B + b0 + e];
    }
  };
  rows(A.qpos, NQ, [](Ws<DR>& w) { return w.q; });
  rows(A.qvel, NV, [](Ws<DR>& w) { return w.vel; });
  rows(A.ctrl, NU, [](Ws<DR>& w) { return w.pre.ctrl; });
  rows(A.ws, NV, [](Ws<DR>& w) { return w.pre.a0; });
  if (WITH_ENV)
    rows(A.env_in, WITH_FRESH ? 7 : 5, [](Ws<DR>& w) { return w.env_in; });
  if constexpr (DR) rows(A.dr, DR_ROWS, [](Ws<DR>& w) { return w.dr; });
}

// Stage (a): the physics step of env b.  Writes qpos, qvel, xpos, xquat
// and qacc, and leaves the new frames in w.post.
template <bool WS_COMPARE, bool DR>
HD void k1_physics(const Grp& g, Ws<DR>& w, long b, const K1Args& A) {
  const K1Const& C = c_k1;
  const long B = A.B;
  DRP<DR> dr;
  if constexpr (DR) dr.p = w.dr;
  const float plane_z = param(dr, DR_PLANE_Z, C.lidar.plane_z);
  PreWs& pre = w.pre;
  const float* anchor = pre.xpos[1];

  // FK, the motion subspace and the spatial inertias
  group_fk(g, w.q, pre.xpos, pre.xquat);
  SmoothWs& sm = pre.sm;
  stage(g, [&](int lane) {
    FOR_ITEMS(item, lane, NJNT + NBODY) {
      if (item < NJNT) {
        joint_subspace(item, pre.xpos, pre.xquat, anchor, pre.S);
      } else {
        int bd = item - NJNT;
        if (g_k1.body_inert[bd])
          spatial_inertia(bd, pre.xpos[bd], pre.xquat[bd], anchor, sm.I6[bd],
                          dr);
      }
    }
  });
  // CRBA: I6 J per (body, ancestor dof); body velocities J qvel
  stage(g, [&](int lane) {
    FOR_ITEMS(item, lane, NBODY * NV + NBODY * 6) {
      if (item < NBODY * NV) {
        int bd = item / NV, v = item % NV;
        uint32_t dofs = g_k1.body_dofs[bd];
        if (!g_k1.body_inert[bd] || !moves(dofs, v)) continue;
        float* ij = sm.IJ[bd][dof_col(dofs, v)];
        for (int k = 0; k < 6; ++k) {
          float s = 0.0f;
          for (int l = 0; l < 6; ++l) s = s + sm.I6[bd][k][l] * pre.S[v][l];
          ij[k] = s;
        }
      } else {
        int bd = (item - NBODY * NV) / 6, k = (item - NBODY * NV) % 6;
        float s = 0.0f;
        uint32_t dofs = g_k1.body_dofs[bd];
        if (g_k1.body_inert[bd])
          for (int v = 0; v < NV; ++v)
            if (moves(dofs, v)) s = s + pre.S[v][k] * w.vel[v];
        sm.vbody[bd][k] = s;
      }
    }
  });
  // M = sum_b J_b^T I_b J_b + armature, per upper entry; the velocity
  // products per dof
  stage(g, [&](int lane) {
    FOR_ITEMS(item, lane, NOFF + 2 * NV) {
      if (item < NOFF + NV) {
        int v, u;
        sym_entry(item, &v, &u);
        float s = 0.0f;
        for (int bd = 0; bd < NBODY; ++bd) {
          uint32_t dofs = C.body_dofs[bd];
          if (!C.body_inert[bd] || !moves(dofs, v) || !moves(dofs, u))
            continue;
          const float* ij = sm.IJ[bd][dof_col(dofs, u)];
          for (int k = 0; k < 6; ++k) s = s + pre.S[v][k] * ij[k];
        }
        if (v == u)
          s = s + param(dr, DR_DOF_ARMATURE + v, g_k1.dof_armature[v]);
        w.M[v][u] = s;
        w.M[u][v] = s;
      } else {
        int d = item - NOFF - NV;
        dof_cdot(d, sm.vbody, pre.S[d], w.vel[d], sm.cdot[d]);
      }
    }
  });
  // RNEA per body: I a + v x* (I v), with a the gravity and the velocity
  // products of its ancestor dofs
  stage(g, [&](int lane) {
    FOR_ITEMS(bd, lane, NBODY) {
      if (!g_k1.body_inert[bd]) continue;
      const float* vb = sm.vbody[bd];
      float ab[6], Iv[6], Ia[6], fc[6], t[3];
      uint32_t dofs = g_k1.body_dofs[bd];
      for (int k = 0; k < 6; ++k) {
        float s = k < 3 ? 0.0f : -C.gravity[k - 3];
        for (int v = 0; v < NV; ++v)
          if (moves(dofs, v)) s = s + sm.cdot[v][k];
        ab[k] = s;
      }
      mat6_vec(sm.I6[bd], vb, Iv);
      mat6_vec(sm.I6[bd], ab, Ia);
      v3cross(vb, Iv, fc);
      v3cross(vb + 3, Iv + 3, t);
      for (int k = 0; k < 3; ++k) fc[k] = fc[k] + t[k];
      v3cross(vb, Iv + 3, fc + 3);
      for (int k = 0; k < 6; ++k) sm.f6[bd][k] = Ia[k] + fc[k];
    }
  });
  // the smooth force per dof (held in vnew until the Euler step), then the
  // system M a_s = qfrc in elimination order: row i of the factor's input
  // is dof order[i] (the solve's scratch shares PreWs's union with the
  // smooth phase's, so it is written only once that is read)
  stage(g, [&](int lane) {
    FOR_ITEMS(v, lane, NV) {
      float fb = 0.0f;
      for (int bd = 0; bd < NBODY; ++bd) {
        if (!C.body_inert[bd] || !moves(C.body_dofs[bd], v)) continue;
        for (int k = 0; k < 6; ++k) fb = fb + pre.S[v][k] * sm.f6[bd][k];
      }
      float qf = actuator_force(v, w.q, w.vel, pre.ctrl, dr);
      w.vnew[v] = (qf - param(dr, DR_DOF_DAMPING + v, g_k1.dof_damping[v]) *
                            w.vel[v]) - fb;
    }
  });
  Chol& ch = pre.ch;
  stage(g, [&](int lane) {
    FOR_ITEMS(i, lane, NV) {
      const int* p = g_k1.order;
      for (int k = 0; k <= i; ++k) ch.A[i][k] = w.M[p[i]][p[k]];
      ch.t[i] = w.vnew[p[i]];
    }
  });
  group_chol_solve(g, ch, w.a_s);

  // collision: per wheel and hull, then per hull vertex, then per slot
  CollideWs& co = pre.co;
  stage(g, [&](int lane) {
    FOR_ITEMS(item, lane, NWHEEL + NHULL + NJROW) {
      if (item < NWHEEL + NHULL)
        geom_item(item, pre.xpos, pre.xquat, co.wheel, co.hull);
      else
        joint_row(item - NWHEEL - NHULL, w.q, w.vel,
                  w.jr[item - NWHEEL - NHULL], dr);
    }
  });
  stage(g, [&](int lane) {
    FOR_ITEMS(item, lane, NHULL * NHULLV) {
      hull_vertex(item / NHULLV, item % NHULLV, pre.xpos, plane_z,
                  co.hull[item / NHULLV]);
    }
  });
  stage(g, [&](int lane) {
    FOR_ITEMS(s, lane, NSLOT)
      collide_slot(s, co.wheel, co.hull, plane_z, co.slot[s]);
  });
  // the active slots, compacted in slot order: each lane reads every
  // slot's activity as bits and places its own active slots
  stage(g, [&](int lane) {
    uint64_t act = 0;
    for (int s = 0; s < NSLOT; ++s)
      act |= (uint64_t)(co.slot[s].dist < 0.0f) << s;
    FOR_ITEMS(s, lane, NSLOT) {
      if ((act >> s) & 1ull) co.act[popc64(act & ((1ull << s) - 1))] = s;
    }
    if (lane == 0) w.nc = popc64(act);
  });
  const int nc = w.nc;
  stage(g, [&](int lane) {
    FOR_ITEMS(i, lane, nc) {
      int s = co.act[i];
      contact_row(s, co.slot[s], pre.S, anchor, w.vel, w.cr[i], dr);
    }
  });

  group_newton<WS_COMPARE>(g, w.M, w.a_s, pre.a0, w.jr, w.cr, nc, w.qacc,
                           w.nw);

  // implicit-damping Euler: (M + h D) v' = M (v + h a) + h D v
  const float h = C.timestep;
  Chol& ech = w.nw.ch;
  stage(g, [&](int lane) {
    FOR_ITEMS(i, lane, NV) {
      const int* p = g_k1.order;
      int v = p[i];
      float s = 0.0f;
      for (int u = 0; u < NV; ++u)
        s = s + w.M[v][u] * (w.vel[u] + h * w.qacc[u]);
      float hd = g_k1.h_damping[v];
      if constexpr (DR) hd = h * param(dr, DR_DOF_DAMPING + v, 0.0f);
      for (int k = 0; k < i; ++k) ech.A[i][k] = w.M[v][p[k]];
      ech.A[i][i] = w.M[v][v] + hd;
      ech.t[i] = s + hd * w.vel[v];
    }
  });
  group_chol_solve(g, ech, w.vnew);

  PostWs& post = w.post;
  float* qn = post.qn;
  stage(g, [&](int lane) {
    FOR_ITEMS(j, lane, NJNT) {
      int adr = g_k1.jnt_qposadr[j], da = g_k1.jnt_dofadr[j];
      if (g_k1.jnt_type[j] == JNT_FREE) {
        for (int k = 0; k < 3; ++k) qn[adr + k] = w.q[adr + k] + h * w.vnew[da + k];
        quat_integrate(w.q + adr + 3, w.vnew + da + 3, h, qn + adr + 3);
      } else {
        qn[adr] = w.q[adr] + h * w.vnew[da];
      }
    }
  });
  group_fk(g, qn, post.xpos, post.xquat);
  stage(g, [&](int lane) {
    FOR_ITEMS(r, lane, NQ + 2 * NV + 7 * NBODY) {
      if (r < NQ) {
        A.qpos_out[r * B + b] = qn[r];
      } else if (r < NQ + NV) {
        A.qvel_out[(r - NQ) * B + b] = w.vnew[r - NQ];
      } else if (r < NQ + 2 * NV) {
        A.qacc_out[(r - NQ - NV) * B + b] = w.qacc[r - NQ - NV];
      } else if (r < NQ + 2 * NV + 3 * NBODY) {
        int k = r - NQ - 2 * NV;
        A.xpos_out[k * B + b] = post.xpos[k / 3][k % 3];
      } else {
        int k = r - NQ - 2 * NV - 3 * NBODY;
        A.xquat_out[k * B + b] = post.xquat[k / 4][k % 4];
      }
    }
  });
}

HD int alias_beam(int flags, int i) {
  return ((flags & FLAG_ALIASING) && i < 10) ? 71 : i;
}

// Stages (b)-(d) on the new frames of env b.
template <bool WITH_FRESH, bool DR>
HD void k1_env_rows(const Grp& g, Ws<DR>& w, long b, const K1Args& A) {
  const K1Const& C = c_k1;
  const long B = A.B;
  DRP<DR> dr;
  if constexpr (DR) dr.p = w.dr;
  const float plane_z = param(dr, DR_PLANE_Z, C.lidar.plane_z);
  float* slab = A.slab + b;
  PostWs& ev = w.post;
  const int nscan = WITH_FRESH ? 2 : 1;
  // the scans: on the new frames, and at the fresh spawn pose (the
  // template frames shifted in xy)
  stage(g, [&](int lane) {
    FOR_ITEMS(item, lane, nscan * NSITE) {
      int i = item % NSITE, sc = item / NSITE;
      int bd = g_k1.lidar.site_body[i];
      // the body's frame, picked before the one beam call that both
      // scans share (a lane's items may belong to either)
      float p[3], q[4];
      for (int k = 0; k < 3; ++k)
        p[k] = sc == 0 ? ev.xpos[bd][k] : g_k1.t_xpos[bd][k];
      for (int k = 0; k < 4; ++k)
        q[k] = sc == 0 ? ev.xquat[bd][k] : g_k1.t_xquat[bd][k];
      if (sc == 1) {
        p[0] = p[0] + (w.env_in[5] - C.t_xy[0]);
        p[1] = p[1] + (w.env_in[6] - C.t_xy[1]);
      }
      ev.lid[sc][i] = k1_beam(i, p, q, plane_z);
    }
  });
  stage(g, [&](int lane) {
    float mn = INFINITY;
    FOR_ITEMS(item, lane, nscan * NSITE) {
      int i = item % NSITE, s = item / NSITE;
      float v = ev.lid[s][alias_beam(A.flags, i)];
      if (s == 0) {
        slab[i * B] = v;
        float r = ((A.flags & FLAG_IGNORE_NOHIT) && v < 0.0f) ? INFINITY : v;
        mn = fminf(mn, r);
      } else {
        slab[(NSITE + ENV_ROWS + i) * B] = v;
      }
    }
    ev.mn[lane] = mn;
  });
  single(g, [&]() {
    float mn = ev.mn[0];
    for (int l = 1; l < K1_G; ++l) mn = fminf(mn, ev.mn[l]);
    const float* in = w.env_in;
    float px = ev.xpos[1][0] - in[0], py = ev.xpos[1][1] - in[1];
    float qw = ev.xquat[1][0], qx = ev.xquat[1][1], qy = ev.xquat[1][2],
          qz = ev.xquat[1][3];
    float heading = atan2f(2.0f * (qw * qz + qx * qy),
                           1.0f - 2.0f * (qy * qy + qz * qz));
    float gx = in[2] - px, gy = in[3] - py;
    float gd = sqrtf(gx * gx + gy * gy);
    float ga = atan2f(gy, gx) - heading;
    // wrap to [-pi, pi)
    const float two_pi = 6.28318530717958647692f,
                pi = 3.14159265358979323846f;
    ga = ga - two_pi * floorf((ga + pi) / two_pi);
    bool collision = mn < A.coll_th;
    bool terminated = gd < A.goal_th;
    float reward = -gd * 0.1f + (terminated ? 100.0f : 0.0f) +
                   (collision ? A.coll_pen : 0.0f) - 0.01f +
                   A.prog_scale * (in[4] - gd);
    float rows[ENV_ROWS] = {px, py, heading, gx, gy, gd, ga, reward, gd, mn,
                            collision ? 1.0f : 0.0f, terminated ? 1.0f : 0.0f};
    for (int i = 0; i < ENV_ROWS; ++i) slab[(NSITE + i) * B] = rows[i];
  });
}

template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
HD void k1_env(const Grp& g, Ws<DR>& w, long b, const K1Args& A) {
  k1_physics<WS_COMPARE, DR>(g, w, b, A);
  if (WITH_ENV) k1_env_rows<WITH_FRESH, DR>(g, w, b, A);
}

template <bool DR>
constexpr size_t k1_smem_bytes() {
  return sizeof(Ws<DR>) * K1_ENVS;
}

#ifdef __CUDACC__

// Registers capped at 128 a thread: 65,536 / (128 K1_THREADS) blocks.
template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
__global__ void __launch_bounds__(K1_THREADS, 512 / K1_THREADS)
    k1_kernel(K1Args A) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  Ws<DR>* ws = reinterpret_cast<Ws<DR>*>(k1_smem);
  long b0 = (long)blockIdx.x * K1_ENVS;
  load_block<WITH_ENV, WITH_FRESH, DR>(ws, A, b0, threadIdx.x, K1_THREADS);
  __syncthreads();
  int e = threadIdx.x / K1_G;
  long b = b0 + e;
  if (b >= A.B) return;  // the whole group
  int lane = threadIdx.x % K1_G;
  unsigned mask = K1_G == 32 ? 0xffffffffu
                             : ((1u << K1_G) - 1u) << (threadIdx.x % 32 - lane);
  Grp g{lane, mask};
  k1_env<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>(g, ws[e], b, A);
}

// Raises the variant's dynamic shared memory limit to its workspace, once;
// every later call returns the first call's error.
template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
static int k1_prepare() {
  static int err = -1;
  if (err < 0)
    err = (int)cudaFuncSetAttribute(
        k1_kernel<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k1_smem_bytes<DR>());
  return err;
}

// Launches the variant; returns k1_prepare's error without launching.
template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
static int k1_run(const K1Args& A, cudaStream_t stream) {
  int err = k1_prepare<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>();
  if (err != 0) return err;
  int blocks = (int)((A.B + K1_ENVS - 1) / K1_ENVS);
  k1_kernel<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>
      <<<blocks, K1_THREADS, k1_smem_bytes<DR>(), stream>>>(A);
  return 0;
}

// Shared bytes per block, threads per block and resident blocks per SM of
// one variant.
template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
static int k1_occupancy_t(int* out) {
  int err = k1_prepare<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>();
  if (err != 0) return err;
  out[0] = (int)k1_smem_bytes<DR>();
  out[1] = K1_THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], k1_kernel<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>, K1_THREADS,
      k1_smem_bytes<DR>());
}

#define K1_BAD_FLAGS ((int)cudaErrorInvalidValue)
#define K1_LAUNCH_ERROR() ((int)cudaGetLastError())

static int k1_upload(const void* blob, size_t size) {
  if (size != sizeof(K1Const)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemcpyToSymbol(c_k1, blob, size);
  if (err != 0) return err;
  return (int)cudaMemcpyToSymbol(g_k1, blob, size);
}

#else  // host build: the card's blocks one after another, each group's
       // lanes one after another at every barrier

#include <vector>

template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
static int k1_run(const K1Args& A, void*) {
  std::vector<Ws<DR>> ws(K1_ENVS);
  for (long b0 = 0; b0 < A.B; b0 += K1_ENVS) {
    load_block<WITH_ENV, WITH_FRESH, DR>(ws.data(), A, b0, 0, 1);
    for (int e = 0; e < K1_ENVS && b0 + e < A.B; ++e)
      k1_env<WITH_ENV, WITH_FRESH, WS_COMPARE, DR>(Grp{0, 0u}, ws[e], b0 + e,
                                                   A);
  }
  return 0;
}

template <bool WITH_ENV, bool WITH_FRESH, bool WS_COMPARE, bool DR>
static int k1_occupancy_t(int* out) {
  out[0] = (int)k1_smem_bytes<DR>();
  out[1] = K1_THREADS;
  out[2] = 0;
  return 0;
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
