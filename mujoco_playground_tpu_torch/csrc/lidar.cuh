// The 72-beam rangefinder scan of one env, shared by kernel K2
// (lidar_kernel.cu) and the fused scans of kernel K1 (step_kernel.cu).
//
// Semantics of MuJoCo rangefinders, as ops/lidar.py lidar_rows: distance
// along each site's +Z to the floor plane (finite extents) or the nearest
// scene AABB (slab test, running min over boxes), -1 on no hit, positive
// readings clamped to the sensor cutoff.  The sentinels BIG, EPS and PEPS
// and the no-hit test t >= BIG are those of the JAX kernel, in float32.
#pragma once

#include "lanes.cuh"

#define LIDAR_BIG 1e10f
#define LIDAR_EPS 1e-9f
#define LIDAR_PEPS 1e-12f

// Mirror of ops/lidar.py LidarConst (ctypes): the model's scan constants.
struct LidarConst {
  int nbox;
  int site_body[NSITE];
  float site_pos[NSITE][3];
  float site_quat[NSITE][4];
  float cutoff[NSITE];
  float box_lo[MAX_BOXES][3];
  float box_hi[MAX_BOXES][3];
  float plane_z;
  float plane_half[2];
};

// One beam from origin o along direction d, with the floor at plane_z
// (L.plane_z, or one env's randomized floor height in kernel K1e).
HD float lidar_beam(const LidarConst& L, const float* o, const float* d,
                    float cutoff, float plane_z) {
  // floor plane, finite extents (MuJoCo ray_plane)
  bool dz_ok = fabsf(d[2]) > LIDAR_PEPS;
  float t_plane = (plane_z - o[2]) / (dz_ok ? d[2] : LIDAR_PEPS);
  bool on_plane = (fabsf(o[0] + t_plane * d[0]) <= L.plane_half[0]) &&
                  (fabsf(o[1] + t_plane * d[1]) <= L.plane_half[1]);
  if (!(dz_ok && t_plane > 0.0f && on_plane)) t_plane = LIDAR_BIG;

  // AABB slab tests with a running min over boxes
  bool par[3];
  float inv[3];
  for (int c = 0; c < 3; ++c) {
    par[c] = fabsf(d[c]) <= LIDAR_EPS;
    inv[c] = 1.0f / (fabsf(d[c]) > LIDAR_EPS ? d[c] : LIDAR_EPS);
  }
  float t_best = LIDAR_BIG;
  for (int k = 0; k < L.nbox; ++k) {
    float tmin = -LIDAR_BIG, tmax = LIDAR_BIG;
    bool inside_par = true;
    for (int c = 0; c < 3; ++c) {
      float lo = L.box_lo[k][c], hi = L.box_hi[k][c];
      float t1 = (lo - o[c]) * inv[c];
      float t2 = (hi - o[c]) * inv[c];
      tmin = fmaxf(tmin, par[c] ? -LIDAR_BIG : fminf(t1, t2));
      tmax = fminf(tmax, par[c] ? LIDAR_BIG : fmaxf(t1, t2));
      inside_par = inside_par && (!par[c] || (o[c] > lo && o[c] < hi));
    }
    bool hit = (tmax >= tmin) && (tmax > 0.0f) && inside_par;
    float t_box = hit ? (tmin > 0.0f ? tmin : tmax) : LIDAR_BIG;
    t_best = fminf(t_best, t_box);
  }
  float t = fminf(t_plane, t_best);
  return t >= LIDAR_BIG ? -1.0f : fminf(t, cutoff);
}

// The scan of site i given its body's world frame (pos bp, quat bq).
HD float lidar_site(const LidarConst& L, int i, const float* bp,
                    const float* bq, float plane_z) {
  float o[3], q[4];
  qrot(bq, L.site_pos[i], o);
  for (int k = 0; k < 3; ++k) o[k] = bp[k] + o[k];
  // beam direction = third column of R(body_quat * site_quat)
  qmul(bq, L.site_quat[i], q);
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float d[3] = {2.0f * (x * z + w * y), 2.0f * (y * z - w * x),
                1.0f - 2.0f * (x * x + y * y)};
  return lidar_beam(L, o, d, L.cutoff[i], plane_z);
}

// All NSITE readings given every body's frame: xpos [NBODY][3], xquat
// [NBODY][4], and the floor height.  Reading i goes to out[i * stride].
HD void lidar_scan(const LidarConst& L, const float (*xpos)[3],
                   const float (*xquat)[4], float* out, long stride,
                   float plane_z) {
  for (int i = 0; i < NSITE; ++i) {
    int b = L.site_body[i];
    out[i * stride] = lidar_site(L, i, xpos[b], xquat[b], plane_z);
  }
}
