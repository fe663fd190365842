// Scalar helpers shared by kernels K1 (step_kernel.cu) and K2
// (lidar_kernel.cu): vectors and quaternions as plain float arrays in one
// thread.  These are the dense counterparts of ops/lanes.py.  The HD and
// KCONST macros below serve every kernel source, K3's too.
//
// The same sources also compile as host C++ (no __CUDACC__): HD functions
// become plain inline functions and the constant blocks plain globals, so
// tests/test_torch_kernel_source.py can run each kernel's per-env program
// on the CPU against its plain PyTorch twin.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "robot_dims.h"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define KCONST __constant__
#else
#define HD static inline
#define KCONST static
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#endif

HD void v3cross(const float* a, const float* b, float* out) {
  float o0 = a[1] * b[2] - a[2] * b[1];
  float o1 = a[2] * b[0] - a[0] * b[2];
  float o2 = a[0] * b[1] - a[1] * b[0];
  out[0] = o0;
  out[1] = o1;
  out[2] = o2;
}

HD float v3dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Hamilton product of [w, x, y, z] quaternions.
HD void qmul(const float* a, const float* b, float* out) {
  float w = a[0] * b[0] - (a[1] * b[1] + a[2] * b[2] + a[3] * b[3]);
  float x = a[0] * b[1] + a[1] * b[0] + (a[2] * b[3] - a[3] * b[2]);
  float y = a[0] * b[2] + a[2] * b[0] + (a[3] * b[1] - a[1] * b[3]);
  float z = a[0] * b[3] + a[3] * b[0] + (a[1] * b[2] - a[2] * b[1]);
  out[0] = w;
  out[1] = x;
  out[2] = y;
  out[3] = z;
}

// Rotate v by q: v + 2 * (w * (u x v) + u x (u x v)).
HD void qrot(const float* q, const float* v, float* out) {
  float uv[3], uuv[3];
  v3cross(q + 1, v, uv);
  v3cross(q + 1, uv, uuv);
  for (int k = 0; k < 3; ++k) out[k] = v[k] + 2.0f * (q[0] * uv[k] + uuv[k]);
}

// 3x3 rotation matrix (row-major) of q.
HD void qmat(const float* q, float* R) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.0f - 2.0f * (y * y + z * z);
  R[1] = 2.0f * (x * y - w * z);
  R[2] = 2.0f * (x * z + w * y);
  R[3] = 2.0f * (x * y + w * z);
  R[4] = 1.0f - 2.0f * (x * x + z * z);
  R[5] = 2.0f * (y * z - w * x);
  R[6] = 2.0f * (x * z - w * y);
  R[7] = 2.0f * (y * z + w * x);
  R[8] = 1.0f - 2.0f * (x * x + y * y);
}
