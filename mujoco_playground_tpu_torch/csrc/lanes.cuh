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

// sin and cos of x by a fixed sequence of float32 operations, the same as
// ops/lanes.py sincos, so that kernel K1 and its plain twin compute the same
// bits on either device (CUDA's sincosf and the host's libm differ from
// PyTorch's CPU kernels in the last bit, and a frame one ulp apart can
// pick another contact point).  x - k pi/2 with k the nearest quadrant, pi/2
// in three parts (Cody and Waite; k pi/2 is exact for |k| < 2^16), then
// cephes' minimax polynomials on [-pi/4, pi/4] and the quadrant's signs.
HD void sincos_k1(float x, float* s, float* c) {
  float k = floorf(x * 6.366197467e-01f + 0.5f);
  float r = ((x - k * 1.570312500e+00f) - k * 4.837512970e-04f) -
            k * 7.549790126e-08f;
  float z = r * r;
  float ps = ((-1.951529557e-04f * z + 8.332161233e-03f) * z -
              1.666665524e-01f) * z * r + r;
  float pc = ((2.443315680e-05f * z - 1.388731645e-03f) * z +
              4.166664556e-02f) * z * z - 0.5f * z + 1.0f;
  float q = k - 4.0f * floorf(k * 0.25f);
  *s = q == 0.0f ? ps : q == 1.0f ? pc : q == 2.0f ? -ps : -pc;
  *c = q == 0.0f ? pc : q == 1.0f ? -ps : q == 2.0f ? -pc : ps;
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
