// Kernel K2: the standalone 72-beam lidar scan of a batch of envs.
//
// Replaces the TPU kernel mujoco_playground_tpu/ops/lidar_pallas.py
// (build_lidar_fn -> _lidar_kernel).  In: xpos (NBODY*3, B), xquat
// (NBODY*4, B); out: (NSITE, B), float32, batch-last.
//
// What bounds it on an H100: operations.  Per env it reads 56 floats and
// writes 72 (512 B), but runs 72 beams x (plane + nbox slab tests), ~27
// FLOP per beam-box pair; at the umaze arena's 6 boxes that is ~14 kFLOP
// per env against 512 B, far above the card's ~20 FLOP/B float32 balance.
// Design: one env per thread, so thread b reads x[i*B + b] and every load
// and store coalesces across the warp; the scene and site constants sit in
// __constant__ memory, which broadcasts when all threads of a warp read the
// same address, as they all do here; the box loop runs over the scene's
// runtime box count.
#include "lidar.cuh"

KCONST LidarConst c_lidar;

// The scan of env b: reads column b of xpos/xquat, writes column b of out.
HD void k2_env(int b, long B, const float* xpos, const float* xquat,
               float* out) {
  float bp[NBODY][3], bq[NBODY][4];
  for (int i = 0; i < NBODY; ++i) {
    for (int k = 0; k < 3; ++k) bp[i][k] = xpos[(3 * i + k) * B + b];
    for (int k = 0; k < 4; ++k) bq[i][k] = xquat[(4 * i + k) * B + b];
  }
  lidar_scan(c_lidar, bp, bq, out + b, B, c_lidar.plane_z);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
    k2_kernel(const float* __restrict__ xpos, const float* __restrict__ xquat,
              float* __restrict__ out, int B) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) k2_env(b, B, xpos, xquat, out);
}

extern "C" {

size_t k2_const_size() { return sizeof(LidarConst); }

int k2_set_constants(const void* blob, size_t size) {
  if (size != sizeof(LidarConst)) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(c_lidar, blob, size);
}

int k2_launch(const float* xpos, const float* xquat, float* out, int B,
              cudaStream_t stream) {
  const int threads = 128;
  if (B > 0)
    k2_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
        xpos, xquat, out, B);
  return (int)cudaGetLastError();
}

}  // extern "C"

#else  // host build: the same per-env program, one env after another

extern "C" {

size_t k2_const_size() { return sizeof(LidarConst); }

int k2_set_constants(const void* blob, size_t size) {
  if (size != sizeof(LidarConst)) return 1;
  memcpy(&c_lidar, blob, size);
  return 0;
}

int k2_launch(const float* xpos, const float* xquat, float* out, int B,
              void*) {
  for (int b = 0; b < B; ++b) k2_env(b, B, xpos, xquat, out);
  return 0;
}

}  // extern "C"

#endif  // __CUDACC__
