// Kernel K2: the standalone 72-beam lidar scan of a batch of envs.
//
// Replaces the TPU kernel mujoco_playground_tpu/ops/lidar_pallas.py
// (build_lidar_fn -> _lidar_kernel).  In: xpos (NBODY*3, B), xquat
// (NBODY*4, B) and, optionally, plane_z (B,): each env's floor height
// (domain randomization) in place of the model's; out: (NSITE, B), float32,
// batch-last.  A null plane_z selects the model's floor; the wrapper counts
// the two uses apart.
//
// What bounds it on an H100: operations.  Per env it reads 56 floats and
// writes 72 (512 B), but runs 72 beams x (plane + nbox slab tests), ~27
// FLOP per beam-box pair; at the umaze arena's 6 boxes that is ~14 kFLOP
// per env against 512 B, far above the card's ~20 FLOP/B float32 balance.
// Design: one thread per (beam, env), 72 B threads in all.  A block takes
// K2_BEAMS beams of K2_ENVS consecutive envs, one warp per beam (threadIdx
// .x the env, threadIdx.y the beam).  A thread reads its site's body frame
// (7 floats, x[r*B + b]: the warp's loads coalesce, and the block's other
// beams find the lines in L1), runs lidar_site and writes out[i*B + b]
// (coalesced).  All threads of a warp read the same site's and scene's
// constants, so the __constant__ reads broadcast; the box loop runs over
// the scene's runtime box count.  The beams of an env are independent, so
// nothing is reduced and two launches give the same bits.
#include "lidar.cuh"

#define K2_ENVS 32  // envs per block (a warp)
#define K2_BEAMS 8  // beams per block
#define K2_THREADS (K2_ENVS * K2_BEAMS)

KCONST LidarConst c_lidar;

// Beam i of env b: reads column b of its body's rows of xpos/xquat (and
// plane_z[b] when given), writes out[i*B + b].
HD void k2_beam(int i, long b, long B, const float* xpos, const float* xquat,
                const float* plane_z, float* out) {
  int body = c_lidar.site_body[i];
  float bp[3], bq[4];
#ifdef __CUDACC__
  for (int k = 0; k < 3; ++k) bp[k] = __ldg(xpos + (3 * body + k) * B + b);
  for (int k = 0; k < 4; ++k) bq[k] = __ldg(xquat + (4 * body + k) * B + b);
  float pz = plane_z ? __ldg(plane_z + b) : c_lidar.plane_z;
#else
  for (int k = 0; k < 3; ++k) bp[k] = xpos[(3 * body + k) * B + b];
  for (int k = 0; k < 4; ++k) bq[k] = xquat[(4 * body + k) * B + b];
  float pz = plane_z ? plane_z[b] : c_lidar.plane_z;
#endif
  out[i * B + b] = lidar_site(c_lidar, i, bp, bq, pz);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(K2_THREADS)
    k2_kernel(const float* __restrict__ xpos, const float* __restrict__ xquat,
              const float* __restrict__ plane_z, float* __restrict__ out,
              int B) {
  long b = (long)blockIdx.x * K2_ENVS + threadIdx.x;
  int i = blockIdx.y * K2_BEAMS + threadIdx.y;
  if (b < B && i < NSITE) k2_beam(i, b, B, xpos, xquat, plane_z, out);
}

extern "C" {

size_t k2_const_size() { return sizeof(LidarConst); }

int k2_set_constants(const void* blob, size_t size) {
  if (size != sizeof(LidarConst)) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(c_lidar, blob, size);
}

// plane_z: (B,) floor heights, or null for the model's.
int k2_launch(const float* xpos, const float* xquat, const float* plane_z,
              float* out, int B, cudaStream_t stream) {
  if (B > 0)
    k2_kernel<<<dim3((B + K2_ENVS - 1) / K2_ENVS,
                     (NSITE + K2_BEAMS - 1) / K2_BEAMS),
                dim3(K2_ENVS, K2_BEAMS), 0, stream>>>(xpos, xquat, plane_z,
                                                      out, B);
  return (int)cudaGetLastError();
}

// out[0] shared bytes per block, out[1] threads per block, out[2] resident
// blocks per SM.  Returns the CUDA error, 0 on success.
int k2_occupancy(int* out) {
  out[0] = 0;
  out[1] = K2_THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], k2_kernel, K2_THREADS, 0);
}

}  // extern "C"

#else  // host build: the same per-beam program, beam by beam, env by env

extern "C" {

size_t k2_const_size() { return sizeof(LidarConst); }

int k2_set_constants(const void* blob, size_t size) {
  if (size != sizeof(LidarConst)) return 1;
  memcpy(&c_lidar, blob, size);
  return 0;
}

int k2_launch(const float* xpos, const float* xquat, const float* plane_z,
              float* out, int B, void*) {
  for (int i = 0; i < NSITE; ++i)
    for (int b = 0; b < B; ++b) k2_beam(i, b, B, xpos, xquat, plane_z, out);
  return 0;
}

int k2_occupancy(int* out) {
  out[0] = 0;
  out[1] = K2_THREADS;
  out[2] = 0;
  return 0;
}

}  // extern "C"

#endif  // __CUDACC__
