// Kernel K1, sub-slices a-d: the fused step with the model's own parameters
// (the per-env program and its design notes are in step_kernel.cuh).
//
// Replaces the TPU kernel mujoco_playground_tpu/ops/step_pallas.py
// (build_step_fn -> _step_kernel) built without dr_fields.
#include "step_kernel.cuh"

extern "C" {

size_t k1_const_size() { return sizeof(K1Const); }

int k1_set_constants(const void* blob, size_t size) {
  return k1_upload(blob, size);
}

// Launches K1 on the stream (the host build runs it in place).  Returns the
// CUDA error of the launch, 0 on success.  Only the flag sets that the port
// calls are compiled: <with_env, with_fresh, ws_compare> = <1, 1, 0> (the
// auto-reset step), <1, 0, 0> (the env step), <0, 0, 1> (the settle
// template) and <0, 0, 0> (the physics step alone: every physics substep
// but the last, and the step under delayed observations); any other set
// returns cudaErrorInvalidValue.
int k1_launch(const float* qpos, const float* qvel, const float* ctrl,
              const float* ws, const float* env_in, float* qpos_out,
              float* qvel_out, float* xpos_out, float* xquat_out,
              float* qacc_out, float* slab, int B, int with_env,
              int with_fresh, int ws_compare, int flags, float coll_th,
              float goal_th, float prog_scale, float coll_pen,
              cudaStream_t stream) {
  K1Args A = {qpos,     qvel,     ctrl,      ws,       env_in,
              nullptr,  qpos_out, qvel_out,  xpos_out, xquat_out,
              qacc_out, slab,     B,         flags,    coll_th,
              goal_th,  prog_scale, coll_pen};
  int flags3 = (with_env ? 4 : 0) | (with_fresh ? 2 : 0) | (ws_compare ? 1 : 0);
  if (flags3 != 6 && flags3 != 4 && flags3 != 1 && flags3 != 0)
    return K1_BAD_FLAGS;
  if (B > 0) {
    int err = flags3 == 6   ? k1_run<true, true, false, false>(A, stream)
              : flags3 == 4 ? k1_run<true, false, false, false>(A, stream)
              : flags3 == 1 ? k1_run<false, false, true, false>(A, stream)
                            : k1_run<false, false, false, false>(A, stream);
    if (err != 0) return err;
  }
  return K1_LAUNCH_ERROR();
}

// Of the compiled flag set's kernel: out[0] shared bytes per block, out[1]
// threads per block, out[2] resident blocks per SM (0 in the host build).
// Returns the CUDA error, 0 on success.
int k1_occupancy(int with_env, int with_fresh, int ws_compare, int* out) {
  int flags3 = (with_env ? 4 : 0) | (with_fresh ? 2 : 0) | (ws_compare ? 1 : 0);
  if (flags3 == 6) return k1_occupancy_t<true, true, false, false>(out);
  if (flags3 == 4) return k1_occupancy_t<true, false, false, false>(out);
  if (flags3 == 1) return k1_occupancy_t<false, false, true, false>(out);
  if (flags3 == 0) return k1_occupancy_t<false, false, false, false>(out);
  return K1_BAD_FLAGS;
}

}  // extern "C"
