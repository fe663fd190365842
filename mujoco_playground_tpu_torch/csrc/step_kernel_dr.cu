// Kernel K1e, sub-slice e of K1: the fused step with per-env
// domain-randomized parameters (the per-env program and its design notes
// are in step_kernel.cuh).
//
// Replaces the TPU kernel mujoco_playground_tpu/ops/step_pallas.py
// (build_step_fn(..., dr_fields=DR_SUPPORTED) -> _step_kernel with its
// _DRView lanes).  Beside K1's inputs it reads dr (DR_ROWS, B): body masses
// and principal inertias, dof damping, armature and friction loss, actuator
// gain and bias, wheel friction and the floor height of each env.  Every
// constant of K1Const derived from them (h_damping, slot_mu, slot_diag, the
// scans' plane_z) is recomputed per env; invweights stay the base model's,
// as in the TPU kernel.  Bound, like K1, by operations: the parameters add
// 340 B per env to K1's 1,184 B.  Built as its own library so nvcc compiles
// it in parallel with step_kernel.cu.
#include "step_kernel.cuh"

extern "C" {

size_t k1e_const_size() { return sizeof(K1Const); }

int k1e_dr_rows() { return DR_ROWS; }

int k1e_set_constants(const void* blob, size_t size) {
  return k1_upload(blob, size);
}

// Launches K1e on the stream (the host build runs it in place).  Returns
// the CUDA error of the launch, 0 on success.  Compiled flag sets:
// <with_env, with_fresh, ws_compare> = <1, 1, 0> (the auto-reset step),
// <1, 0, 0> (the env step) and <0, 0, 0> (the physics step alone: physics
// substeps and delayed observations); any other set returns
// cudaErrorInvalidValue.
int k1e_launch(const float* qpos, const float* qvel, const float* ctrl,
               const float* ws, const float* env_in, const float* dr,
               float* qpos_out, float* qvel_out, float* xpos_out,
               float* xquat_out, float* qacc_out, float* slab, int B,
               int with_env, int with_fresh, int ws_compare, int flags,
               float coll_th, float goal_th, float prog_scale,
               float coll_pen, cudaStream_t stream) {
  K1Args A = {qpos,     qvel,     ctrl,      ws,       env_in,
              dr,       qpos_out, qvel_out,  xpos_out, xquat_out,
              qacc_out, slab,     B,         flags,    coll_th,
              goal_th,  prog_scale, coll_pen};
  int flags3 = (with_env ? 4 : 0) | (with_fresh ? 2 : 0) | (ws_compare ? 1 : 0);
  if ((flags3 != 6 && flags3 != 4 && flags3 != 0) || dr == nullptr)
    return K1_BAD_FLAGS;
  if (B > 0) {
    int err = flags3 == 6   ? k1_run<true, true, false, true>(A, stream)
              : flags3 == 4 ? k1_run<true, false, false, true>(A, stream)
                            : k1_run<false, false, false, true>(A, stream);
    if (err != 0) return err;
  }
  return K1_LAUNCH_ERROR();
}

// As k1_occupancy, for K1e's three flag sets.
int k1e_occupancy(int with_env, int with_fresh, int ws_compare, int* out) {
  int flags3 = (with_env ? 4 : 0) | (with_fresh ? 2 : 0) | (ws_compare ? 1 : 0);
  if (flags3 == 6) return k1_occupancy_t<true, true, false, true>(out);
  if (flags3 == 4) return k1_occupancy_t<true, false, false, true>(out);
  if (flags3 == 0) return k1_occupancy_t<false, false, false, true>(out);
  return K1_BAD_FLAGS;
}

}  // extern "C"
