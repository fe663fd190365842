// Lane groups: G lanes of one warp compute one env together.  Shared by
// kernel K1 (step_model.cuh, G = K1_G) and kernel K3 (newton_kernel.cu,
// G = K3_G).
//
// A program is a sequence of stage() calls: in each, lane l does the items
// l, l + G, ..., then the group waits at __syncwarp.  Work on registers
// (PerLane values) runs in lanes() with no barrier and trades values by
// from_lane (a shuffle).  Code outside
// these calls is uniform: every lane of the group runs it on the same
// values.  The host build (no __CUDACC__) runs each stage's lanes 0..G-1
// one after another, runs uniform code once, and keeps one copy of each
// PerLane value per lane, so it runs the card's partition of the work and
// its reduction order.
#pragma once

#include "lanes.cuh"

// One lane of the group that computes an env; G is a power of two that
// divides 32, so a group never straddles a warp.
template <int G>
struct Group {
  int lane;
  unsigned mask;  // the group's lanes in the warp
};

#ifdef __CUDACC__
#define UNROLL _Pragma("unroll")
HD int popc64(uint64_t x) { return __popcll(x); }
HD int popc32(uint32_t x) { return __popc(x); }
HD int lowest_bit(uint32_t x) { return __ffs(x) - 1; }
#else
#define UNROLL
HD int popc64(uint64_t x) { return __builtin_popcountll(x); }
HD int popc32(uint32_t x) { return __builtin_popcount(x); }
HD int lowest_bit(uint32_t x) { return __builtin_ctz(x); }
#endif

// The group of G lanes that thread tid of a block belongs to.
#ifdef __CUDACC__
template <int G>
__device__ __forceinline__ Group<G> group_of(int tid) {
  int lane = tid % G;
  unsigned mask = G == 32 ? 0xffffffffu
                          : ((1u << G) - 1u) << (tid % 32 - lane);
  return Group<G>{lane, mask};
}
#endif

// One stage: f(lane) does the lane's items (item i goes to lane i % G),
// then the group waits for all its lanes.  A stage reads what earlier
// stages wrote to the workspace and writes locations no other lane of the
// same stage touches; nothing a lane computes outlives its stage except in
// the workspace.  The host build calls f for lanes 0..G-1 in turn, so it
// runs the card's partition and its reduction order.
#ifdef __CUDACC__
template <int G, class F>
__device__ __forceinline__ void stage(const Group<G>& g, F&& f) {
  f(g.lane);
  __syncwarp(g.mask);
}
#else
template <int G, class F>
static inline void stage(const Group<G>&, F&& f) {
  for (int l = 0; l < G; ++l) f(l);
}
#endif

// A stage of one lane: the scalar tails.
template <int G, class F>
HD void single(const Group<G>& g, F&& f) {
  stage(g, [&](int lane) {
    if (lane == 0) f();
  });
}

// A value each lane keeps in a register from one lanes() call to the next;
// the host build, which runs the lanes one after another, keeps one copy
// per lane.
template <class T, int G>
struct PerLaneG {
#ifdef __CUDACC__
  T v;
  __device__ __forceinline__ T& at(int) { return v; }
#else
  T v[G];
  T& at(int lane) { return v[lane]; }
#endif
};

// f(lane) on every lane of the group, with no barrier after it: for work
// on PerLane registers, exchanged with from_lane().  A lane may read
// another lane's registers only where no lane writes them in the same call.
#ifdef __CUDACC__
template <int G, class F>
__device__ __forceinline__ void lanes(const Group<G>& g, F&& f) {
  f(g.lane);
}
// Lane src's value of f (a warp shuffle; every lane of the group calls it).
template <int G, class F>
__device__ __forceinline__ float from_lane(const Group<G>& g, int src,
                                           F&& f) {
  return __shfl_sync(g.mask, f(g.lane), src, G);
}
#else
template <int G, class F>
static inline void lanes(const Group<G>&, F&& f) {
  for (int l = 0; l < G; ++l) f(l);
}
template <int G, class F>
static inline float from_lane(const Group<G>&, int src, F&& f) {
  return f(src);
}
#endif

// Bit l set where f(l) holds, on every lane alike (every lane of the group
// calls it).
template <int G, class F>
HD uint32_t group_ballot(const Group<G>& g, F&& f) {
#ifdef __CUDACC__
  uint32_t m = __ballot_sync(g.mask, f(g.lane)) & g.mask;
  return m >> (__ffs(g.mask) - 1);
#else
  uint32_t m = 0;
  for (int l = 0; l < G; ++l) m |= (f(l) ? 1u : 0u) << l;
  return m;
#endif
}
