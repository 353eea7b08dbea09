// What the cooperative kernels (the substep K1, the pick-cost rollout K2,
// the feedback rollout K3, the Riccati sweep K4 and its floor experiment K8)
// are written against: a block barrier, a team of lanes that can sync,
// broadcast and reduce (one warp or one half-warp on the card),
// and an asynchronous global-to-shared copy. On the card these are
// __syncthreads, __syncwarp, __shfl_sync and cp.async. Compiled as host C++
// (the test harness), the copy is a plain load and store, and the harness
// brings its own barrier and team: one thread with no-op syncs, or several
// host threads behind a barrier.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KMANIP_HD __host__ __device__
#else
#include <cmath>
#define KMANIP_HD
#endif

// Phase marks for gym_kmanip_torch/tools/kernel_phases.py, which builds the
// kernels with a prelude that defines them (thread 0 of each block adds the
// clock64 cycles since its last mark to the phase's count). Otherwise they
// compile to nothing.
#ifndef KMANIP_PHASE
#define KMANIP_PHASE(k)
#define KMANIP_PHASE_START()
#define KMANIP_PHASE_STOP()
#endif

namespace kmanip {

#ifdef __CUDACC__
// The block barrier.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// The 32 lanes of one warp. Every lane of the warp calls sync, bcast, max
// and min together (no divergence at the call).
struct WarpTeam {
  static constexpr int SIZE = 32;
  int lane;
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ float bcast(float v, int src) const {
    return __shfl_sync(0xffffffffu, v, src);
  }
  __device__ __forceinline__ float max(float v) const {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
  __device__ __forceinline__ float min(float v) const {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
};

// 16 lanes of one warp: lanes 0-15 are one team, lanes 16-31 another, and
// the shuffles stay inside each half. Both halves of the warp run the same
// code (their branches depend on the lane index and the model only), so
// they meet at every sync, broadcast and max together.
struct HalfWarpTeam {
  static constexpr int SIZE = 16;
  int lane;  // 0-15, within the half
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ float bcast(float v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, 16);
  }
  __device__ __forceinline__ float max(float v) const {
    for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, 16));
    return v;
  }
};

// The team of S lanes: a warp (32) or a half-warp (16).
template <int S>
struct TeamOf;
template <>
struct TeamOf<32> {
  using type = WarpTeam;
};
template <>
struct TeamOf<16> {
  using type = HalfWarpTeam;
};

// *dst = *src, 4 bytes, without waiting: cp.async into shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Waits for this thread's copies; a barrier after it shows every thread's.
__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
#else
inline void copy_async(float* dst, const float* src) { *dst = *src; }
inline void copy_commit() {}
inline void copy_wait_all() {}
#endif

// a * b + c, rounded once: the explicit fused multiply-add, which
// --fmad=false does not split.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
#ifdef __CUDACC__
  return __fmaf_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

// 1 / sqrt(x): on the card the hardware reciprocal square root (within 2
// ulp), on the host the correctly rounded quotient.
__device__ __forceinline__ float rsqrt_fast(float x) {
#ifdef __CUDACC__
  return rsqrtf(x);
#else
  return 1.f / std::sqrt(x);
#endif
}

}  // namespace kmanip
