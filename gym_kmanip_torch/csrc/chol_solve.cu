// Batched dense SPD solve M x = b in one launch: the CUDA replacement of
// the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_linalg.py::cholesky_solve_pallas. The per-item
// arithmetic is staged.cuh::chol_solve_item's (the fused substep's
// Cholesky-Crout factor and substitutions, in the JAX package's operation
// order), run by a team of lanes: staged_team.cuh::chol_solve_team.
//
// Design: one team per item, lane i holding row i: a half-warp (two items
// per warp) for n <= 16, a warp for 17 <= n <= 24, several items per block
// (KMANIP_CHOL_WARPS warps). The Pallas kernel put the batch on the 128
// lanes; here a block's items are contiguous in M and b, so the block
// copies them into shared memory with consecutive threads on consecutive
// words (cp.async, 16 bytes a thread where the address and n allow it, else
// 4), and each lane reads its row from there. The factor is the team
// substep's (chol_factor_team: right-looking, each lane's row in
// registers, every pivot and column entry broadcast by shuffle); the
// substitutions run in every lane in registers from the factor's packed
// rows in shared memory, and row i's lane stores x[i], so a warp's stores
// are contiguous. A
// template on n, instantiated for every n from 1 to 24 (the Pallas
// kernel's range), so the loops unroll.
//
// No tensor cores: the products are at most 24 wide, in FP32, in
// chol_factor's and chol_solve's fixed order; a TF32 mma would round them
// otherwise, and the staged route is held to the plain version's rounding.
//
// What bounds it: latency. A team's factor is a chain of n pivots, each a
// square root, a division and a shuffle per column entry below it; the
// substitutions ~n^2 dependent multiply-subtracts. The bytes (the lower
// triangle read once, b and x) are ~77 KB at K = 256, n = 10. Items per
// block are a build constant: chip_smoke.py builds the alternatives with -D
// and times them beside these (PERF.md §6).
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

#include <cstdint>

#include "staged_team.cuh"

// Warps per block.
#ifndef KMANIP_CHOL_WARPS
#define KMANIP_CHOL_WARPS 2
#endif

namespace kmanip {

constexpr int CHOL_MAX_N = 24;
constexpr int CHOL_THREADS = 32 * KMANIP_CHOL_WARPS;

// lanes per team and items per block
template <int N>
__host__ __device__ constexpr int chol_lanes() {
  return N <= 16 ? 16 : 32;
}
template <int N>
__host__ __device__ constexpr int chol_items() {
  return CHOL_THREADS / chol_lanes<N>();
}

template <int N>
__global__ void __launch_bounds__(CHOL_THREADS)
    chol_solve_kernel(int K, const float* __restrict__ M, const float* __restrict__ b,
                      float* __restrict__ x) {
  constexpr int S = chol_lanes<N>(), ITEMS = chol_items<N>(), NN = N * N;
  __shared__ __align__(16) float sM[ITEMS * NN];
  __shared__ float sb[ITEMS * N];
  __shared__ float sL[ITEMS][chol_scratch<N>()];
  const int tid = threadIdx.x;
  const long item0 = (long)blockIdx.x * ITEMS;
  const int n_items = K - item0 < ITEMS ? (int)(K - item0) : ITEMS;
  const float* Mb = M + item0 * NN;
  const float* bb = b + item0 * N;
  if (NN % 4 == 0 && (reinterpret_cast<uintptr_t>(Mb) & 15) == 0) {
    for (int e = 4 * tid; e < n_items * NN; e += 4 * CHOL_THREADS) copy_async16(sM + e, Mb + e);
  } else {
    for (int e = tid; e < n_items * NN; e += CHOL_THREADS) copy_async(sM + e, Mb + e);
  }
  for (int e = tid; e < n_items * N; e += CHOL_THREADS) copy_async(sb + e, bb + e);
  copy_commit();
  copy_wait_all();
  __syncthreads();
  // a team past the batch's end runs the block's last item without storing
  // (the half-warp teams of a warp shuffle together)
  const int t = tid / S;
  const int item = t < n_items ? t : n_items - 1;
  chol_solve_team<N>(typename TeamOf<S>::type{tid % S}, sM + item * NN, sb + item * N, sL[t],
                     x + (item0 + item) * N, t < n_items);
}

template <int N>
cudaError_t launch_chol(int n, int K, cudaStream_t s, const float* M, const float* b, float* x) {
  if constexpr (N > CHOL_MAX_N) {
    return cudaErrorInvalidValue;
  } else {
    if (n != N) return launch_chol<N + 1>(n, K, s, M, b, x);
    constexpr int ITEMS = chol_items<N>();
    chol_solve_kernel<N><<<(K + ITEMS - 1) / ITEMS, CHOL_THREADS, 0, s>>>(K, M, b, x);
    return cudaGetLastError();
  }
}

}  // namespace kmanip

extern "C" {

// Solves M x = b for K SPD n x n matrices on `stream`; returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an n outside 1..CHOL_MAX_N (24).
int kmanip_chol_solve(int n, int K, const void* M, const void* b, void* x, void* stream) {
  using namespace kmanip;
  if (n < 1 || n > CHOL_MAX_N) return (int)cudaErrorInvalidValue;
  if (K <= 0) return (int)cudaSuccess;
  return (int)launch_chol<1>(n, K, (cudaStream_t)stream, (const float*)M, (const float*)b,
                             (float*)x);
}

}  // extern "C"
