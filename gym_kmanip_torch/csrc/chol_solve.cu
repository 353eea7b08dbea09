// Batched dense SPD solve M x = b in one launch: the CUDA replacement of
// the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_linalg.py::cholesky_solve_pallas. The per-item
// code is staged.cuh::chol_solve_item: the fused substep's Cholesky-Crout
// factor and substitutions (substep.cuh::chol_factor, chol_solve), in the
// JAX package's operation order.
//
// Design: one thread per item, 128 threads per block, grid ceil(K/128),
// the ragged edge masked; a template on n, instantiated for every n from 1
// to 24 (the Pallas kernel's range), so the loops unroll. Each thread keeps
// its packed factor (n(n+1)/2 floats: 55 at n = 10, 210 at n = 20) in
// registers and local memory.
//
// What bounds it: latency. The factor is a chain of ~n^3/6 dependent
// multiply-subtracts and n square roots, the substitutions ~n^2 more; at
// K = 256 two SMs of 132 are busy, and the bytes (the n x n matrix read
// once) are ~100 KB.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

#include "staged.cuh"

namespace kmanip {

constexpr int CHOL_MAX_N = 24;

template <int N>
__global__ void __launch_bounds__(128)
    chol_solve_kernel(int K, const float* __restrict__ M, const float* __restrict__ b,
                      float* __restrict__ x) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  chol_solve_item<N>(k, M, b, x);
}

template <int N>
cudaError_t launch_chol(int n, int K, cudaStream_t s, const float* M, const float* b, float* x) {
  if constexpr (N > CHOL_MAX_N) {
    return cudaErrorInvalidValue;
  } else {
    if (n != N) return launch_chol<N + 1>(n, K, s, M, b, x);
    chol_solve_kernel<N><<<(K + 127) / 128, 128, 0, s>>>(K, M, b, x);
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
