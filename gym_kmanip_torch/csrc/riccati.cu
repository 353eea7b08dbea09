// The regularized iLQR Riccati backward sweep in one launch: the CUDA
// replacement of the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_riccati.py::riccati_sweep_pallas (default step
// _sweep_kernel_gemm5). The arithmetic lives in riccati.cuh; this file
// holds the kernel and its C entry points.
//
// Design: the recursion over H is serial, so one thread block of 256
// threads runs the whole sweep. The value state W = [Vx | Vxx] and each
// step's blocks stay in shared memory (13 KB at solo width n = 20, m = 10;
// 54 KB at torso width n = 40, m = 20, over the 48 KB static limit, so the
// launcher raises the kernel's dynamic shared-memory limit). Each step's
// small products are split over the block's threads, one output element
// per thread at a time; the m x m factor runs pivot by pivot with a
// barrier after each column scaling and trailing update.
//
// What bounds it: latency, not bytes or FLOPs. One SM of 132 works, and a
// step is a chain of ~2m + 10 barriers around short dot products, so the
// sweep costs about H x (that chain). The inputs are read once (A and B
// per step into shared memory) and only the gains are written.

#include <cuda_runtime.h>

#include "riccati.cuh"

namespace kmanip {

constexpr int RICCATI_THREADS = 256;
constexpr int MAX_SHARED_BYTES = 232448;  // 227 KB, the H100's per-block limit

__global__ void __launch_bounds__(RICCATI_THREADS)
    riccati_kernel(int H, int n, int m, float reg, const float* __restrict__ lam_extra,
                   const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ cx, const float* __restrict__ cu,
                   const float* __restrict__ cxx, const float* __restrict__ cuu,
                   const float* __restrict__ cux, const float* __restrict__ VxT,
                   const float* __restrict__ VxxT, float* __restrict__ ks,
                   float* __restrict__ Ks) {
  extern __shared__ float sm[];
  riccati_sweep_block(threadIdx.x, blockDim.x, BlockSync{}, H, n, m, reg, lam_extra[0], A, B,
                      cx, cu, cxx, cuu, cux, VxT, VxxT, ks, Ks, sm);
}

}  // namespace kmanip

extern "C" {

// Launches the sweep on `stream`; lam_extra is a device scalar. Returns
// the CUDA error of the attribute call or the launch (0 = launched).
int kmanip_riccati(int H, int n, int m, double reg, const void* lam_extra, const void* A,
                   const void* B, const void* cx, const void* cu, const void* cxx,
                   const void* cuu, const void* cux, const void* VxT, const void* VxxT,
                   void* ks, void* Ks, void* stream) {
  using namespace kmanip;
  if (H <= 0) return (int)cudaSuccess;
  const int bytes = riccati_layout(n, m).total * (int)sizeof(float);
  if (bytes > MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(riccati_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  riccati_kernel<<<1, RICCATI_THREADS, bytes, (cudaStream_t)stream>>>(
      H, n, m, (float)reg, (const float*)lam_extra, (const float*)A, (const float*)B,
      (const float*)cx, (const float*)cu, (const float*)cxx, (const float*)cuu,
      (const float*)cux, (const float*)VxT, (const float*)VxxT, (float*)ks, (float*)Ks);
  return (int)cudaGetLastError();
}

}  // extern "C"
