// The Riccati step's floor experiment in one launch per sweep: the CUDA
// replacement of the JAX package's Pallas TPU experiment
// tools/exp_sweep_floor.py::sweep (its kernel _kernel, seven variants).
// The arithmetic lives in sweep_floor.cuh; this file holds the kernel and
// its C entry point.
//
// Design: as the Riccati sweep kernel (riccati.cu): one block of 256
// threads runs the serial recursion over H, the value state and each
// step's blocks in dynamic shared memory (52 KB at n = 40, m = 20), each
// product split over the threads one output element at a time, a barrier
// between dependent stages. The TPU experiment's `unroll` (a fori_loop
// knob that leaves the result unchanged) has no counterpart: the step loop
// carries W through shared memory and is not unrolled.
//
// What bounds it: latency, as K4. One SM of 132 works, and each step of
// the gemm variants is ~8 barriers around dot products of length <= n;
// the loop and load variants measure the cost of the step loop, its
// barrier and its loads and stores alone.

#include <cuda_runtime.h>

#include "sweep_floor.cuh"

namespace kmanip {

constexpr int FLOOR_THREADS = 256;
constexpr int FLOOR_MAX_SHARED_BYTES = 232448;  // 227 KB, the H100's per-block limit

__global__ void __launch_bounds__(FLOOR_THREADS)
    sweep_floor_kernel(int variant, int H, int n, int m, const float* __restrict__ AB,
                       const float* __restrict__ cx, const float* __restrict__ cu,
                       const float* __restrict__ cxx, const float* __restrict__ cuu,
                       const float* __restrict__ cux, const float* __restrict__ WT,
                       float* __restrict__ ks, float* __restrict__ Ks) {
  extern __shared__ float sm[];
  sweep_floor_block(threadIdx.x, blockDim.x, BlockSync{}, variant, H, n, m, AB, cx, cu, cxx,
                    cuu, cux, WT, ks, Ks, sm);
}

}  // namespace kmanip

extern "C" {

// Launches one sweep of `variant` (FloorVariant) on `stream`. Returns the
// CUDA error of the attribute call or the launch (0 = launched).
int kmanip_sweep_floor(int variant, int H, int n, int m, const void* AB, const void* cx,
                       const void* cu, const void* cxx, const void* cuu, const void* cux,
                       const void* WT, void* ks, void* Ks, void* stream) {
  using namespace kmanip;
  if (variant < 0 || variant >= FLOOR_N_VARIANTS || n < m) return (int)cudaErrorInvalidValue;
  if (H <= 0) return (int)cudaSuccess;
  const int bytes = floor_layout(n, m).total * (int)sizeof(float);
  if (bytes > FLOOR_MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sweep_floor_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  sweep_floor_kernel<<<1, FLOOR_THREADS, bytes, (cudaStream_t)stream>>>(
      variant, H, n, m, (const float*)AB, (const float*)cx, (const float*)cu, (const float*)cxx,
      (const float*)cuu, (const float*)cux, (const float*)WT, (float*)ks, (float*)Ks);
  return (int)cudaGetLastError();
}

}  // extern "C"
