// The regularized iLQR Riccati backward sweep in one launch: the CUDA
// replacement of the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_riccati.py::riccati_sweep_pallas (default step
// _sweep_kernel_gemm5). The arithmetic lives in riccati.cuh; this file
// holds the kernel and its C entry points.
//
// Design: the recursion over H is serial, so one thread block runs the
// whole sweep (riccati.cuh has the step's five phases). The value state
// W = [Vx | Vxx] and each step's blocks stay in shared memory, and the
// next step's inputs are copied into a second shared stage (cp.async) while
// the current step computes: 50 KB at solo width n = 20, m = 10; 80 KB at
// torso width n = 40, m = 20, over the 48 KB static limit, so the launcher
// raises the kernel's dynamic shared-memory limit. The widths are template
// parameters, instantiated for (20, 10) with 256 threads and 2 x 2 output
// tiles and for (40, 20) with 512 threads and 4 x 2 tiles; every other
// width runs the same code with runtime widths (256 threads, 2 x 2 tiles),
// m <= 32. The products run in full FP32 on the CUDA cores: the sweep is
// held to float64 at 1e-4 of the largest gain, which TF32 would not hold.
//
// What bounds it: latency and one warp's instruction issue, not bytes or
// FLOPs. One SM of 132 works, and a step is a chain of five block barriers
// (the first port had ~2m + 10) around the two tiled products, the
// one-warp factor (a shuffle per pivot and per column entry, no barrier)
// and the shuffled substitutions. The inputs are read once, a step ahead,
// and only the gains are written.

#include <cuda_runtime.h>

#include "riccati.cuh"

namespace kmanip {

constexpr int MAX_SHARED_BYTES = 232448;  // 227 KB, the H100's per-block limit

template <int NT, int MT, int TR, int TC, int THREADS>
__global__ void __launch_bounds__(THREADS)
    riccati_kernel(int H, int n, int m, float reg, const float* __restrict__ lam_extra,
                   const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ cx, const float* __restrict__ cu,
                   const float* __restrict__ cxx, const float* __restrict__ cuu,
                   const float* __restrict__ cux, const float* __restrict__ VxT,
                   const float* __restrict__ VxxT, float* __restrict__ ks,
                   float* __restrict__ Ks) {
  extern __shared__ float sm[];
  riccati_sweep_block<NT, MT, TR, TC>(threadIdx.x, THREADS, WarpTeam{(int)(threadIdx.x % 32)},
                                      BlockSync{}, H, n, m, reg, lam_extra[0], A, B, cx, cu,
                                      cxx, cuu, cux, VxT, VxxT, ks, Ks, sm);
}

template <int NT, int MT, int TR, int TC, int THREADS>
cudaError_t launch_riccati(int H, int n, int m, float reg, const void* lam_extra,
                           const void* A, const void* B, const void* cx, const void* cu,
                           const void* cxx, const void* cuu, const void* cux, const void* VxT,
                           const void* VxxT, void* ks, void* Ks, cudaStream_t stream) {
  const int bytes = riccati_layout(n, m).total * (int)sizeof(float);
  if (bytes > MAX_SHARED_BYTES) return cudaErrorInvalidValue;
  auto kernel = riccati_kernel<NT, MT, TR, TC, THREADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, THREADS, bytes, stream>>>(
      H, n, m, reg, (const float*)lam_extra, (const float*)A, (const float*)B,
      (const float*)cx, (const float*)cu, (const float*)cxx, (const float*)cuu,
      (const float*)cux, (const float*)VxT, (const float*)VxxT, (float*)ks, (float*)Ks);
  return cudaGetLastError();
}

}  // namespace kmanip

extern "C" {

// Launches the sweep on `stream`; lam_extra is a device scalar. Returns
// the CUDA error of the attribute call or the launch (0 = launched);
// cudaErrorInvalidValue for m outside 1..32 or too little shared memory.
int kmanip_riccati(int H, int n, int m, double reg, const void* lam_extra, const void* A,
                   const void* B, const void* cx, const void* cu, const void* cxx,
                   const void* cuu, const void* cux, const void* VxT, const void* VxxT,
                   void* ks, void* Ks, void* stream) {
  using namespace kmanip;
  if (n < 1 || m < 1 || m > RICCATI_MAX_M) return (int)cudaErrorInvalidValue;
  if (H <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float r = (float)reg;
  if (n == 20 && m == 10)
    return (int)launch_riccati<20, 10, 2, 2, 256>(H, n, m, r, lam_extra, A, B, cx, cu, cxx,
                                                  cuu, cux, VxT, VxxT, ks, Ks, st);
  if (n == 40 && m == 20)
    return (int)launch_riccati<40, 20, 4, 2, 512>(H, n, m, r, lam_extra, A, B, cx, cu, cxx,
                                                  cuu, cux, VxT, VxxT, ks, Ks, st);
  return (int)launch_riccati<0, 0, 2, 2, 256>(H, n, m, r, lam_extra, A, B, cx, cu, cxx, cuu,
                                              cux, VxT, VxxT, ks, Ks, st);
}

}  // extern "C"
