// The Riccati step's floor experiment in one launch per sweep: the CUDA
// replacement of the JAX package's Pallas TPU experiment
// tools/exp_sweep_floor.py::sweep (its kernel _kernel, seven variants).
// The arithmetic lives in sweep_floor.cuh; this file holds the kernel and
// its C entry point.
//
// Design: the Riccati sweep kernel's (riccati.cu), since each variant is
// K4's step with parts cut away: one block runs the serial recursion over
// H, with K4's shared working set (~80 KB at n = 40, m = 20, so the
// launcher raises the dynamic shared-memory limit), K4's thread counts and
// register tiles (512 threads and 4 x 2 tiles at (40, 20), the
// experiment's widths; 256 threads and 2 x 2 tiles at runtime widths,
// m <= 32), and K4's prefetch of the next step. The variant is a template
// parameter, so each variant compiles to its own kernel with nothing of
// the others. The TPU experiment's `unroll` (a fori_loop knob that leaves
// the result unchanged) has no counterpart.
//
// What bounds it: latency, as K4. One SM of 132 works; a step of the gemm
// variants is six block barriers around the tiled products, the one-warp
// symmetrization and the elementwise gains; the loop and load variants
// measure the step loop, its barrier, and K4's loads and stores alone.

#include <cuda_runtime.h>

#include "sweep_floor.cuh"

namespace kmanip {

constexpr int FLOOR_MAX_SHARED_BYTES = 232448;  // 227 KB, the H100's per-block limit

template <int VAR, int NT, int MT, int TR, int TC, int THREADS>
__global__ void __launch_bounds__(THREADS)
    sweep_floor_kernel(int H, int n, int m, const float* __restrict__ AB,
                       const float* __restrict__ cx, const float* __restrict__ cu,
                       const float* __restrict__ cxx, const float* __restrict__ cuu,
                       const float* __restrict__ cux, const float* __restrict__ WT,
                       float* __restrict__ ks, float* __restrict__ Ks) {
  extern __shared__ float sm[];
  sweep_floor_block<VAR, NT, MT, TR, TC>(threadIdx.x, THREADS, WarpTeam{(int)(threadIdx.x % 32)},
                                         BlockSync{}, H, n, m, AB, cx, cu, cxx, cuu, cux, WT, ks,
                                         Ks, sm);
}

template <int VAR, int NT, int MT, int TR, int TC, int THREADS>
cudaError_t launch_floor(int H, int n, int m, const void* const* in, void* ks, void* Ks,
                         cudaStream_t stream) {
  const int bytes = riccati_layout(n, m).total * (int)sizeof(float);
  if (bytes > FLOOR_MAX_SHARED_BYTES) return cudaErrorInvalidValue;
  auto kernel = sweep_floor_kernel<VAR, NT, MT, TR, TC, THREADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, THREADS, bytes, stream>>>(
      H, n, m, (const float*)in[0], (const float*)in[1], (const float*)in[2],
      (const float*)in[3], (const float*)in[4], (const float*)in[5], (const float*)in[6],
      (float*)ks, (float*)Ks);
  return cudaGetLastError();
}

// The variant `variant` at K4's instantiation for the widths.
template <int VAR>
cudaError_t launch_variant(int variant, int H, int n, int m, const void* const* in, void* ks,
                           void* Ks, cudaStream_t stream) {
  if constexpr (VAR >= FLOOR_N_VARIANTS) {
    return cudaErrorInvalidValue;
  } else {
    if (variant != VAR) return launch_variant<VAR + 1>(variant, H, n, m, in, ks, Ks, stream);
    if (n == 40 && m == 20)
      return launch_floor<VAR, 40, 20, 4, 2, 512>(H, n, m, in, ks, Ks, stream);
    return launch_floor<VAR, 0, 0, 2, 2, 256>(H, n, m, in, ks, Ks, stream);
  }
}

}  // namespace kmanip

extern "C" {

// Launches one sweep of `variant` (FloorVariant) on `stream`. Returns the
// CUDA error of the attribute call or the launch (0 = launched);
// cudaErrorInvalidValue for an unknown variant, m outside 1..min(n, 32) or
// too little shared memory.
int kmanip_sweep_floor(int variant, int H, int n, int m, const void* AB, const void* cx,
                       const void* cu, const void* cxx, const void* cuu, const void* cux,
                       const void* WT, void* ks, void* Ks, void* stream) {
  using namespace kmanip;
  if (variant < 0 || variant >= FLOOR_N_VARIANTS || m < 1 || n < m || m > RICCATI_MAX_M)
    return (int)cudaErrorInvalidValue;
  if (H <= 0) return (int)cudaSuccess;
  const void* in[7] = {AB, cx, cu, cxx, cuu, cux, WT};
  return (int)launch_variant<0>(variant, H, n, m, in, ks, Ks, (cudaStream_t)stream);
}

}  // extern "C"
