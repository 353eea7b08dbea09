// Device code of the regularized Riccati backward sweep: one thread block
// runs the whole serial recursion over H steps, its threads splitting each
// step's small products. Follows the JAX package's default Pallas step,
// gym_kmanip_tpu/ops/pallas_riccati.py::_sweep_kernel_gemm5, with the
// solve semantics of _chol_solve_rows (equilibration, pivot drop). Kept in
// a header, written against a thread index, a thread count and a barrier,
// so the host test harness runs it as C++ with one thread and a no-op
// barrier and holds it to the plain PyTorch version.
//
// Numerics: float32 throughout, every product in full FP32 (no TF32, no
// bf16 splitting: the JAX package's bf16x3 emulation was a TPU MXU
// workaround, and plain bf16 drove the recursion to NaN).
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KMANIP_HD __host__ __device__
#else
#define KMANIP_HD
#endif

namespace kmanip {

constexpr float PIVOT_FLOOR = 1e-5f;  // pivots of the equilibrated matrix at or below are dropped

#ifdef __CUDACC__
// The block barrier the sweeps are written against (the host harness
// passes a no-op).
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
#endif

// out[r * ldo + c] = sum_i A[i * lda + r] * B[i * ldb + c] for r < R, c < C,
// i < I (A^T B), in block-shared memory: one output element per thread at a
// time, its dot product summed in order. The caller places the barrier.
__device__ inline void block_mm_tn(int tid, int nthr, int R, int C, int I, const float* A,
                                   int lda, const float* B, int ldb, float* out, int ldo) {
  for (int e = tid; e < R * C; e += nthr) {
    const int r = e / C, c = e % C;
    float s = 0.f;
    for (int i = 0; i < I; ++i) s = s + A[i * lda + r] * B[i * ldb + c];
    out[r * ldo + c] = s;
  }
}

// Offsets, in floats, of the sweep's shared working set for state width n
// and control width m (Z = n + m, N1 = n + 1).
struct RiccatiLayout {
  int AB, W, GW, Q, qv, Qs, S, dsc, piv, keep, C, Kk, V, red, total;
};

KMANIP_HD inline RiccatiLayout riccati_layout(int n, int m) {
  const int Z = n + m, N1 = n + 1;
  RiccatiLayout L;
  int o = 0;
  L.AB = o;   o += n * Z;    // [A_t B_t]
  L.W = o;    o += n * N1;   // value state [Vx | Vxx]
  L.GW = o;   o += Z * N1;   // [A B]^T W; reused for the next value state
  L.Q = o;    o += Z * Z;    // [[Qxx, -], [Qux, Quu]] before symmetrizing
  L.qv = o;   o += Z;        // [Qx; Qu]
  L.Qs = o;   o += m * m;    // symmetrized Quu (reg included, lift not)
  L.S = o;    o += m * m;    // equilibrated matrix, then its factor (lower)
  L.dsc = o;  o += m;        // equilibration scales
  L.piv = o;  o += m;        // factor diagonal (1 where dropped)
  L.keep = o; o += m;        // 1 = pivot kept, 0 = dropped
  L.C = o;    o += m * N1;   // [Qu | Qux]
  L.Kk = o;   o += m * N1;   // gains [k | K]
  L.V = o;    o += m * N1;   // Quu_eff Kk + C
  L.red = o;  o += 2 * m;    // per-row max |Quu| and Gershgorin bound
  L.total = o;
  return L;
}

// X = (Q + lam I)^-1 RHS for symmetric Q (m, m) and RHS (m, r), all
// row-major in block-shared memory, by the JAX package's rules
// (_chol_solve_rows): Jacobi equilibration to a unit diagonal (the
// diagonal includes lam, the off-diagonal does not), a Cholesky factor
// whose pivots at or below PIVOT_FLOOR are dropped (zero gain in that
// direction), and the two substitutions. Right-looking factorization:
// thread-parallel column scaling and trailing update per pivot; one thread
// per right-hand-side column for the substitutions. S, dsc, piv and keep
// are work arrays of m x m, m, m and m floats.
template <class Sync>
__device__ void chol_solve_dropping(int tid, int nthr, Sync sync, int m, int r, const float* Q,
                                    float lam, const float* RHS, float* X, float* S, float* dsc,
                                    float* piv, float* keep) {
  for (int i = tid; i < m; i += nthr) dsc[i] = 1.f / sqrtf(fmaxf(Q[i * m + i] + lam, 1e-30f));
  sync();
  for (int e = tid; e < m * m; e += nthr) {
    const int i = e / m, j = e % m;
    S[e] = i == j ? 1.f : Q[e] * dsc[i] * dsc[j];
  }
  sync();
  for (int j = 0; j < m; ++j) {
    const float pivot = S[j * m + j];
    const bool kept = pivot > PIVOT_FLOOR;
    const float d = kept ? sqrtf(pivot) : 1.f;
    if (tid == 0) {
      piv[j] = d;
      keep[j] = kept ? 1.f : 0.f;
    }
    for (int i = j + 1 + tid; i < m; i += nthr) S[i * m + j] = kept ? S[i * m + j] / d : 0.f;
    sync();
    const int rest = m - 1 - j;
    for (int e = tid; e < rest * rest; e += nthr) {
      const int i = j + 1 + e / rest, k = j + 1 + e % rest;
      if (k <= i) S[i * m + k] = S[i * m + k] - S[i * m + j] * S[k * m + j];
    }
    sync();
  }
  for (int c = tid; c < r; c += nthr) {
    for (int i = 0; i < m; ++i) {
      float s = RHS[i * r + c] * dsc[i];
      for (int t = 0; t < i; ++t) s = s - S[i * m + t] * X[t * r + c];
      X[i * r + c] = keep[i] != 0.f ? s / piv[i] : 0.f;
    }
    for (int i = m - 1; i >= 0; --i) {
      float s = X[i * r + c];
      for (int t = i + 1; t < m; ++t) s = s - S[t * m + i] * X[t * r + c];
      X[i * r + c] = keep[i] != 0.f ? s / piv[i] : 0.f;
    }
    for (int i = 0; i < m; ++i) X[i * r + c] = X[i * r + c] * dsc[i];
  }
  sync();
}

// The whole sweep: (A (H,n,n), B (H,n,m), cx (H,n), cu (H,m), cxx (H,n,n),
// cuu (H,m,m), cux (H,m,n), Vx_T (n), Vxx_T (n,n)) -> ks (H,m), Ks (H,m,n).
// Per step t = H-1 .. 0, with W = [Vx | Vxx]:
//   GW = [A B]^T W, GWG = GW[:, 1:] [A B]; Q-blocks = cost blocks + GWG,
//   Quu += reg I, symmetrized;
//   lam = 1e-5 amax + max(0, 1e-4 amax - gersh_min) + lam_extra amax;
//   Kk = -(Quu + lam I)^-1 [Qu | Qux] (chol_solve_dropping);
//   [Vx | Vxx] = [Qx | Qxx] + (Kk^T (Quu_eff Kk + C) + C^T Kk)[1:, :],
//   Vxx symmetrized.
// `sm` holds riccati_layout(n, m).total floats.
template <class Sync>
__device__ void riccati_sweep_block(int tid, int nthr, Sync sync, int H, int n, int m, float reg,
                                    float lam_extra, const float* A, const float* B,
                                    const float* cx, const float* cu, const float* cxx,
                                    const float* cuu, const float* cux, const float* VxT,
                                    const float* VxxT, float* ks, float* Ks, float* sm) {
  const RiccatiLayout L = riccati_layout(n, m);
  const int Z = n + m, N1 = n + 1;
  float *AB = sm + L.AB, *W = sm + L.W, *GW = sm + L.GW, *Q = sm + L.Q, *qv = sm + L.qv;
  float *Qs = sm + L.Qs, *C = sm + L.C, *Kk = sm + L.Kk, *V = sm + L.V, *red = sm + L.red;

  for (int e = tid; e < n * N1; e += nthr) {
    const int i = e / N1, c = e % N1;
    W[e] = c == 0 ? VxT[i] : VxxT[i * n + c - 1];
  }
  sync();
  for (int t = H - 1; t >= 0; --t) {
    const float* At = A + (long)t * n * n;
    const float* Bt = B + (long)t * n * m;
    for (int e = tid; e < n * Z; e += nthr) {
      const int i = e / Z, c = e % Z;
      AB[e] = c < n ? At[i * n + c] : Bt[i * m + c - n];
    }
    sync();
    block_mm_tn(tid, nthr, Z, N1, n, AB, Z, W, N1, GW, N1);  // GW = [A B]^T W
    sync();
    for (int e = tid; e < Z * Z; e += nthr) {  // the Q blocks
      const int rr = e / Z, c = e % Z;
      if (rr < n && c >= n) continue;  // Qxu is never read
      float s = 0.f;
      for (int i = 0; i < n; ++i) s = s + GW[rr * N1 + 1 + i] * AB[i * Z + c];
      if (rr < n)
        Q[e] = cxx[((long)t * n + rr) * n + c] + s;
      else if (c < n)
        Q[e] = cux[((long)t * m + rr - n) * n + c] + s;
      else
        Q[e] = (cuu[((long)t * m + rr - n) * m + c - n] + s) + (rr == c ? reg : 0.f);
    }
    for (int rr = tid; rr < Z; rr += nthr)
      qv[rr] = (rr < n ? cx[(long)t * n + rr] : cu[(long)t * m + rr - n]) + GW[rr * N1];
    sync();
    for (int e = tid; e < m * m; e += nthr) {
      const int i = e / m, j = e % m;
      Qs[e] = 0.5f * (Q[(n + i) * Z + n + j] + Q[(n + j) * Z + n + i]);
    }
    for (int e = tid; e < m * N1; e += nthr) {
      const int i = e / N1, c = e % N1;
      C[e] = c == 0 ? qv[n + i] : Q[(n + i) * Z + c - 1];
    }
    sync();
    for (int i = tid; i < m; i += nthr) {  // per-row max |Quu| and Gershgorin bound
      float amax = 0.f, asum = 0.f;
      for (int j = 0; j < m; ++j) {
        const float a = fabsf(Qs[i * m + j]);
        amax = fmaxf(amax, a);
        asum = asum + a;
      }
      const float dg = Qs[i * m + i];
      red[i] = amax;
      red[m + i] = dg - (asum - fabsf(dg));
    }
    sync();
    float amax = red[0], gmin = red[m];
    for (int i = 1; i < m; ++i) {
      amax = fmaxf(amax, red[i]);
      gmin = fminf(gmin, red[m + i]);
    }
    const float lam = 1e-5f * amax + fmaxf(0.f, 1e-4f * amax - gmin) + lam_extra * amax;

    chol_solve_dropping(tid, nthr, sync, m, N1, Qs, lam, C, Kk, sm + L.S, sm + L.dsc,
                        sm + L.piv, sm + L.keep);
    for (int e = tid; e < m * N1; e += nthr) {  // negate; V = Quu_eff Kk + C; write gains
      const int i = e / N1, c = e % N1;
      float s = 0.f;
      for (int k = 0; k < m; ++k) s = s - Qs[i * m + k] * Kk[k * N1 + c];
      const float kk = -Kk[e];
      V[e] = (s + lam * kk) + C[e];
      if (c == 0)
        ks[(long)t * m + i] = kk;
      else
        Ks[((long)t * m + i) * n + c - 1] = kk;
    }
    sync();
    for (int e = tid; e < m * N1; e += nthr) Kk[e] = -Kk[e];
    sync();
    for (int e = tid; e < n * N1; e += nthr) {  // [Qx | Qxx] + M[1:, :]
      const int rr = e / N1, c = e % N1;
      float s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < m; ++i) s1 = s1 + Kk[i * N1 + rr + 1] * V[i * N1 + c];
      for (int i = 0; i < m; ++i) s2 = s2 + C[i * N1 + rr + 1] * Kk[i * N1 + c];
      GW[e] = (c == 0 ? qv[rr] : Q[rr * Z + c - 1]) + (s1 + s2);
    }
    sync();
    for (int e = tid; e < n * N1; e += nthr) {  // Vxx symmetrized
      const int rr = e / N1, c = e % N1;
      W[e] = c == 0 ? GW[e] : 0.5f * (GW[e] + GW[(c - 1) * N1 + rr + 1]);
    }
    sync();
  }
}

}  // namespace kmanip
