// Device code of the Riccati step's floor experiment: the backward sweep
// cut down to seven cumulative variants, to bisect what one step of the
// sweep costs on the card. Follows the JAX package's Pallas experiment
// tools/exp_sweep_floor.py::_kernel variant for variant, on the block
// primitives of the Riccati sweep kernel as it was first ported (one block,
// the value state W = [Vx | Vxx] in shared memory, block_mm_tn and
// element-per-thread loops with a barrier after each), so the floors it
// reports are that design's floors.
// Written against a thread index, a thread count and a barrier, so the
// host test harness runs it as C++ with one thread and a no-op barrier.
//
// Per step t = H-1 .. 0, on AB (H, n, n+m), cx (H, n), cu (H, m),
// cxx (H, n, n), cuu (H, m, m), cux (H, m, n), W from WT (n, 1+n):
//   loop          W += 1e-9 t; ks[t], Ks[t] = W[:m, 0], W[:m, 1:]
//   load1         W += 1e-9 cxx[t,0,0]; the same outputs
//   load1nostore  W += 1e-9 cxx[t,0,0]; only row 0 of the outputs, every
//                 step: ks[0] = 1e-9 W[0, :m], Ks[0] = 1e-9 W[:m, 1:]
//                 (the other rows are zero)
//   mem           W += 1e-9 (cx + cu + cxx + cuu + cux + AB)[t, 0..];
//                 ks[t] = cu[t] + W[:m, 0], Ks[t] = cux[t] + W[:m, 1:]
//   gemm          GW = AB^T W, GWG = GW[:, 1:] AB, the Q blocks;
//                 Kk = -[Qu | Qux] / (diag Quu + lam), lam = 1e-6;
//                 W = [Qx | Qxx] + (Kk^T (Quu Kk + lam Kk + C) + C^T Kk)[1:]
//   trans         gemm with Quu and the new Vxx symmetrized
//   gersh         trans with lam = 1e-5 amax + max(0, 1e-4 amax - gersh_min)
// (the Jacobi gains of the experiment, not K4's Cholesky solve).
#pragma once

#include "team.cuh"

namespace kmanip {

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

enum FloorVariant {
  FLOOR_LOOP = 0,
  FLOOR_LOAD1,
  FLOOR_LOAD1NOSTORE,
  FLOOR_MEM,
  FLOOR_GEMM,
  FLOOR_TRANS,
  FLOOR_GERSH,
  FLOOR_N_VARIANTS
};

// Offsets, in floats, of the experiment's shared working set (Z = n + m,
// N1 = n + 1).
struct FloorLayout {
  int W, AB, GW, Q, qv, Qs, C, Kk, V, red, total;
};

KMANIP_HD inline FloorLayout floor_layout(int n, int m) {
  const int Z = n + m, N1 = n + 1;
  FloorLayout L;
  int o = 0;
  L.W = o;   o += n * N1;  // value state [Vx | Vxx]
  L.AB = o;  o += n * Z;   // AB_t
  L.GW = o;  o += Z * N1;  // AB^T W; reused for the next value state
  L.Q = o;   o += Z * Z;   // [[Qxx, -], [Qux, Quu]]
  L.qv = o;  o += Z;       // [Qx; Qu]
  L.Qs = o;  o += m * m;   // Quu, symmetrized in trans and gersh
  L.C = o;   o += m * N1;  // [Qu | Qux]
  L.Kk = o;  o += m * N1;  // gains [k | K]
  L.V = o;   o += m * N1;  // Quu Kk + lam Kk + C
  L.red = o; o += 2 * m;   // per-row max |Quu| and Gershgorin bound
  L.total = o;
  return L;
}

template <class Sync>
__device__ void sweep_floor_block(int tid, int nthr, Sync sync, int variant, int H, int n, int m,
                                  const float* ABg, const float* cx, const float* cu,
                                  const float* cxx, const float* cuu, const float* cux,
                                  const float* WT, float* ks, float* Ks, float* sm) {
  const FloorLayout L = floor_layout(n, m);
  const int Z = n + m, N1 = n + 1;
  float *W = sm + L.W, *AB = sm + L.AB, *GW = sm + L.GW, *Q = sm + L.Q, *qv = sm + L.qv;
  float *Qs = sm + L.Qs, *C = sm + L.C, *Kk = sm + L.Kk, *V = sm + L.V, *red = sm + L.red;

  for (int e = tid; e < n * N1; e += nthr) W[e] = WT[e];
  if (variant == FLOOR_LOAD1NOSTORE) {  // only row 0 is ever written
    for (int e = m + tid; e < H * m; e += nthr) ks[e] = 0.f;
    for (int e = m * n + tid; e < H * m * n; e += nthr) Ks[e] = 0.f;
  }
  sync();
  for (int t = H - 1; t >= 0; --t) {
    if (variant <= FLOOR_MEM) {
      float inc;
      if (variant == FLOOR_LOOP) {
        inc = 1e-9f * (float)t;
      } else if (variant == FLOOR_MEM) {
        inc = (((((cx[(long)t * n] + cu[(long)t * m]) + cxx[(long)t * n * n]) +
                 cuu[(long)t * m * m]) + cux[(long)t * m * n]) + ABg[(long)t * n * Z]) * 1e-9f;
      } else {
        inc = cxx[(long)t * n * n] * 1e-9f;
      }
      for (int e = tid; e < n * N1; e += nthr) {
        const int i = e / N1, c = e % N1;
        const float w = W[e];
        if (variant == FLOOR_LOAD1NOSTORE) {
          if (i == 0 && c < m) ks[c] = w * 1e-9f;
          if (i < m && c >= 1) Ks[i * n + c - 1] = w * 1e-9f;
        } else if (i < m) {
          const bool mem = variant == FLOOR_MEM;
          if (c == 0)
            ks[(long)t * m + i] = mem ? cu[(long)t * m + i] + w : w;
          else
            Ks[((long)t * m + i) * n + c - 1] = mem ? cux[((long)t * m + i) * n + c - 1] + w : w;
        }
        W[e] = w + inc;
      }
      sync();
      continue;
    }

    const float* ABt = ABg + (long)t * n * Z;
    for (int e = tid; e < n * Z; e += nthr) AB[e] = ABt[e];
    sync();
    block_mm_tn(tid, nthr, Z, N1, n, AB, Z, W, N1, GW, N1);  // GW = AB^T W
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
        Q[e] = cuu[((long)t * m + rr - n) * m + c - n] + s;
    }
    for (int rr = tid; rr < Z; rr += nthr)
      qv[rr] = (rr < n ? cx[(long)t * n + rr] : cu[(long)t * m + rr - n]) + GW[rr * N1];
    sync();
    const bool sym = variant >= FLOOR_TRANS;
    for (int e = tid; e < m * m; e += nthr) {
      const int i = e / m, j = e % m;
      const float q = Q[(n + i) * Z + n + j];
      Qs[e] = sym ? 0.5f * (q + Q[(n + j) * Z + n + i]) : q;
    }
    for (int e = tid; e < m * N1; e += nthr) {
      const int i = e / N1, c = e % N1;
      C[e] = c == 0 ? qv[n + i] : Q[(n + i) * Z + c - 1];
    }
    sync();
    float lam = 1e-6f;
    if (variant == FLOOR_GERSH) {
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
      lam = 1e-5f * amax + fmaxf(0.f, 1e-4f * amax - gmin);
    }
    for (int e = tid; e < m * N1; e += nthr) {  // Jacobi gains
      const int i = e / N1;
      Kk[e] = -(C[e] / (Qs[i * m + i] + lam));
    }
    sync();
    for (int e = tid; e < m * N1; e += nthr) {  // V = Quu Kk + lam Kk + C; write gains
      const int i = e / N1, c = e % N1;
      float s = 0.f;
      for (int k = 0; k < m; ++k) s = s + Qs[i * m + k] * Kk[k * N1 + c];
      V[e] = (s + lam * Kk[e]) + C[e];
      if (c == 0)
        ks[(long)t * m + i] = Kk[e];
      else
        Ks[((long)t * m + i) * n + c - 1] = Kk[e];
    }
    sync();
    for (int e = tid; e < n * N1; e += nthr) {  // [Qx | Qxx] + (Kk^T V + C^T Kk)[1:, :]
      const int rr = e / N1, c = e % N1;
      float s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < m; ++i) s1 = s1 + Kk[i * N1 + rr + 1] * V[i * N1 + c];
      for (int i = 0; i < m; ++i) s2 = s2 + C[i * N1 + rr + 1] * Kk[i * N1 + c];
      GW[e] = (c == 0 ? qv[rr] : Q[rr * Z + c - 1]) + (s1 + s2);
    }
    sync();
    for (int e = tid; e < n * N1; e += nthr) {  // Vxx symmetrized in trans and gersh
      const int rr = e / N1, c = e % N1;
      W[e] = sym && c > 0 ? 0.5f * (GW[e] + GW[(c - 1) * N1 + rr + 1]) : GW[e];
    }
    sync();
  }
}

}  // namespace kmanip
