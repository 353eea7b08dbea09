// Device code of the regularized Riccati backward sweep: one thread block
// runs the whole serial recursion over H steps. Follows the JAX package's
// default Pallas step, gym_kmanip_tpu/ops/pallas_riccati.py::
// _sweep_kernel_gemm5, with the solve semantics of _chol_solve_rows
// (equilibration, pivot drop). Kept in a header, written against a thread
// index, a thread count, a block barrier and a team of lanes (team.cuh),
// so the host test harness runs it as C++ with one thread, or with several
// host threads behind a barrier, and holds it to the plain PyTorch version.
//
// Per step (Z = n + m, N1 = n + 1), five block barriers:
//   P1  GW = [A B]^T W in register tiles of TR x TC outputs, and
//       [Qx; Qu] = [cx; cu] + GW[:, 0] (also column 0 of C = [Qu | Qux]);
//   P2  the Q blocks in register tiles: Qxx, C's Qux columns, raw Quu
//       (+ reg on the diagonal);
//   P3  one warp: Quu symmetrized, the row maxima and Gershgorin bounds
//       (warp reductions), lam, the equilibration and the m x m factor,
//       each lane's row in registers, every pivot and column entry passed
//       by a shuffle: no barrier and no shared memory inside the factor;
//   P4  the warps split the N1 right-hand-side columns (up to four at once
//       each): both substitutions with lanes over rows and each solved
//       element broadcast by a shuffle, the gains Kk = -(...) written out,
//       and V = Quu_eff Kk + C for the same columns, summed as the back
//       substitution solves each element;
//   P5  the next value state [Vx | Vxx], Vxx symmetrized in the same pass
//       (each element of the lower triangle computes itself and its mirror).
// While one warp runs P3, the others copy the inputs of step t - 1 (A, B,
// cxx, cux, cuu, cx, cu) into the other half of a double-buffered shared
// stage (cp.async): none of them depends on the recursion. P1, P2, P3's
// symmetrization and lift, P5 and the stage are device functions
// (riccati_gw, riccati_q_blocks, riccati_symmetrize, riccati_value_update,
// riccati_stage) that the floor experiment K8 (sweep_floor.cuh) runs too.
//
// Numerics: float32 throughout, every product in full FP32 (no TF32, no
// bf16 splitting: the JAX package's bf16x3 emulation was a TPU MXU
// workaround, and plain bf16 drove the recursion to NaN). Each output's dot
// product is summed in order by one thread with fused multiply-adds; the
// factor scales by the pivots' reciprocal square roots, the back
// substitution runs column-wise, and V's sums run in the order the back
// substitution solves (last row first). So the sweep rounds differently
// from the plain version, and is held to it at 1e-4 of the largest gain
// (and to float64).
#pragma once

#include "team.cuh"

namespace kmanip {

constexpr float PIVOT_FLOOR = 1e-5f;  // pivots of the equilibrated matrix at or below are dropped
constexpr int RICCATI_MAX_M = 32;     // the factor runs in one warp, lanes over rows
constexpr int SOLVE_COLS = 4;         // right-hand-side columns a warp solves at once

// Offsets, in floats, of the sweep's shared working set for state width n
// and control width m (Z = n + m, N1 = n + 1).
struct RiccatiLayout {
  int W, GW, qv, Qxx, C, Qr, Qs, S, dsc, inv, keep, Kk, V, lam, stage, stage_size, total;
  // offsets inside one stage half
  int sAB, sxx, sux, suu, sx, su;
};

KMANIP_HD inline RiccatiLayout riccati_layout(int n, int m) {
  const int Z = n + m, N1 = n + 1;
  RiccatiLayout L;
  int o = 0;
  L.W = o;    o += n * N1;   // value state [Vx | Vxx]
  L.GW = o;   o += Z * N1;   // [A B]^T W
  L.qv = o;   o += Z;        // [Qx; Qu]
  L.Qxx = o;  o += n * n;    // Qxx
  L.C = o;    o += m * N1;   // [Qu | Qux]
  L.Qr = o;   o += m * m;    // Quu with reg, before symmetrizing
  L.Qs = o;   o += m * m;    // symmetrized Quu
  L.S = o;    o += m * m;    // equilibrated matrix, then its factor (lower)
  L.dsc = o;  o += m;        // equilibration scales
  L.inv = o;  o += m;        // reciprocal of the factor's diagonal
  L.keep = o; o += m;        // 1 = pivot kept, 0 = dropped
  L.Kk = o;   o += m * N1;   // gains [k | K]
  L.V = o;    o += m * N1;   // Quu_eff Kk + C
  L.lam = o;  o += 1;        // the step's lift
  int s = 0;
  L.sAB = s; s += n * Z;     // [A_t B_t]
  L.sxx = s; s += n * n;
  L.sux = s; s += m * n;
  L.suu = s; s += m * m;
  L.sx = s;  s += n;
  L.su = s;  s += m;
  L.stage_size = s;
  L.stage = o; o += 2 * s;
  L.total = o;
  return L;
}

// out(r, c) = sum_i A[i * sAi + r * sAr] * B[i * sBi + c * sBc], i < I, for
// the TR x TC outputs at (r0, c0) clipped to R x C, each summed in order;
// epi(r, c, sum) stores one.
template <int TR, int TC, class Epi>
__device__ __forceinline__ void tile_mm(int r0, int c0, int R, int C, int I, const float* A,
                                        int sAi, int sAr, const float* B, int sBi, int sBc,
                                        Epi epi) {
  float acc[TR][TC];
  int ra[TR], cb[TC];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    ra[a] = (r0 + a < R ? r0 + a : R - 1) * sAr;
#pragma unroll
    for (int b = 0; b < TC; ++b) acc[a][b] = 0.f;
  }
#pragma unroll
  for (int b = 0; b < TC; ++b) cb[b] = (c0 + b < C ? c0 + b : C - 1) * sBc;
  for (int i = 0; i < I; ++i) {
    float av[TR], bv[TC];
#pragma unroll
    for (int a = 0; a < TR; ++a) av[a] = A[i * sAi + ra[a]];
#pragma unroll
    for (int b = 0; b < TC; ++b) bv[b] = B[i * sBi + cb[b]];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < TC; ++b) acc[a][b] = fma_rn(av[a], bv[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int b = 0; b < TC; ++b)
      if (r0 + a < R && c0 + b < C) epi(r0 + a, c0 + b, acc[a][b]);
}

// The equilibrated factor of (Qs + lam I), Qs m x m symmetric and
// row-major in shared memory, by the JAX package's rules
// (_chol_solve_rows): Jacobi scales to a unit diagonal (the diagonal
// includes lam, the off-diagonal does not), a right-looking Cholesky whose
// pivots at or below PIVOT_FLOOR are dropped (zero gain in that
// direction). One team; each lane holds its rows in registers (row i in
// lane i % SIZE), and each pivot and each scaled column entry is broadcast
// to the team, so a pivot costs no sync. Writes S's strict lower part (the
// factor), dsc (the scales), inv (the reciprocal pivots) and keep (1 or
// 0). MM >= m is a compile-time bound: the register rows have MM entries.
template <int MM, class Team>
__device__ void team_factor(const Team& team, int m, const float* Qs, float lam, float* S,
                            float* dsc, float* inv, float* keep) {
  constexpr int SZ = Team::SIZE;
  constexpr int RPL = (MM + SZ - 1) / SZ;  // rows per lane
  const int lane = team.lane;
  float a[RPL][MM], di[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * SZ;
#pragma unroll
    for (int j = 0; j < MM; ++j) a[r][j] = (i < m && j < m) ? Qs[i * m + j] : 0.f;
    di[r] = i < m ? rsqrt_fast(fmaxf(Qs[i * m + i] + lam, 1e-30f)) : 0.f;
    if (i < m) dsc[i] = di[r];
  }
#pragma unroll
  for (int j = 0; j < MM; ++j) {
    if (j >= m) break;
    const float dj = team.bcast(di[j / SZ], j % SZ);
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = lane + r * SZ;
      a[r][j] = i == j ? 1.f : a[r][j] * di[r] * dj;
    }
  }
#pragma unroll
  for (int j = 0; j < MM; ++j) {
    if (j >= m) break;
    const float pivot = team.bcast(a[j / SZ][j], j % SZ);
    const bool kept = pivot > PIVOT_FLOOR;
    const float id = kept ? rsqrt_fast(pivot) : 0.f;  // 1 / L[j][j]; 0 drops the direction
    float l[RPL];
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = lane + r * SZ;
      l[r] = (i > j && i < m) ? a[r][j] * id : 0.f;
      a[r][j] = i > j ? l[r] : a[r][j];
    }
    if (lane == j % SZ) {
      inv[j] = id;
      keep[j] = kept ? 1.f : 0.f;
    }
#pragma unroll
    for (int k = j + 1; k < MM; ++k) {
      if (k >= m) break;
      const float lk = team.bcast(l[k / SZ], k % SZ);
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const int i = lane + r * SZ;
        a[r][k] = fma_rn(i >= k ? -l[r] : 0.f, lk, a[r][k]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * SZ;
#pragma unroll
    for (int k = 0; k < MM; ++k)
      if (k < i && i < m) S[i * m + k] = a[r][k];
  }
}

// Columns c0 .. c0 + nc - 1 (nc <= SOLVE_COLS) of X = sign (Qs + lam I)^-1
// RHS from team_factor's output: the forward and back substitutions with
// lanes over rows, each solved element broadcast to the team; each lane
// keeps its rows and columns of the factor in registers. RHS and X are
// m x ld row-major, and each row of X is written by the lane that owns it.
// At each step t of the back substitution, solved(t, x) sees the broadcast
// solution elements x[g] (before the equilibration scale). Every lane of
// the team calls this.
template <int MM, class Team, class Solved>
__device__ void team_solve_cols(const Team& team, int m, int c0, int nc, const float* RHS,
                                float* X, int ld, float sign, const float* S, const float* dsc,
                                const float* inv, const float* keep, Solved solved) {
  constexpr int SZ = Team::SIZE;
  constexpr int RPL = (MM + SZ - 1) / SZ;  // rows per lane
  float s[RPL][SOLVE_COLS], lrow[RPL][MM], lcol[RPL][MM], it[MM];
#pragma unroll
  for (int t = 0; t < MM; ++t) it[t] = (t < m && keep[t] != 0.f) ? inv[t] : 0.f;
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = team.lane + r * SZ;
#pragma unroll
    for (int t = 0; t < MM; ++t) {
      lrow[r][t] = (i < m && t < i) ? S[i * m + t] : 0.f;
      lcol[r][t] = (t < m && i < t) ? S[t * m + i] : 0.f;
    }
#pragma unroll
    for (int g = 0; g < SOLVE_COLS; ++g)
      s[r][g] = (i < m && g < nc) ? RHS[i * ld + c0 + g] * dsc[i] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < MM; ++t) {  // L y = D b
    if (t >= m) break;
    float x[SOLVE_COLS];
#pragma unroll
    for (int g = 0; g < SOLVE_COLS; ++g) x[g] = team.bcast(s[t / SZ][g] * it[t], t % SZ);
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = team.lane + r * SZ;
#pragma unroll
      for (int g = 0; g < SOLVE_COLS; ++g) {  // lrow[r][t] is 0 unless t < i
        const float u = fma_rn(-lrow[r][t], x[g], s[r][g]);
        s[r][g] = i == t ? x[g] : u;
      }
    }
  }
#pragma unroll
  for (int t = MM - 1; t >= 0; --t) {  // L^T z = y
    if (t >= m) continue;
    float x[SOLVE_COLS];
#pragma unroll
    for (int g = 0; g < SOLVE_COLS; ++g) x[g] = team.bcast(s[t / SZ][g] * it[t], t % SZ);
    solved(t, x);
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = team.lane + r * SZ;
#pragma unroll
      for (int g = 0; g < SOLVE_COLS; ++g) {  // lcol[r][t] is 0 unless i < t
        const float u = fma_rn(-lcol[r][t], x[g], s[r][g]);
        s[r][g] = i == t ? x[g] : u;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = team.lane + r * SZ;
    if (i >= m) continue;
#pragma unroll
    for (int g = 0; g < SOLVE_COLS; ++g)
      if (g < nc) X[i * ld + c0 + g] = sign * (s[r][g] * dsc[i]);
  }
}

// The inputs of step t into stage half `st`, without waiting. Row i of A_t
// is at A + (t n + i) lda, of B_t at B + (t n + i) ldb: A (H, n, n) and B
// (H, n, m) have lda = n and ldb = m; one (H, n, n + m) array [A B] has
// B = A + n and lda = ldb = n + m.
__device__ __forceinline__ void riccati_stage(int tid, int nthr, int t, int n, int m,
                                              const RiccatiLayout& L, float* st,
                                              const float* A, int lda, const float* B, int ldb,
                                              const float* cx, const float* cu,
                                              const float* cxx, const float* cuu,
                                              const float* cux) {
  const int Z = n + m;
  const float* At = A + (long)t * n * lda;
  const float* Bt = B + (long)t * n * ldb;
  for (int e = tid; e < n * Z; e += nthr) {
    const int i = e / Z, c = e % Z;
    copy_async(st + L.sAB + e, c < n ? At + i * lda + c : Bt + i * ldb + c - n);
  }
  for (int e = tid; e < n * n; e += nthr) copy_async(st + L.sxx + e, cxx + (long)t * n * n + e);
  for (int e = tid; e < m * n; e += nthr) copy_async(st + L.sux + e, cux + (long)t * m * n + e);
  for (int e = tid; e < m * m; e += nthr) copy_async(st + L.suu + e, cuu + (long)t * m * m + e);
  for (int e = tid; e < n; e += nthr) copy_async(st + L.sx + e, cx + (long)t * n + e);
  for (int e = tid; e < m; e += nthr) copy_async(st + L.su + e, cu + (long)t * m + e);
  copy_commit();
}

// P1: GW = [A B]^T W in register tiles, from the stage's [A B] (AB); [Qx;
// Qu] = [cx; cu] + GW[:, 0] into qv, and Qu into C's column 0.
template <int TR, int TC>
__device__ __forceinline__ void riccati_gw(int tid, int nthr, int n, int m, const float* AB,
                                           const float* sx, const float* su, const float* W,
                                           float* GW, float* qv, float* C) {
  const int Z = n + m, N1 = n + 1;
  const int tc = (N1 + TC - 1) / TC, tiles = ((Z + TR - 1) / TR) * tc;
  for (int e = tid; e < tiles; e += nthr) {
    tile_mm<TR, TC>((e / tc) * TR, (e % tc) * TC, Z, N1, n, AB, Z, 1, W, N1, 1,
                    [&](int r, int c, float s) {
                      GW[r * N1 + c] = s;
                      if (c == 0) {
                        const float q = (r < n ? sx[r] : su[r - n]) + s;
                        qv[r] = q;
                        if (r >= n) C[(r - n) * N1] = q;
                      }
                    });
  }
}

// P2: the Q blocks, GW[:, 1:] [A B] plus the costs, in register tiles:
// Qxx, C's Qux columns, and raw Quu with reg on its diagonal into Qr.
template <int TR, int TC>
__device__ __forceinline__ void riccati_q_blocks(int tid, int nthr, int n, int m, float reg,
                                                 const float* AB, const float* GW,
                                                 const float* sxx, const float* sux,
                                                 const float* suu, float* Qxx, float* C,
                                                 float* Qr) {
  const int Z = n + m, N1 = n + 1;
  const int xx_tc = (n + TC - 1) / TC, xx_tiles = ((n + TR - 1) / TR) * xx_tc;
  const int u_tc = (Z + TC - 1) / TC, u_tiles = ((m + TR - 1) / TR) * u_tc;
  for (int e = tid; e < xx_tiles + u_tiles; e += nthr) {
    if (e < xx_tiles) {
      tile_mm<TR, TC>((e / xx_tc) * TR, (e % xx_tc) * TC, n, n, n, GW + 1, 1, N1, AB, Z, 1,
                      [&](int r, int c, float s) { Qxx[r * n + c] = sxx[r * n + c] + s; });
    } else {
      const int f = e - xx_tiles;
      tile_mm<TR, TC>((f / u_tc) * TR, (f % u_tc) * TC, m, Z, n, GW + n * N1 + 1, 1, N1, AB, Z,
                      1, [&](int i, int c, float s) {
                        if (c < n)
                          C[i * N1 + 1 + c] = sux[i * n + c] + s;
                        else
                          Qr[i * m + c - n] = (suu[i * m + c - n] + s) + (i == c - n ? reg : 0.f);
                      });
    }
  }
}

// P3's first part, on one team: Qs = (Qr + Qr^T) / 2, each lane its rows;
// with LIFT also the row maxima of |Qs| and the Gershgorin bounds, reduced
// over the team, and the returned lift lam = 1e-5 amax + max(0, 1e-4 amax -
// gersh_min) + lam_extra amax (every lane has it). Without LIFT, returns 0.
// MM >= m is a compile-time bound.
template <int MM, bool LIFT, class Team>
__device__ __forceinline__ float riccati_symmetrize(const Team& team, int m, const float* Qr,
                                                    float* Qs, float lam_extra) {
  constexpr int RPL = (MM + Team::SIZE - 1) / Team::SIZE;
  float amax = 0.f, gmin = 3.402823466e38f;  // identities of max |.| and min
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = team.lane + r * Team::SIZE;
    if (i >= m) continue;
    float row[MM], col[MM];
    const float qii = Qr[i * m + i];
#pragma unroll
    for (int j = 0; j < MM; ++j) {
      row[j] = j < m ? Qr[i * m + j] : 0.f;
      col[j] = j < m ? Qr[j * m + i] : 0.f;
    }
    float ra = 0.f, asum = 0.f;
#pragma unroll
    for (int j = 0; j < MM; ++j) {
      if (j >= m) break;
      const float q = 0.5f * (row[j] + col[j]);
      Qs[i * m + j] = q;
      const float a = fabsf(q);
      ra = fmaxf(ra, a);
      asum = asum + a;
    }
    const float dg = 0.5f * (qii + qii);
    amax = fmaxf(amax, ra);
    gmin = fminf(gmin, dg - (asum - fabsf(dg)));
  }
  if (!LIFT) return 0.f;
  amax = team.max(amax);
  gmin = team.min(gmin);
  return 1e-5f * amax + fmaxf(0.f, 1e-4f * amax - gmin) + lam_extra * amax;
}

// P5: the next value state [Vx | Vxx] = [Qx | Qxx] + (Kk^T V + C^T Kk)[1:, :]:
// each element of Vxx's lower triangle computes itself and its mirror in
// one pass, and writes their mean to both (SYM) or each to its own place.
template <bool SYM>
__device__ __forceinline__ void riccati_value_update(int tid, int nthr, int n, int m,
                                                     const float* qv, const float* Qxx,
                                                     const float* C, const float* Kk,
                                                     const float* V, float* W) {
  const int N1 = n + 1;
  const int items = n + n * (n + 1) / 2;
  for (int e = tid; e < items; e += nthr) {
    if (e < n) {
      float s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < m; ++i) {
        s1 = fma_rn(Kk[i * N1 + e + 1], V[i * N1], s1);
        s2 = fma_rn(C[i * N1 + e + 1], Kk[i * N1], s2);
      }
      W[e * N1] = qv[e] + (s1 + s2);
      continue;
    }
    const int p = e - n;
    int rr = (int)((sqrtf(8.f * (float)p + 1.f) - 1.f) * 0.5f);
    while ((rr + 1) * (rr + 2) / 2 <= p) ++rr;
    while (rr * (rr + 1) / 2 > p) --rr;
    const int cc = p - rr * (rr + 1) / 2;  // rr >= cc
    float a1 = 0.f, a2 = 0.f, b1 = 0.f, b2 = 0.f;
    for (int i = 0; i < m; ++i) {
      const float kr = Kk[i * N1 + rr + 1], kc = Kk[i * N1 + cc + 1];
      a1 = fma_rn(kr, V[i * N1 + cc + 1], a1);
      a2 = fma_rn(C[i * N1 + rr + 1], kc, a2);
      b1 = fma_rn(kc, V[i * N1 + rr + 1], b1);
      b2 = fma_rn(C[i * N1 + cc + 1], kr, b2);
    }
    const float a = Qxx[rr * n + cc] + (a1 + a2);
    const float b = Qxx[cc * n + rr] + (b1 + b2);
    W[rr * N1 + cc + 1] = SYM ? 0.5f * (a + b) : a;
    W[cc * N1 + rr + 1] = SYM ? 0.5f * (a + b) : b;
  }
}

// The whole sweep: (A (H,n,n), B (H,n,m), cx (H,n), cu (H,m), cxx (H,n,n),
// cuu (H,m,m), cux (H,m,n), Vx_T (n), Vxx_T (n,n)) -> ks (H,m), Ks (H,m,n).
// Per step t = H-1 .. 0, with W = [Vx | Vxx]:
//   GW = [A B]^T W, GWG = GW[:, 1:] [A B]; Q-blocks = cost blocks + GWG,
//   Quu += reg I, symmetrized;
//   lam = 1e-5 amax + max(0, 1e-4 amax - gersh_min) + lam_extra amax;
//   Kk = -(Quu + lam I)^-1 [Qu | Qux] (team_factor, team_solve_cols);
//   [Vx | Vxx] = [Qx | Qxx] + (Kk^T (Quu_eff Kk + C) + C^T Kk)[1:, :],
//   Vxx symmetrized.
// NT, MT: the widths, or 0 for runtime widths n_rt, m_rt (m <= 32);
// TR x TC: the register tile of the two products. The team is the warp of
// thread tid (lane tid % SIZE), and nthr a multiple of its SIZE. `sm`
// holds riccati_layout(n, m).total floats.
template <int NT, int MT, int TR, int TC, class Team, class Sync>
__device__ void riccati_sweep_block(int tid, int nthr, const Team& team, Sync sync, int H,
                                    int n_rt, int m_rt, float reg, float lam_extra,
                                    const float* A, const float* B, const float* cx,
                                    const float* cu, const float* cxx, const float* cuu,
                                    const float* cux, const float* VxT, const float* VxxT,
                                    float* ks, float* Ks, float* sm) {
  const int n = NT ? NT : n_rt, m = MT ? MT : m_rt;
  const int N1 = n + 1;
  const RiccatiLayout L = riccati_layout(n, m);
  float *W = sm + L.W, *GW = sm + L.GW, *qv = sm + L.qv, *Qxx = sm + L.Qxx, *C = sm + L.C;
  float *Qr = sm + L.Qr, *Qs = sm + L.Qs, *S = sm + L.S, *dsc = sm + L.dsc, *inv = sm + L.inv;
  float *keep = sm + L.keep, *Kk = sm + L.Kk, *V = sm + L.V, *lam_s = sm + L.lam;
  const int warp = tid / Team::SIZE, n_warps = nthr / Team::SIZE;
  constexpr int MM = MT ? MT : RICCATI_MAX_M;  // compile-time bound on m
  constexpr int RPL = (MM + Team::SIZE - 1) / Team::SIZE;

  for (int e = tid; e < n * N1; e += nthr) {
    const int i = e / N1, c = e % N1;
    W[e] = c == 0 ? VxT[i] : VxxT[i * n + c - 1];
  }
  riccati_stage(tid, nthr, H - 1, n, m, L, sm + L.stage + ((H - 1) & 1) * L.stage_size, A, n, B,
                m, cx, cu, cxx, cuu, cux);

  KMANIP_PHASE_START();
  for (int t = H - 1; t >= 0; --t) {
    copy_wait_all();
    sync();
    KMANIP_PHASE(0);  // the copies' wait, the barrier
    const float* st = sm + L.stage + (t & 1) * L.stage_size;
    const float *AB = st + L.sAB, *sxx = st + L.sxx, *sux = st + L.sux, *suu = st + L.suu;
    const float *sx = st + L.sx, *su = st + L.su;

    // P1: GW = [A B]^T W; [Qx; Qu] and C's column 0
    riccati_gw<TR, TC>(tid, nthr, n, m, AB, sx, su, W, GW, qv, C);
    sync();
    KMANIP_PHASE(1);
    // P2: the Q blocks, GW[:, 1:] [A B] plus the costs
    riccati_q_blocks<TR, TC>(tid, nthr, n, m, reg, AB, GW, sxx, sux, suu, Qxx, C, Qr);
    sync();
    KMANIP_PHASE(2);
    // P3: one warp symmetrizes Quu, lifts it and factors it
    if (warp == 0) {
      const float lam = riccati_symmetrize<MM, true>(team, m, Qr, Qs, lam_extra);
      if (team.lane == 0) lam_s[0] = lam;
      team_factor<MM>(team, m, Qs, lam, S, dsc, inv, keep);
    }
    // meanwhile the other warps copy step t - 1's inputs into the stage
    // half that P1 and P2 of step t + 1 read (the only warp copies after
    // its factor)
    if (t > 0 && (n_warps == 1 || warp > 0)) {
      const int skip = n_warps == 1 ? 0 : Team::SIZE;
      riccati_stage(tid - skip, nthr - skip, t - 1, n, m, L,
                    sm + L.stage + ((t - 1) & 1) * L.stage_size, A, n, B, m, cx, cu, cxx, cuu,
                    cux);
    }
    sync();
    KMANIP_PHASE(3);
    // P4: the gains, column groups over the warps; V = Quu_eff Kk + C for
    // the same columns, summed as the back substitution solves each row
    const float lam = lam_s[0];
    for (int c0 = warp * SOLVE_COLS; c0 < N1; c0 += n_warps * SOLVE_COLS) {
      const int nc = N1 - c0 < SOLVE_COLS ? N1 - c0 : SOLVE_COLS;
      float vs[RPL][SOLVE_COLS], qrow[RPL][MM], dk[MM];
#pragma unroll
      for (int k = 0; k < MM; ++k) dk[k] = k < m ? dsc[k] : 0.f;
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const int i = team.lane + r * Team::SIZE;
#pragma unroll
        for (int k = 0; k < MM; ++k) qrow[r][k] = (i < m && k < m) ? Qs[i * m + k] : 0.f;
#pragma unroll
        for (int g = 0; g < SOLVE_COLS; ++g) vs[r][g] = 0.f;
      }
      team_solve_cols<MM>(team, m, c0, nc, C, Kk, N1, -1.f, S, dsc, inv, keep,
                          [&](int k, const float(&x)[SOLVE_COLS]) {
#pragma unroll
                            for (int r = 0; r < RPL; ++r)
#pragma unroll
                              for (int g = 0; g < SOLVE_COLS; ++g)
                                vs[r][g] = fma_rn(qrow[r][k], -(x[g] * dk[k]), vs[r][g]);
                          });
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const int i = team.lane + r * Team::SIZE;
        if (i >= m) continue;
#pragma unroll
        for (int g = 0; g < SOLVE_COLS; ++g) {
          if (g >= nc) break;
          const int c = c0 + g;
          const float kk = Kk[i * N1 + c];
          V[i * N1 + c] = (vs[r][g] + lam * kk) + C[i * N1 + c];
          if (c == 0)
            ks[(long)t * m + i] = kk;
          else
            Ks[((long)t * m + i) * n + c - 1] = kk;
        }
      }
    }
    sync();
    KMANIP_PHASE(4);
    // P5: [Vx | Vxx] = [Qx | Qxx] + (Kk^T V + C^T Kk)[1:, :], Vxx
    // symmetrized: each lower-triangle element with its mirror
    riccati_value_update<true>(tid, nthr, n, m, qv, Qxx, C, Kk, V, W);
    KMANIP_PHASE(5);
  }
  KMANIP_PHASE_STOP();
}

}  // namespace kmanip
