// Device code of the Riccati step's floor experiment: the backward sweep
// cut down to seven cumulative variants, to bisect what one step of the
// sweep costs on the card. Follows the JAX package's Pallas experiment
// tools/exp_sweep_floor.py::_kernel variant for variant, and floors the
// Riccati sweep kernel K4 as it now stands (riccati.cuh): each variant is
// K4's step with parts cut away, on K4's own pieces. One block, K4's shared
// working set (riccati_layout) and thread count; from `mem` on, step t - 1's
// inputs are copied into the other half of K4's double-buffered stage
// (riccati_stage) while step t computes; the products are K4's register
// tiles (riccati_gw, riccati_q_blocks, tile_mm); Quu is symmetrized, and
// lifted, by one warp with K4's reductions (riccati_symmetrize); the value
// update is K4's, each Vxx element computed with its mirror
// (riccati_value_update). What the variants leave out of K4 is its P3
// factor and its P4 substitutions: the experiment's gains are Jacobi
// gains, elementwise. So K4's time less gersh's is what the factor and the
// substitutions cost a sweep.
// Written against a thread index, a thread count, a block barrier and a
// team of lanes (team.cuh), so the host test harness runs it as C++ on one
// thread or on several behind a barrier.
//
// Per step t = H-1 .. 0, on AB (H, n, n+m), cx (H, n), cu (H, m),
// cxx (H, n, n), cuu (H, m, m), cux (H, m, n), W from WT (n, 1+n):
//   loop          W += 1e-9 t; ks[t], Ks[t] = W[:m, 0], W[:m, 1:]
//   load1         W += 1e-9 cxx[t,0,0]; the same outputs
//   load1nostore  W += 1e-9 cxx[t,0,0]; only row 0 of the outputs, every
//                 step: ks[0] = 1e-9 W[0, :m], Ks[0] = 1e-9 W[:m, 1:]
//                 (the other rows are zero)
//                 (these three: the step loop and its barrier)
//   mem           W += 1e-9 (cx + cu + cxx + cuu + cux + AB)[t, 0..];
//                 ks[t] = cu[t] + W[:m, 0], Ks[t] = cux[t] + W[:m, 1:]
//                 (K4's staged loads and the stores)
//   gemm          GW = AB^T W, GWG = GW[:, 1:] AB, the Q blocks;
//                 Kk = -[Qu | Qux] / (diag Quu + lam), lam = 1e-6;
//                 V = Quu Kk + lam Kk + C, C = [Qu | Qux];
//                 W = [Qx | Qxx] + (Kk^T V + C^T Kk)[1:]
//                 (K4's products and value update in register tiles, the
//                 gains elementwise)
//   trans         gemm with Quu and the new Vxx symmetrized, as K4 does
//   gersh         trans with lam = 1e-5 amax + max(0, 1e-4 amax - gersh_min)
//                 (K4's lift from warp reductions)
#pragma once

#include "riccati.cuh"

namespace kmanip {

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

// One sweep of variant VAR. NT, MT: the widths, or 0 for runtime widths
// n_rt, m_rt (m <= n, m <= 32); TR x TC: the register tile of the products.
// The team is the warp of thread tid, and nthr a multiple of its SIZE, as in
// riccati_sweep_block. `sm` holds riccati_layout(n, m).total floats.
template <int VAR, int NT, int MT, int TR, int TC, class Team, class Sync>
__device__ void sweep_floor_block(int tid, int nthr, const Team& team, Sync sync, int H, int n_rt,
                                  int m_rt, const float* ABg, const float* cx, const float* cu,
                                  const float* cxx, const float* cuu, const float* cux,
                                  const float* WT, float* ks, float* Ks, float* sm) {
  const int n = NT ? NT : n_rt, m = MT ? MT : m_rt;
  const int Z = n + m, N1 = n + 1;
  const RiccatiLayout L = riccati_layout(n, m);
  float *W = sm + L.W, *GW = sm + L.GW, *qv = sm + L.qv, *Qxx = sm + L.Qxx, *C = sm + L.C;
  float *Qr = sm + L.Qr, *Qs = sm + L.Qs, *Kk = sm + L.Kk, *V = sm + L.V, *lam_s = sm + L.lam;
  const int warp = tid / Team::SIZE, n_warps = nthr / Team::SIZE;
  constexpr int MM = MT ? MT : RICCATI_MAX_M;  // compile-time bound on m
  constexpr bool STAGED = VAR >= FLOOR_MEM;
  constexpr bool SYM = VAR >= FLOOR_TRANS;
  const auto stage = [&](int t, int skip) {  // step t's inputs into their stage half
    riccati_stage(tid - skip, nthr - skip, t, n, m, L, sm + L.stage + (t & 1) * L.stage_size, ABg,
                  Z, ABg + n, Z, cx, cu, cxx, cuu, cux);
  };

  for (int e = tid; e < n * N1; e += nthr) W[e] = WT[e];
  if (VAR == FLOOR_LOAD1NOSTORE) {  // only row 0 is ever written
    for (int e = m + tid; e < H * m; e += nthr) ks[e] = 0.f;
    for (int e = m * n + tid; e < H * m * n; e += nthr) Ks[e] = 0.f;
  }
  if (STAGED) stage(H - 1, 0);
  for (int t = H - 1; t >= 0; --t) {
    if (STAGED) copy_wait_all();
    sync();
    if (!STAGED) {
      const float inc = VAR == FLOOR_LOOP ? 1e-9f * (float)t : cxx[(long)t * n * n] * 1e-9f;
      for (int e = tid; e < n * N1; e += nthr) {
        const int i = e / N1, c = e % N1;
        const float w = W[e];
        if (VAR == FLOOR_LOAD1NOSTORE) {
          if (i == 0 && c < m) ks[c] = w * 1e-9f;
          if (i < m && c >= 1) Ks[i * n + c - 1] = w * 1e-9f;
        } else if (i < m) {
          if (c == 0)
            ks[(long)t * m + i] = w;
          else
            Ks[((long)t * m + i) * n + c - 1] = w;
        }
        W[e] = w + inc;
      }
      continue;
    }
    const float* st = sm + L.stage + (t & 1) * L.stage_size;
    const float *AB = st + L.sAB, *sxx = st + L.sxx, *sux = st + L.sux, *suu = st + L.suu;
    const float *sx = st + L.sx, *su = st + L.su;
    if (VAR == FLOOR_MEM) {
      if (t > 0) stage(t - 1, 0);  // nothing else reads the other half now
      const float inc = (((((sx[0] + su[0]) + sxx[0]) + suu[0]) + sux[0]) + AB[0]) * 1e-9f;
      for (int e = tid; e < n * N1; e += nthr) {
        const int i = e / N1, c = e % N1;
        const float w = W[e];
        if (i < m) {
          if (c == 0)
            ks[(long)t * m + i] = su[i] + w;
          else
            Ks[((long)t * m + i) * n + c - 1] = sux[i * n + c - 1] + w;
        }
        W[e] = w + inc;
      }
      continue;
    }

    // K4's P1 and P2: GW, [Qx; Qu], and the Q blocks (no reg)
    riccati_gw<TR, TC>(tid, nthr, n, m, AB, sx, su, W, GW, qv, C);
    sync();
    riccati_q_blocks<TR, TC>(tid, nthr, n, m, 0.f, AB, GW, sxx, sux, suu, Qxx, C, Qr);
    sync();
    // K4's P3 without the factor: one warp symmetrizes Quu (and lifts it)
    // while the other warps copy step t - 1's inputs (the only warp copies
    // after it)
    if (SYM && warp == 0) {
      const float lam = riccati_symmetrize<MM, VAR == FLOOR_GERSH>(team, m, Qr, Qs, 0.f);
      if (team.lane == 0) lam_s[0] = lam;
    }
    if (t > 0 && (n_warps == 1 || warp > 0)) stage(t - 1, n_warps == 1 ? 0 : Team::SIZE);
    sync();
    // the Jacobi gains, elementwise, and their stores
    const float* Q = SYM ? Qs : Qr;
    const float lam = VAR == FLOOR_GERSH ? lam_s[0] : 1e-6f;
    for (int e = tid; e < m * N1; e += nthr) {
      const int i = e / N1, c = e % N1;
      const float k = -(C[e] / (Q[i * m + i] + lam));
      Kk[e] = k;
      if (c == 0)
        ks[(long)t * m + i] = k;
      else
        Ks[((long)t * m + i) * n + c - 1] = k;
    }
    sync();
    // V = Quu Kk + lam Kk + C in register tiles
    const int v_tc = (N1 + TC - 1) / TC, v_tiles = ((m + TR - 1) / TR) * v_tc;
    for (int e = tid; e < v_tiles; e += nthr) {
      tile_mm<TR, TC>((e / v_tc) * TR, (e % v_tc) * TC, m, N1, m, Q, 1, m, Kk, N1, 1,
                      [&](int i, int c, float s) {
                        V[i * N1 + c] = (s + lam * Kk[i * N1 + c]) + C[i * N1 + c];
                      });
    }
    sync();
    // K4's P5: the next value state, Vxx symmetrized from trans on
    riccati_value_update<SYM>(tid, nthr, n, m, qv, Qxx, C, Kk, V, W);
  }
}

}  // namespace kmanip
