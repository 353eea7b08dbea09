// Device code of the iLQR feedback rollout (K3), one team of lanes (one
// warp on the card) per step size: the JAX package's
// pallas_substep.py::_rollout_feedback_kernel on the team substep of
// substep_team.cuh, contact-free with implicit actuation. Written against a
// team (team.cuh), so the host test harness runs it with one thread or with
// several host threads behind a barrier.
//
// Beside the substep the lanes split the feedback law, one lane per control,
// on the step's gains and nominal, which were copied into a double-buffered
// shared stage (cp.async) while the step before ran. The cube is pinned to
// its template every control step and the substep is contact-free, so the
// cube's own integration has no effect on the outputs and is not run. The
// rollout agrees bit for bit with a serial rollout over substep_core (held
// on the host build).
#pragma once

#include "substep_team.cuh"

namespace kmanip {

// The team's shared working set: the model, the substep's, and the
// feedback law's state difference and stage.
template <int NQ, int T>
struct FeedbackShared {
  static constexpr int N = 2 * NQ;
  // stage: Ks[h] (nu x N), then xs_nom[h] (N), us_nom[h] (nu), ks[h] (nu)
  static constexpr int ST_X = NQ * N, ST_U = ST_X + N, ST_K = ST_U + NQ, ST_SIZE = ST_K + NQ;

  TeamModel<NQ, T> model;
  TeamWork<NQ, T> work;
  float dx[N];
  float stage[2][ST_SIZE];
};

// Copies step h's gains and nominal into stage buffer `st` without waiting.
template <int NQ, class Team>
__device__ __forceinline__ void stage_step(const Team& team, int h, int nu, float* st,
                                           const float* __restrict__ xs_nom,
                                           const float* __restrict__ us_nom,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ Ks) {
  constexpr int N = 2 * NQ, S = Team::SIZE;
  constexpr int ST_X = NQ * N, ST_U = ST_X + N, ST_K = ST_U + NQ;
  const float* Kh = Ks + (long)h * nu * N;
  for (int e = team.lane; e < nu * N; e += S) copy_async(st + e, Kh + e);
  for (int e = team.lane; e < N; e += S) copy_async(st + ST_X + e, xs_nom + (long)h * N + e);
  for (int e = team.lane; e < nu; e += S) {
    copy_async(st + ST_U + e, us_nom + (long)h * nu + e);
    copy_async(st + ST_K + e, ks + (long)h * nu + e);
  }
  copy_commit();
}

// Step size b of the feedback rollout on the reduced state x = [qpos,
// qvel]: for each control step h,
//   u = clip(us_nom[h] + alpha_b ks[h] + Ks[h] (x - xs_nom[h]), lo, hi)
// (the feedback sum first, then one add to the feedforward term, as the
// reference), then n_substeps contact-free substeps with implicit
// actuation. Writes xs_out[b] (H, 2NQ), the post-step states, and
// us_out[b] (H, nu), the controls as applied. `mf`, `mi` are the packed
// model (ops/substep_cuda.pack_model); every lane of the team calls this.
template <int NQ, int T, class Team>
__device__ void rollout_feedback_team(
    const Team& team, FeedbackShared<NQ, T>& s, int b, const float* __restrict__ mf,
    const int* __restrict__ mi, const StepConsts& c, int n_substeps, int H,
    const float* __restrict__ alphas, const float* __restrict__ x0,
    const float* __restrict__ xs_nom, const float* __restrict__ us_nom,
    const float* __restrict__ ks, const float* __restrict__ Ks,
    const float* __restrict__ ctrl_lo, const float* __restrict__ ctrl_hi,
    float* __restrict__ xs_out, float* __restrict__ us_out) {
  using Sh = FeedbackShared<NQ, T>;
  constexpr int N = Sh::N, S = Team::SIZE;
  using LC = LaneConsts<NQ, T, S>;
  constexpr int RPL = LC::RPL;
  const int lane = team.lane;
  team_model_load(s.model, lane, S, mf, mi, c, true, [&] { team.sync(); });
  const ModelView<NQ, T> m{s.model.mf, s.model.mi};
  const int nu = m.nu();
  LC k = lane_consts<NQ, T, S>(s.model, lane, c);
  LaneState<RPL> st;
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S < NQ ? lane + r * S : NQ - 1;
    k.lo[r] = i < nu ? ctrl_lo[i] : 0.f;
    k.hi[r] = i < nu ? ctrl_hi[i] : 0.f;
    st.q[r] = x0[i];
    st.v[r] = x0[NQ + i];
    st.u[r] = 0.f;
  }
  for (int i = lane; i < NQ; i += S) {
    s.work.q[i] = x0[i];
    s.work.v[i] = x0[NQ + i];
  }
  stage_step<NQ>(team, 0, nu, s.stage[0], xs_nom, us_nom, ks, Ks);
  const float alpha = alphas[b];
  KMANIP_PHASE_START();
  for (int h = 0; h < H; ++h) {
    copy_wait_all();
    team.sync();
    if (h + 1 < H) stage_step<NQ>(team, h + 1, nu, s.stage[(h + 1) & 1], xs_nom, us_nom, ks, Ks);
    const float* stg = s.stage[h & 1];
    for (int j = lane; j < N; j += S)
      s.dx[j] = (j < NQ ? s.work.q[j] : s.work.v[j - NQ]) - stg[Sh::ST_X + j];
    team.sync();
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = lane + r * S;
      if (i >= nu) continue;
      const float* Ki = stg + i * N;
      float fb = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) fb = fb + Ki[j] * s.dx[j];
      st.u[r] = clampf((stg[Sh::ST_U + i] + alpha * stg[Sh::ST_K + i]) + fb, k.lo[r], k.hi[r]);
    }
    KMANIP_PHASE(0);  // the outputs before, the copies' wait, the feedback law
    for (int sub = 0; sub < n_substeps; ++sub)
      substep_team<NQ, T, false, true, false>(team, m, c, k, st, s.model, s.work);
    KMANIP_PHASE(7);  // integration
    team.sync();
    float* xo = xs_out + ((long)b * H + h) * N;
    for (int j = lane; j < N; j += S) xo[j] = j < NQ ? s.work.q[j] : s.work.v[j - NQ];
    float* uo = us_out + ((long)b * H + h) * nu;
#pragma unroll
    for (int r = 0; r < RPL; ++r)
      if (lane + r * S < nu) uo[lane + r * S] = st.u[r];
  }
  KMANIP_PHASE_STOP();
}

}  // namespace kmanip
