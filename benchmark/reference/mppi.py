"""The plain reference of one MPPI solve on the pick cost.

K perturbed control sequences around the nominal are rolled out; slot 0
is the nominal itself, slot 1 the previous iteration's softmax-weighted
average; the next nominal is the best candidate, and after the last
iteration the solve returns its first control and the nominal shifted by
one step. The exploration noise is AR(1)-correlated along the horizon with
a per-actuator standard deviation, drawn with `torch.randn` from a
generator seeded per solve by the benchmark.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .dynamics import PickWeights, Plain, State


class SolveConfig(NamedTuple):
    horizon: int
    n_samples: int
    temperature: float
    sigma: float
    n_iters: int
    n_substeps: int
    dt: float
    contact: bool
    noise_beta: float


def ar1_filter(horizon: int, beta: float) -> np.ndarray:
    """(H, H) lower-triangular filter: eps = L xi with L[t, 0] = beta^t and
    L[t, s] = sqrt(1 - beta^2) beta^(t - s) for 1 <= s <= t."""
    g = float(np.sqrt(1.0 - beta * beta))
    t = np.arange(horizon)
    L = np.tril(g * beta ** np.maximum(t[:, None] - t[None, :], 0))
    L[:, 0] = beta ** t
    return L.astype(np.float32)


def sigma_per_actuator(ctrl_range: np.ndarray, sigma: float) -> np.ndarray:
    """`sigma`, capped at a quarter of each actuator's control range."""
    span = (ctrl_range[:, 1] - ctrl_range[:, 0]).astype(np.float32)
    return np.minimum(np.float32(sigma), 0.25 * span)


def draw_noise(seed: int, cfg: SolveConfig, nu: int, sigma: torch.Tensor,
               device) -> list:
    """The (K, H, nu) noise of each iteration of one solve, drawn in turn
    from one generator seeded `seed` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L = torch.as_tensor(ar1_filter(cfg.horizon, float(cfg.noise_beta)), device=device)
    out = []
    for _ in range(cfg.n_iters):
        xi = torch.randn((cfg.n_samples, cfg.horizon, nu), generator=gen, device=device) * sigma
        if cfg.noise_beta > 0.0 and cfg.horizon > 1:
            xi = torch.sum(L[None, :, :, None] * xi[:, None, :, :], dim=2)
        out.append(xi)
    return out


class Iteration(NamedTuple):
    cand: torch.Tensor  # (R, K, H, nu) the candidates scored
    costs: torch.Tensor  # (R, K) their totals


def solve(plain: Plain, cfg: SolveConfig, wts: PickWeights, nominal: torch.Tensor,
          start: State, noise: Sequence[torch.Tensor],
          picks: Optional[Sequence[Optional[torch.Tensor]]] = None):
    """R independent solves at once, each from its nominal (R, H, nu) and
    its start state (R, ...), on the noise (R, K, H, nu) of each iteration.
    Returns (iterations, the final nominals (R, H, nu) before the shift).

    `picks[it]`, where given, is the (R,) candidate each solve keeps after
    iteration `it` (the program's choice, which near-equal totals can make
    differ from this solve's own argmin); otherwise each keeps its first
    minimum."""
    R, K = nominal.shape[0], cfg.n_samples
    lo, hi = plain.ctrl_lo, plain.ctrl_hi
    flat = State(*(x[:, None].expand((R, K) + tuple(x.shape[1:])).reshape((R * K,) + tuple(x.shape[1:]))
                   for x in start))
    rows = torch.arange(R, device=nominal.device)
    proposal = nominal
    iters = []
    for it in range(cfg.n_iters):
        e = noise[it].clone()
        e[:, 0] = 0.0  # the nominal competes
        cand = torch.clamp(nominal[:, None] + e, lo, hi)
        cand[:, 1] = proposal  # and the last iteration's weighted average
        costs = plain.rollout_costs(flat, cand.reshape((R * K,) + tuple(cand.shape[2:])), wts,
                                    cfg.n_substeps, cfg.dt, cfg.contact).reshape(R, K)
        lam = cfg.temperature * (torch.std(costs, dim=1, keepdim=True, correction=0) + 1e-6)
        w = torch.softmax(-(costs - torch.min(costs, dim=1, keepdim=True).values) / lam, dim=1)
        proposal = torch.clamp(torch.sum(w[:, :, None, None] * cand, dim=1), lo, hi)
        pick = picks[it] if picks is not None and picks[it] is not None else torch.argmin(costs, dim=1)
        nominal = cand[rows, pick]
        iters.append(Iteration(cand, costs))
    return iters, nominal


def shift(nominal: torch.Tensor) -> torch.Tensor:
    """The warm start of the next solve: one step on, the last repeated
    (along the next-to-last axis)."""
    return torch.cat([nominal[..., 1:, :], nominal[..., -1:, :]], dim=-2)
