"""Parallel-in-time LQR: the Riccati backward pass as an associative scan.

Port of `gym_kmanip_tpu/solvers/parallel_lqr.py`. A serial H-step Riccati
recursion has O(H) depth; with the associative combination of conditional
value functions (Sarkka & Garcia-Fernandez, "Temporal Parallelization of
Bayesian Smoothers", IEEE TAC 2021, the LQT dual) the sweep is O(log H)
depth of batched (H, n, n) products and solves.

The JAX package runs `lax.associative_scan(reverse=True)`. Here the scan
is a log-depth doubling (Hillis-Steele) over the horizon in plain PyTorch:
at distance d = 1, 2, 4, ... every element t < N - d takes
`combine(later=S[t + d], earlier=S[t])`, so S[t] ends as e_t * ... * e_T.
The bracketing differs from XLA's, which the associativity makes exact up
to rounding. The JAX module has no Pallas kernel, so batched
`torch.matmul` / `torch.linalg.solve` are the port.

Problem form (per step t, all tensors stacked over the horizon):
    x_{t+1} = A_t x_t + B_t u_t + d_t
    cost_t  = 1/2 x'Q x + q'x + 1/2 u'R u + r'u + u'L x
    cost_T  = 1/2 x'Qf x + qf'x

Both backward passes return (K, kff) with u_t = K_t x_t + kff_t optimal.
"""

from typing import NamedTuple, Tuple

import torch


class LQRProblem(NamedTuple):
    A: torch.Tensor  # (H, n, n)
    B: torch.Tensor  # (H, n, m)
    d: torch.Tensor  # (H, n)
    Q: torch.Tensor  # (H, n, n)
    q: torch.Tensor  # (H, n)
    R: torch.Tensor  # (H, m, m)
    r: torch.Tensor  # (H, m)
    L: torch.Tensor  # (H, m, n)  cross term u'Lx
    Qf: torch.Tensor  # (n, n)
    qf: torch.Tensor  # (n,)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _eliminate_cross(p: LQRProblem):
    """Complete the square in u: (At, dt, Ct, Qt, qt, Rinv, Rinv_L, Rinv_r).

    With v = u + R^{-1}(L x + r):
      cost = 1/2 x'(Q - L'R^{-1}L)x + (q - L'R^{-1}r)'x + 1/2 v'R v + const
      dyn  = (A - B R^{-1} L) x + B v + (d - B R^{-1} r)
    """
    Rinv = torch.linalg.inv(p.R)
    Rinv_L = Rinv @ p.L  # (H, m, n)
    Rinv_r = _mv(Rinv, p.r)
    At = p.A - p.B @ Rinv_L
    dt = p.d - _mv(p.B, Rinv_r)
    Qt = p.Q - p.L.transpose(-1, -2) @ Rinv_L
    qt = p.q - _mv(p.L.transpose(-1, -2), Rinv_r)
    Ct = p.B @ Rinv @ p.B.transpose(-1, -2)
    return At, dt, Ct, Qt, qt, Rinv, Rinv_L, Rinv_r


def _gains(A, B, d, R, r, L, P, pv):
    """(K, kff) of every step at once from the next step's value (P, p)."""
    BT = B.transpose(-1, -2)
    Quu = R + BT @ P @ B
    Qux = L + BT @ P @ A
    Qu = r + _mv(BT, _mv(P, d) + pv)
    Kk = -torch.linalg.solve(Quu, torch.cat([Qu[..., None], Qux], dim=-1))
    return Kk[..., 1:], Kk[..., 0]


def backward_sequential(p: LQRProblem) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference serial Riccati sweep. Returns (K, kff), (H, m, n), (H, m)."""
    P, pv = p.Qf, p.qf
    Ks, ks = [], []
    for t in range(p.A.shape[0] - 1, -1, -1):
        A, B, d = p.A[t], p.B[t], p.d[t]
        Quu = p.R[t] + B.T @ P @ B
        Qux = p.L[t] + B.T @ P @ A
        Qu = p.r[t] + B.T @ (P @ d + pv)
        Kk = -torch.linalg.solve(Quu, torch.cat([Qu[:, None], Qux], dim=1))
        kff, K = Kk[:, 0], Kk[:, 1:]
        P_new = p.Q[t] + A.T @ P @ A + Qux.T @ K
        pv = p.q[t] + A.T @ (P @ d + pv) + Qux.T @ kff
        P = 0.5 * (P_new + P_new.T)
        Ks.append(K)
        ks.append(kff)
    return torch.stack(Ks[::-1]), torch.stack(ks[::-1])


def _combine(later, earlier):
    """The associative operator on (F, c, C, eta, J) elements, batched over
    leading dimensions: `earlier` covers the steps before `later`'s."""
    Fa, ca, Ca, etaa, Ja = earlier
    Fb, cb, Cb, etab, Jb = later
    eye = torch.eye(Fa.shape[-1], dtype=Fa.dtype, device=Fa.device)
    # M1 = Fb (I + Ca Jb)^{-1}
    M1 = torch.linalg.solve((eye + Ca @ Jb).transpose(-1, -2),
                            Fb.transpose(-1, -2)).transpose(-1, -2)
    F_ = M1 @ Fa
    c_ = _mv(M1, ca + _mv(Ca, etab)) + cb
    C_ = M1 @ Ca @ Fb.transpose(-1, -2) + Cb
    M2 = torch.linalg.solve(
        eye + Jb @ Ca,
        torch.cat([(etab - _mv(Jb, ca))[..., None], Jb @ Fa], dim=-1),
    )
    FaT = Fa.transpose(-1, -2)
    eta_ = _mv(FaT, M2[..., 0]) + etaa
    J_ = FaT @ M2[..., 1:] + Ja
    J_ = 0.5 * (J_ + J_.transpose(-1, -2))
    return F_, c_, C_, eta_, J_


def backward_associative(p: LQRProblem) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(log H)-depth Riccati by a reverse doubling scan. Returns (K, kff)."""
    H, n, _ = p.A.shape
    At, dt, Ct, Qt, qt, _, _, _ = _eliminate_cross(p)
    zn, zv = p.A.new_zeros((1, n, n)), p.A.new_zeros((1, n))

    # elements for t = 0..H-1 plus the terminal element
    S = (torch.cat([At, zn]), torch.cat([dt, zv]), torch.cat([Ct, zn]),
         torch.cat([-qt, -p.qf[None]]), torch.cat([Qt, p.Qf[None]]))
    N, dist = H + 1, 1
    while dist < N:
        head = _combine(tuple(x[dist:] for x in S), tuple(x[: N - dist] for x in S))
        S = tuple(torch.cat([h, x[N - dist:]]) for h, x in zip(head, S))
        dist *= 2
    etas, Js = S[3], S[4]
    # V_t(x) = 1/2 x'J_t x - eta_t'x, so P_t = J_t and p_t = -eta_t; the
    # gains at t read (P, p) at t + 1
    return _gains(p.A, p.B, p.d, p.R, p.r, p.L, Js[1:], -etas[1:])
