"""The regularized iLQR Riccati backward sweep as one hand-written CUDA
kernel (csrc/riccati.cu).

Replaces the JAX package's Pallas TPU kernel
`gym_kmanip_tpu/ops/pallas_riccati.py::riccati_sweep_pallas` (its default
step `_sweep_kernel_gemm5`, solve semantics of `_chol_solve_rows`) and
keeps its signature and outputs. `riccati_sweep` launches the kernel for
CUDA tensors and counts the launch in `riccati_sweep.launches`; for CPU
tensors it runs the plain version, `riccati_sweep_reference`. Anything
else raises.

Per step, with Quu symmetrized and `reg` on its diagonal:

    lam = 1e-5 amax + max(0, 1e-4 amax - gersh_min) + lam_extra amax

(amax = max |Quu|, gersh_min = the least Gershgorin bound of Quu's
eigenvalues), gains Kk = -(Quu + lam I)^-1 [Qu | Qux] by an equilibrated
Cholesky that drops pivots at or below 1e-5, and the value update with
the same lifted matrix; Vxx is symmetrized each step.

Importing this module needs neither nvcc nor a GPU: the kernel is built
(ops/_build.py) at its first launch, or ahead of it by
`_build.build_libraries`.
"""

import ctypes
import functools

import numpy as np
import torch

from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.ops import _build
from gym_kmanip_torch.ops.substep_cuda import _check

SOURCES = ("riccati.cu",)
HEADERS = ("riccati.cuh", "team.cuh")
MAX_M = 32  # the kernel factors Quu in one warp, lanes over rows
LIBRARY = ("riccati", SOURCES, HEADERS)
PIVOT_FLOOR = 1e-5

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load_library(*LIBRARY))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry point's argument types on a loaded library."""
    lib.kmanip_riccati.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ]
    lib.kmanip_riccati.restype = ctypes.c_int
    return lib


def _lam_tensor(lam_extra, like: torch.Tensor) -> torch.Tensor:
    if lam_extra is None:
        lam_extra = 0.0
    return torch.as_tensor(lam_extra, dtype=torch.float32, device=like.device).reshape(())


def riccati_sweep(A, B, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T, reg: float, lam_extra=None):
    """Full regularized LQR backward sweep. A (H,n,n), B (H,n,m), cx (H,n),
    cu (H,m), cxx (H,n,n), cuu (H,m,m), cux (H,m,n), Vx_T (n,), Vxx_T
    (n,n), float32 and contiguous on one device; `lam_extra` the adaptive
    Levenberg multiplier, a 0-d tensor on that device (None = 0). Returns
    (ks (H,m), Ks (H,m,n))."""
    tensors = (A, B, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T)
    lam = _lam_tensor(lam_extra, A)
    devices = {x.device for x in tensors + (lam,)}
    if len(devices) != 1:
        raise ValueError(f"inputs are on several devices: {sorted(map(str, devices))}")
    device = A.device
    if device.type == "cpu":
        return riccati_sweep_reference(*tensors, reg, lam)
    if device.type != "cuda":
        raise ValueError(f"riccati_sweep runs on CUDA or the CPU, not {device}")
    device = canonical_device(device)
    if A.dim() != 3 or B.dim() != 3:
        raise ValueError(f"A and B must be (H, n, n) and (H, n, m), got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    H, n, m = A.shape[0], A.shape[1], B.shape[2]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"the kernel takes 1 to {MAX_M} controls, not {m}")
    for name, x, shape in (("A", A, (H, n, n)), ("B", B, (H, n, m)), ("cx", cx, (H, n)),
                           ("cu", cu, (H, m)), ("cxx", cxx, (H, n, n)),
                           ("cuu", cuu, (H, m, m)), ("cux", cux, (H, m, n)),
                           ("Vx_T", Vx_T, (n,)), ("Vxx_T", Vxx_T, (n, n)),
                           ("lam_extra", lam, ())):
        _check(name, x, device, shape)

    with torch.cuda.device(device):
        ks = torch.empty((H, m), dtype=torch.float32, device=device)
        Ks = torch.empty((H, m, n), dtype=torch.float32, device=device)
        rc = _library().kmanip_riccati(
            H, n, m, float(reg), lam.data_ptr(), *(x.data_ptr() for x in tensors),
            ks.data_ptr(), Ks.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"riccati kernel launch failed: cudaError_t {rc}")
    riccati_sweep.launches += 1
    return ks, Ks


riccati_sweep.launches = 0


def random_problem(seed: int, H: int, n: int, m: int, indefinite: bool = False):
    """Seeded numpy LQR problem (A, B, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T),
    float32, for checking the kernel against its plain version: near-identity
    dynamics and positive definite cost blocks as in tests/test_mpc.py:180-194
    (scaled by the widths); `indefinite` makes cuu strongly indefinite, so
    the Gershgorin lift acts."""
    rng = np.random.RandomState(seed)
    A = 0.1 * rng.randn(H, n, n) / np.sqrt(n / 7) + np.eye(n)
    B = 0.3 * rng.randn(H, n, m)
    cx, cu = rng.randn(H, n), rng.randn(H, m)
    W = rng.randn(H, n, n)
    cxx = 0.1 * (W @ W.transpose(0, 2, 1)) * (7 / n) + np.eye(n)
    Wu = rng.randn(H, m, m)
    cuu = 0.1 * (Wu @ Wu.transpose(0, 2, 1)) * (3 / m) + np.eye(m)
    if indefinite:
        cuu = cuu - 3.0 * np.eye(m) + 0.5 * (Wu + Wu.transpose(0, 2, 1))
    cux = 0.1 * rng.randn(H, m, n)
    VxT = rng.randn(n)
    Wt = rng.randn(n, n)
    VxxT = 0.1 * (Wt @ Wt.T) * (7 / n) + np.eye(n)
    return [a.astype(np.float32) for a in (A, B, cx, cu, cxx, cuu, cux, VxT, VxxT)]


def chol_solve_dropping(Q: torch.Tensor, RHS: torch.Tensor, lam) -> torch.Tensor:
    """X = (Q + lam I)^-1 RHS for symmetric Q (m, m), RHS (m, r): Jacobi
    equilibration to a unit diagonal (the diagonal includes lam), a
    right-looking Cholesky that drops pivots at or below PIVOT_FLOOR (zero
    in that direction), and the two substitutions. The plain version of
    `team_factor` and `team_solve_cols` in csrc/riccati.cuh; no host
    sync."""
    m = Q.shape[-1]
    dsc = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Q) + lam, min=1e-30))
    S = dsc[:, None] * Q * dsc[None, :]
    S.fill_diagonal_(1.0)
    piv, keep = [], []
    for j in range(m):
        kept = S[j, j] > PIVOT_FLOOR
        d = torch.sqrt(torch.where(kept, S[j, j], torch.ones_like(S[j, j])))
        col = torch.where(kept, S[j + 1:, j] / d, torch.zeros_like(S[j + 1:, j]))
        S[j + 1:, j] = col
        S[j + 1:, j + 1:] -= col[:, None] * col[None, :]
        piv.append(d)
        keep.append(kept)
    L = torch.tril(S, diagonal=-1)
    y = torch.zeros_like(RHS)
    for i in range(m):
        s = RHS[i] * dsc[i] - L[i, :i] @ y[:i]
        y[i] = torch.where(keep[i], s / piv[i], torch.zeros_like(s))
    z = torch.zeros_like(RHS)
    for i in range(m - 1, -1, -1):
        s = y[i] - L[i + 1:, i] @ z[i + 1:]
        z[i] = torch.where(keep[i], s / piv[i], torch.zeros_like(s))
    return z * dsc[:, None]


def riccati_sweep_reference(A, B, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T, reg: float,
                            lam_extra=None):
    """The plain PyTorch version of `riccati_sweep`, on any device: the
    same step math in torch ops, one step at a time."""
    lam_extra = _lam_tensor(lam_extra, A)
    H, n, m = A.shape[0], A.shape[1], B.shape[2]
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)
    W = torch.cat([Vx_T[:, None], Vxx_T], dim=1)  # (n, 1+n)
    ks = A.new_empty((H, m))
    Ks = A.new_empty((H, m, n))
    for t in range(H - 1, -1, -1):
        AB = torch.cat([A[t], B[t]], dim=1)  # (n, n+m)
        GW = AB.transpose(0, 1) @ W  # (n+m, 1+n)
        GWG = GW[:, 1:] @ AB  # (n+m, n+m)
        Qx = cx[t] + GW[:n, 0]
        Qu = cu[t] + GW[n:, 0]
        Qxx = cxx[t] + GWG[:n, :n]
        Quu = cuu[t] + GWG[n:, n:] + reg * eye_m
        Qux = cux[t] + GWG[n:, :n]
        Quu = 0.5 * (Quu + Quu.transpose(0, 1))
        amax = torch.max(torch.abs(Quu))
        dg = torch.diagonal(Quu)
        gersh_min = torch.min(dg - (torch.sum(torch.abs(Quu), dim=1) - torch.abs(dg)))
        lam = (1e-5 * amax + torch.clamp(1e-4 * amax - gersh_min, min=0.0)
               + lam_extra * amax)
        C = torch.cat([Qu[:, None], Qux], dim=1)  # (m, 1+n)
        Kk = -chol_solve_dropping(Quu, C, lam)
        U1 = Quu @ Kk + lam * Kk
        M = Kk.transpose(0, 1) @ (U1 + C) + C.transpose(0, 1) @ Kk  # (1+n, 1+n)
        Wn = torch.cat([Qx[:, None], Qxx], dim=1) + M[1:, :]
        Vxx = 0.5 * (Wn[:, 1:] + Wn[:, 1:].transpose(0, 1))
        W = torch.cat([Wn[:, :1], Vxx], dim=1)
        ks[t] = Kk[:, 0]
        Ks[t] = Kk[:, 1:]
    return ks, Ks
