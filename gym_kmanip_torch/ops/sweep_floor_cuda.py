"""The Riccati step's floor experiment as a hand-written CUDA kernel
(csrc/sweep_floor.cu).

Replaces the JAX package's Pallas TPU experiment
`tools/exp_sweep_floor.py::sweep` and keeps its inputs and outputs: AB
(H, n, n+m), cx (H, n), cu (H, m), cxx (H, n, n), cuu (H, m, m), cux
(H, m, n), WT (n, 1+n) -> ks (H, m), Ks (H, m, n), for each of the seven
cumulative VARIANTS (csrc/sweep_floor.cuh says what each computes). The
TPU experiment's `unroll` argument, a loop-unroll knob of its fori_loop that
leaves the result unchanged, is dropped.

`sweep` launches the kernel for CUDA tensors and counts the launch in
`sweep.launches`; for CPU tensors it runs the plain version,
`sweep_reference`. Anything else raises. The gains are in full float32,
where the TPU experiment emulated its products in bf16x3.

Importing this module needs neither nvcc nor a GPU: the kernel is built
(ops/_build.py) at its first launch, or ahead of it by
`_build.build_libraries`.
"""

import ctypes
import functools

import numpy as np
import torch

from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.ops import _build, riccati_cuda
from gym_kmanip_torch.ops.substep_cuda import _check

SOURCES = ("sweep_floor.cu",)
HEADERS = ("sweep_floor.cuh", "riccati.cuh", "team.cuh")
LIBRARY = ("sweep_floor", SOURCES, HEADERS)
# in the order of csrc/sweep_floor.cuh's FloorVariant
VARIANTS = ("loop", "load1", "load1nostore", "mem", "gemm", "trans", "gersh")

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library(*LIBRARY)
    lib.kmanip_sweep_floor.argtypes = [ctypes.c_int] * 4 + [_P] * 10
    lib.kmanip_sweep_floor.restype = ctypes.c_int
    return lib


def sweep(variant: str, AB, cx, cu, cxx, cuu, cux, WT):
    """One sweep of `variant` (one of VARIANTS) over the horizon: (ks
    (H, m), Ks (H, m, n)), inputs float32 and contiguous on one device."""
    if variant not in VARIANTS:
        raise ValueError(f"variant is one of {VARIANTS}, not {variant!r}")
    tensors = (AB, cx, cu, cxx, cuu, cux, WT)
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs are on several devices: {sorted(map(str, devices))}")
    if AB.device.type == "cpu":
        return sweep_reference(variant, *tensors)
    if AB.device.type != "cuda":
        raise ValueError(f"sweep runs on CUDA or the CPU, not {AB.device}")
    device = canonical_device(AB.device)
    if AB.dim() != 3 or AB.shape[2] < AB.shape[1]:
        raise ValueError(f"AB must be (H, n, n+m), got {tuple(AB.shape)}")
    H, n, Z = AB.shape
    m = Z - n
    if n < m:
        raise ValueError(f"the experiment reads W[:m], so m <= n; got n={n}, m={m}")
    if m > riccati_cuda.MAX_M:
        raise ValueError(f"the kernel runs K4's one-warp steps, m <= {riccati_cuda.MAX_M}; "
                         f"got m={m}")
    shapes = ((H, n, Z), (H, n), (H, m), (H, n, n), (H, m, m), (H, m, n), (n, 1 + n))
    for name, x, shape in zip(("AB", "cx", "cu", "cxx", "cuu", "cux", "WT"), tensors, shapes):
        _check(name, x, device, shape)
    with torch.cuda.device(device):
        ks = torch.empty((H, m), dtype=torch.float32, device=device)
        Ks = torch.empty((H, m, n), dtype=torch.float32, device=device)
        rc = _library().kmanip_sweep_floor(
            VARIANTS.index(variant), H, n, m, *(x.data_ptr() for x in tensors),
            ks.data_ptr(), Ks.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sweep floor kernel launch failed: cudaError_t {rc}")
    sweep.launches += 1
    return ks, Ks


sweep.launches = 0


def random_inputs(H: int, n: int, m: int, seed: int = 0):
    """The experiment's seeded inputs (tools/exp_sweep_floor.py:118-125):
    (AB, cx, cu, cxx, cuu, cux, WT), float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    AB = 0.05 * rng.randn(H, n, n + m)
    cx = rng.randn(H, n)
    cu = rng.randn(H, m)
    cxx = 0.01 * rng.randn(H, n, n) + np.eye(n)
    cuu = 0.01 * rng.randn(H, m, m) + np.eye(m)
    cux = 0.01 * rng.randn(H, m, n)
    WT = 0.01 * rng.randn(n, 1 + n)
    return tuple(a.astype(np.float32) for a in (AB, cx, cu, cxx, cuu, cux, WT))


def sweep_reference(variant: str, AB, cx, cu, cxx, cuu, cux, WT):
    """The plain PyTorch version of `sweep`, on any device and in the
    inputs' dtype: the same step math in torch ops, one step at a time.
    `load1nostore` writes row 0 only; its other rows are zero."""
    if variant not in VARIANTS:
        raise ValueError(f"variant is one of {VARIANTS}, not {variant!r}")
    H, n, Z = AB.shape
    m = Z - n
    tiny = 1e-9
    W = WT.clone()
    ks = AB.new_zeros((H, m))
    Ks = AB.new_zeros((H, m, n))
    for t in range(H - 1, -1, -1):
        if variant == "loop":
            W_next = W + torch.tensor(tiny, dtype=W.dtype) * t
        elif variant in ("load1", "load1nostore"):
            W_next = W + cxx[t, 0, 0] * tiny
        elif variant == "mem":
            W_next = W + (cx[t, 0] + cu[t, 0] + cxx[t, 0, 0] + cuu[t, 0, 0] + cux[t, 0, 0]
                          + AB[t, 0, 0]) * tiny
        if variant == "load1nostore":
            ks[0] = W[0, :m] * tiny
            Ks[0] = W[:m, 1:] * tiny
        elif variant in ("loop", "load1"):
            ks[t], Ks[t] = W[:m, 0], W[:m, 1:]
        elif variant == "mem":
            ks[t], Ks[t] = cu[t] + W[:m, 0], cux[t] + W[:m, 1:]
        else:
            GW = AB[t].transpose(0, 1) @ W  # (n+m, 1+n)
            GWG = GW[:, 1:] @ AB[t]  # (n+m, n+m)
            Qx, Qu = cx[t] + GW[:n, 0], cu[t] + GW[n:, 0]
            Qxx = cxx[t] + GWG[:n, :n]
            Quu = cuu[t] + GWG[n:, n:]
            Qux = cux[t] + GWG[n:, :n]
            if variant in ("trans", "gersh"):
                Quu = 0.5 * (Quu + Quu.transpose(0, 1))
            if variant == "gersh":
                amax = torch.max(torch.abs(Quu))
                dg = torch.diagonal(Quu)
                gersh_min = torch.min(dg - (torch.sum(torch.abs(Quu), dim=1) - torch.abs(dg)))
                lam = 1e-5 * amax + torch.clamp(1e-4 * amax - gersh_min, min=0.0)
            else:
                lam = torch.tensor(1e-6, dtype=AB.dtype, device=AB.device)
            C = torch.cat([Qu[:, None], Qux], dim=1)  # (m, 1+n)
            Kk = -(C / (torch.diagonal(Quu) + lam)[:, None])
            U1 = Quu @ Kk + lam * Kk + C
            Mm = Kk.transpose(0, 1) @ U1 + C.transpose(0, 1) @ Kk  # (1+n, 1+n)
            W_next = torch.cat([Qx[:, None], Qxx], dim=1) + Mm[1:, :]
            if variant in ("trans", "gersh"):
                Vxx = 0.5 * (W_next[:, 1:] + W_next[:, 1:].transpose(0, 1))
                W_next = torch.cat([W_next[:, :1], Vxx], dim=1)
            ks[t], Ks[t] = Kk[:, 0], Kk[:, 1:]
        W = W_next
    return ks, Ks
