"""The batched dense SPD solve as a hand-written CUDA kernel
(csrc/chol_solve.cu).

Replaces the JAX package's Pallas TPU kernel
`gym_kmanip_tpu/ops/pallas_linalg.py::cholesky_solve_pallas` and keeps its
signature: M (K, n, n), b (K, n) -> x (K, n), for any n up to 24.
`cholesky_solve_batched` launches the kernel for CUDA tensors and counts
the launch in `cholesky_solve_batched.launches`; for CPU tensors it runs
the plain version, `cholesky_solve_batched_reference` (the Cholesky-Crout
of `ops/linalg.cholesky_solve_unrolled`, in the same operation order).
Anything else raises.

Importing this module needs neither nvcc nor a GPU: the kernel is built
(ops/_build.py) at its first launch, or ahead of it by
`_build.build_libraries`.
"""

import ctypes
import functools

import torch

from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.ops import _build
from gym_kmanip_torch.ops.substep_cuda import _check

SOURCES = ("chol_solve.cu",)
HEADERS = ("staged_team.cuh", "substep.cuh", "substep_team.cuh", "team.cuh")
LIBRARY = ("chol_solve", SOURCES, HEADERS)
MAX_N = 24  # csrc/chol_solve.cu instantiates the kernel for every n in 1..MAX_N

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load_library(*LIBRARY))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry point's argument types on a loaded library."""
    lib.kmanip_chol_solve.argtypes = [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P]
    lib.kmanip_chol_solve.restype = ctypes.c_int
    return lib


def cholesky_solve_batched(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with M x = b for K SPD matrices: M (K, n, n), b (K, n), float32
    and contiguous on one device -> (K, n). Only M's lower triangle is
    read; a matrix that is not positive definite gives NaNs."""
    if M.device != b.device:
        raise ValueError(f"M is on {M.device} and b on {b.device}")
    if M.device.type == "cpu":
        return cholesky_solve_batched_reference(M, b)
    if M.device.type != "cuda":
        raise ValueError(f"cholesky_solve_batched runs on CUDA or the CPU, not {M.device}")
    device = canonical_device(M.device)
    if b.dim() != 2:
        raise ValueError(f"b must be (K, n), got {tuple(b.shape)}")
    K, n = b.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the solve kernel is built for n in 1..{MAX_N}, not {n}")
    _check("M", M, device, (K, n, n))
    _check("b", b, device, (K, n))
    with torch.cuda.device(device):
        x = torch.empty_like(b)
        rc = _library().kmanip_chol_solve(
            n, K, M.data_ptr(), b.data_ptr(), x.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"solve kernel launch failed: cudaError_t {rc}")
    cholesky_solve_batched.launches += 1
    return x


cholesky_solve_batched.launches = 0


def cholesky_solve_batched_reference(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `cholesky_solve_batched`, on any
    device."""
    from gym_kmanip_torch.ops.linalg import cholesky_solve_unrolled

    return cholesky_solve_unrolled(M, b)
