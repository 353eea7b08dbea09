"""Batched SPD factor and solve for the plain PyTorch substep.

Port of `gym_kmanip_tpu/ops/linalg.py:54-101`. The JAX package unrolls the
Cholesky at trace time so XLA fuses it; eager PyTorch gets the same result
from one batched library factorization, and `substep`'s factor is reused
for the constraint sweeps exactly as the unrolled one is. The CUDA kernel
carries its own Cholesky (csrc/substep.cuh).
"""

import torch


def cholesky_factor(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD M (..., n, n).

    `cholesky_ex` reports a failed factorization in its `info` output
    instead of raising, so the factor never waits on the device. The
    substep's matrices are mass matrices plus a positive diagonal, so SPD
    by construction."""
    L, _info = torch.linalg.cholesky_ex(M)
    return L


def cholesky_substitute(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b for b (..., n) given L from `cholesky_factor`."""
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)

