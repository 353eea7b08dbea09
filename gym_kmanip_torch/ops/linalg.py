"""Batched SPD factor and solve.

Port of `gym_kmanip_tpu/ops/linalg.py`. Two families:

- `cholesky_factor` / `cholesky_substitute`, the plain substep's solve:
  the JAX package unrolls the Cholesky at trace time so XLA fuses it;
  eager PyTorch gets the same result from one batched library
  factorization, and `substep`'s factor is reused for the constraint
  sweeps exactly as the unrolled one is. The fused CUDA kernels carry their
  own Cholesky (csrc/substep.cuh).
- `cholesky_factor_unrolled`, `cholesky_substitute_unrolled` and
  `cholesky_solve_unrolled`: the JAX package's Cholesky-Crout in its
  operation order, and `batch_aware_cholesky_solve`, which sends a batch on
  the card to the solve kernel (ops/chol_solve_cuda, K7). The staged
  substep (`dynamics/engine.substep_staged`) solves through it.
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


def cholesky_factor_unrolled(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD M (..., n, n) by Cholesky-Crout, column
    by column, each entry's products subtracted in the order of the JAX
    package's trace-time unroll (and of the solve kernel). A non-positive
    pivot gives NaN, as `sqrt` does; `cholesky_ex` would return a partial
    factor instead."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(n):
        s = M[..., j:, j]  # column j from the diagonal down
        for kk in range(j):
            s = s - L[..., j:, kk] * L[..., j, kk, None]
        d = torch.sqrt(s[..., :1])
        L[..., j, j] = d[..., 0]
        L[..., j + 1:, j] = s[..., 1:] * (1.0 / d)
    return L


def cholesky_substitute_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b for b (..., n) given L from
    `cholesky_factor_unrolled`, in the JAX package's operation order (its
    `cholesky_substitute`)."""
    n = b.shape[-1]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for kk in range(i):
            s = s - L[..., i, kk] * y[kk]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for kk in range(i + 1, n):
            s = s - L[..., kk, i] * x[kk]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def cholesky_solve_unrolled(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b for SPD M (..., n, n), b (..., n) by Cholesky-Crout,
    broadcasting over the leading dimensions of both."""
    return cholesky_substitute_unrolled(cholesky_factor_unrolled(M), b)


def batch_aware_cholesky_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve M (..., n, n), b (..., n) -> (..., n), used by the staged
    substep.

    Tensors on the CPU run `cholesky_solve_unrolled`. Tensors on the card
    go to the solve kernel: the leading dimensions broadcast and flatten
    into its batch K (an unbatched problem is a batch of one), one launch
    per call. Any other device raises."""
    if M.device != b.device:
        raise ValueError(f"M is on {M.device} and b on {b.device}")
    if M.device.type == "cpu":
        return cholesky_solve_unrolled(M, b)
    if M.device.type != "cuda":
        raise ValueError(f"batch_aware_cholesky_solve runs on CUDA or the CPU, not {M.device}")
    from gym_kmanip_torch.ops.chol_solve_cuda import cholesky_solve_batched

    n = M.shape[-1]
    batch = torch.broadcast_shapes(M.shape[:-2], b.shape[:-1])
    x = cholesky_solve_batched(M.expand(batch + (n, n)).reshape(-1, n, n).contiguous(),
                               b.expand(batch + (n,)).reshape(-1, n).contiguous())
    return x.reshape(batch + (n,))
