"""Bisect the Riccati sweep's per-step floor on the card.

    python -m gym_kmanip_torch.tools.exp_sweep_floor [variants...] [--horizon H]

Port of the JAX package's TPU experiment `tools/exp_sweep_floor.py`. Each
variant (ops/sweep_floor_cuda.VARIANTS; csrc/sweep_floor.cuh says what each
computes) is the Riccati sweep kernel's step (ops/riccati_cuda, K4) with
more cut away: loop, load1, load1nostore, mem (the step loop, its barrier,
its loads and stores), then gemm, trans and gersh (the products, the
symmetrizations, the Gershgorin lift). On the experiment's seeded inputs at
its widths (n = 40, m = 20, H = 100 unless --horizon says otherwise), it
prints the milliseconds per sweep of each variant, the best of 3 runs of 50
launches by CUDA events, as a share of K4's on the same inputs, and K4's
less gersh's: what K4's factor and substitutions, which no variant runs,
cost a sweep. Needs a CUDA device; exits non-zero without one.
"""

import argparse
import sys

import torch

from gym_kmanip_torch.ops import _build, riccati_cuda, sweep_floor_cuda

N, M = 40, 20
REPS = 50


def k4_args(AB, cx, cu, cxx, cuu, cux, WT):
    """The Riccati sweep's inputs for the experiment's: A and B split from
    AB, the terminal value from WT."""
    n = AB.shape[1]
    return (AB[:, :, :n].contiguous(), AB[:, :, n:].contiguous(), cx, cu, cxx, cuu, cux,
            WT[:, 0].contiguous(), WT[:, 1:].contiguous())


def ms_per_call(fn, reps=REPS, repeats=3):
    """Best over `repeats` of the mean milliseconds per call of `fn` over
    `reps` calls, by CUDA events, after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def measure(variants, horizon: int, device):
    """{variant: ms per sweep} and K4's ms per sweep, on the seeded inputs."""
    inputs = [torch.as_tensor(a, device=device)
              for a in sweep_floor_cuda.random_inputs(horizon, N, M)]
    times = {v: ms_per_call(lambda v=v: sweep_floor_cuda.sweep(v, *inputs)) for v in variants}
    lam = torch.zeros((), device=device)
    args = k4_args(*inputs)
    k4 = ms_per_call(lambda: riccati_cuda.riccati_sweep(*args, 1e-6, lam_extra=lam))
    return times, k4


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("variants", nargs="*", metavar="variant",
                   help=f"any of {', '.join(sweep_floor_cuda.VARIANTS)} (default: all)")
    p.add_argument("--horizon", type=int, default=100)
    args = p.parse_args(argv)
    variants = args.variants or list(sweep_floor_cuda.VARIANTS)
    unknown = sorted(set(variants) - set(sweep_floor_cuda.VARIANTS))
    if unknown:
        p.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        sys.exit("exp_sweep_floor: no CUDA device")
    _build.build_libraries([sweep_floor_cuda.LIBRARY, riccati_cuda.LIBRARY])
    times, k4 = measure(variants, args.horizon, torch.device("cuda", 0))
    print(f"{torch.cuda.get_device_name(0)}; H={args.horizon} n={N} m={M}")
    for v, ms in times.items():
        print(f"{v:13s} {ms:8.4f} ms/sweep ({ms / k4:6.1%} of K4)")
    print(f"{'K4 riccati':13s} {k4:8.4f} ms/sweep")
    if "gersh" in times:
        print(f"{'K4 - gersh':13s} {k4 - times['gersh']:8.4f} ms/sweep (K4's factor and "
              f"substitutions)")


if __name__ == "__main__":
    main()
