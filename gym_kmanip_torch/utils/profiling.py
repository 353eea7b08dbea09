"""Timers and traces.

Port of `gym_kmanip_tpu/utils/profiling.py`: wall-clock timers with
calls/s counters, a `torch.profiler` trace context that exports a Chrome
trace, and `sync`, which waits for the card before a timer reads the clock
(PyTorch returns before the device finishes).
"""

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from gym_kmanip_torch.utils.checkpoint import tree_leaves


class Timer:
    """Accumulating wall-clock timer with rate reporting.

    >>> t = Timer("mpc_solve")
    >>> with t:  # doctest: +SKIP
    ...     solver(...)
    >>> t.rate_hz  # doctest: +SKIP
    """

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total / max(self.count, 1)

    @property
    def rate_hz(self) -> float:
        return self.count / self.total if self.total > 0 else 0.0

    def __repr__(self):
        return f"Timer({self.name}: {self.mean_ms:.2f} ms/call, {self.rate_hz:.1f} Hz)"


class Timers:
    """Named timer registry."""

    def __init__(self):
        self._timers: Dict[str, Timer] = {}

    def __call__(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name)
        return self._timers[name]

    def report(self) -> Dict[str, float]:
        return {n: t.mean_ms for n, t in self._timers.items()}


TIMERS = Timers()


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "kmanip_trace")):
    """`torch.profiler` over the block (the CPU, and the card where there is
    one); on exit the Chrome trace is written to `log_dir`/trace.json, which
    chrome://tracing and Perfetto open. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(out):
    """Wait for the work that made `out` (a tree of tensors) and return its
    last leaf on the host as numpy (None for a tree with no leaf). Every
    timing of device work ends with sync()."""
    leaves = tree_leaves(out)
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
        torch.cuda.synchronize()
    if not leaves:
        return None
    last = leaves[-1]
    return last.detach().cpu().numpy() if isinstance(last, torch.Tensor) else np.asarray(last)


def timed_block_until_ready(fn, *args, n: int = 10, warmup: int = 1):
    """Mean wall seconds per call of `fn(*args)` over `n` calls after
    `warmup` calls, each run ended by `sync`."""
    for _ in range(warmup):
        out = fn(*args)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / n
