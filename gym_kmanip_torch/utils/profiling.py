"""Timers, spans and traces.

Port of `gym_kmanip_tpu/utils/profiling.py`: wall-clock timers with
calls/s counters, a `torch.profiler` trace context that exports a Chrome
trace, and `sync`, which waits for the card before a timer reads the clock
(PyTorch returns before the device finishes).

Beyond the port: `span(name)` marks a block of the program's host code.
With no `torch.profiler` session in the process it is one shared no-op
context (no clock read, no allocation). Inside a session it times the
block with `TIMERS(name)` and appends a `Span` to a bounded in-memory log
(`spans()`), in ns on the clock of the profiler's Chrome trace:
`(t_ns - trace_base_ns()) / 1e3` is on the axis of the trace's `ts`.
`trace()` writes the spans into the trace it exports.
"""

import contextlib
import dataclasses
import functools
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

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
        self.add(time.perf_counter() - self._t0)
        return False

    def add(self, seconds: float):
        """Count one call that took `seconds` (timed by the caller)."""
        self.total += seconds
        self.count += 1

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


@dataclasses.dataclass(slots=True)
class Span:
    """One span of the log: host time in ns on the trace's clock."""

    name: str
    start_ns: int
    end_ns: int  # -1 while the span is open
    parent: int  # index in the log of the innermost span open at entry; -1: none
    solve: int  # the id of the solve the span belongs to; -1: outside a solve


class SpanLog:
    """The spans recorded since the last `clear()`, at most `cap` of them;
    `dropped` counts those that found the log full."""

    def __init__(self, cap: int = 65_536):
        self.cap = cap
        self.records: List[Span] = []
        self.dropped = 0
        self.solves = 0  # solve ids handed out
        self._open: List[tuple] = []  # (index or -1, solve id) of the open spans

    def clear(self):
        self.records, self.dropped, self._open = [], 0, []

    def begin(self, name: str, new_solve: bool, start_ns: int):
        parent, solve = self._open[-1] if self._open else (-1, -1)
        if new_solve:
            self.solves += 1
            solve = self.solves
        index = -1
        if len(self.records) < self.cap:
            index = len(self.records)
            self.records.append(Span(name, start_ns, -1, parent, solve))
        else:
            self.dropped += 1
        self._open.append((index, solve))

    def end(self, end_ns: int):
        if not self._open:  # cleared while the span was open
            return
        index, _ = self._open.pop()
        if index >= 0:
            self.records[index].end_ns = end_ns


SPANS = SpanLog()
SPAN_TID = 2**31 - 1  # the spans' row in an exported trace: no thread of the process


class _NoSpan:
    """What `span` returns with no profiler session: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_name", "_new_solve", "_start")

    def __init__(self, name: str, new_solve: bool):
        self._name, self._new_solve = name, new_solve

    def __enter__(self):
        self._start = time.time_ns()
        SPANS.begin(self._name, self._new_solve, self._start)
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        SPANS.end(end)
        TIMERS(self._name).add((end - self._start) * 1e-9)
        return False


def span(name: str, solve: bool = False):
    """A context that marks a block of host code as the span `name` while a
    `torch.profiler` session is active, and does nothing otherwise. With
    `solve`, the span opens a solve: it and the spans inside it share a new
    solve id."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, solve)


def spans() -> List[Span]:
    """The span log: each span where it opened, a parent before its children."""
    return SPANS.records


def dropped_spans() -> int:
    """Spans not logged since the last `clear_spans()`: the log was full."""
    return SPANS.dropped


def clear_spans():
    SPANS.clear()


def _export(prof) -> dict:
    """The profiler's Chrome trace as a dict (by way of a temporary file)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


@functools.lru_cache(maxsize=None)
def trace_base_ns() -> int:
    """This process's `baseTimeNanoseconds`, the origin of the `ts` of the
    Chrome traces `torch.profiler` exports (0 where the trace has none), read
    once from a trace of CPU activity. Call it outside a profiler session."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.zeros(1)
    return int(_export(prof).get("baseTimeNanoseconds", 0))


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "kmanip_trace")):
    """`torch.profiler` over the block (the CPU, and the card where there is
    one); on exit the Chrome trace is written to `log_dir`/trace.json, which
    chrome://tracing and Perfetto open, with the spans the block recorded on
    a row of their own. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(SPANS.records)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    events = _export(prof)
    base = events.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    rows = events.setdefault("traceEvents", [])
    rows.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
                 "args": {"name": "spans (gym_kmanip_torch.utils.profiling)"}})
    for i, s in enumerate(SPANS.records[first:], first):
        rows.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": SPAN_TID,
                     "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                     "args": {"index": i, "parent": s.parent, "solve": s.solve}})
    with open(os.path.join(log_dir, "trace.json"), "w") as f:
        json.dump(events, f)


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
