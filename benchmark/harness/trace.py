"""The device's side of a traced segment, from torch.profiler's trace.

`profile(fn)` runs `fn()` under the profiler with CUDA activity only (the
host's own ops are not recorded, so the host runs at its untraced pace),
exports the trace to a temporary file and reads its device events back:
kernels, copies and sets, each with its name, start and length.
`Trace` reduces them: the device's busy time as the union of the
intervals, the window from the first start to the last end, time by
kernel name, and the idle gaps named by the device operation that ended
each.
"""

import json
import os
import tempfile
from collections import defaultdict
from typing import List, NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Op(NamedTuple):
    name: str
    cat: str
    start_us: float
    dur_us: float


class Trace:
    def __init__(self, ops: List[Op]):
        self.ops = sorted(ops, key=lambda o: o.start_us)

    @classmethod
    def from_chrome(cls, events) -> "Trace":
        return cls([Op(e["name"], e["cat"], float(e["ts"]), float(e.get("dur", 0.0)))
                    for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS])

    def kernels(self, contains: str = "") -> List[Op]:
        return [o for o in self.ops if o.cat == "kernel" and contains in o.name]

    def _union(self):
        spans = []
        for o in self.ops:
            end = o.start_us + o.dur_us
            if spans and o.start_us <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], end)
            else:
                spans.append([o.start_us, end])
        return spans

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) * 1e-6

    def window_s(self) -> float:
        if not self.ops:
            return 0.0
        return (max(o.start_us + o.dur_us for o in self.ops) - self.ops[0].start_us) * 1e-6

    def device_ops(self, top: int = 10):
        """[[name, seconds], ...]: the device operations that took most time."""
        total = defaultdict(float)
        for o in self.ops:
            total[o.name] += o.dur_us * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[[what, seconds], ...]: idle time summed by the device operation
        that ended each gap ("before <op>"), the largest first. The host was
        dispatching that operation, or what the program does before it."""
        spans = self._union()
        starts = {}
        for o in self.ops:
            starts.setdefault(o.start_us, o.name)
        total = defaultdict(float)
        for (_, end), (nxt, _) in zip(spans, spans[1:]):
            total[f"before {starts[nxt]}"] += (nxt - end) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def profile(fn) -> Trace:
    """Run fn() under torch.profiler (CUDA activity) and read its device ops."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return Trace.from_chrome(events)
