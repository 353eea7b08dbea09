"""The program's own spans over the traced segment, for the per-layer
metrics that read them.

Under a profiler session the port records host spans
(`gym_kmanip_torch.utils.profiling.span`): `mppi.solve` around each solve,
and inside it `mppi.noise`, `mppi.candidates` and `mppi.update` once an
iteration and `k2.wrapper` around K2's launch. The traced segment is the
only profiler session of a run, so the span log holds its spans. A
program without the log, a log that dropped records, or one whose count of
`mppi.solve` differs from the segment's solves gives no reading (None).
"""

from typing import List, Optional, Tuple

SOLVE = "mppi.solve"


def program_log():
    """(records, dropped, trace_base_ns) of the program's span log; None
    where the program records no spans."""
    try:
        from gym_kmanip_torch.utils import profiling

        return profiling.spans(), profiling.dropped_spans(), profiling.trace_base_ns
    except (ImportError, AttributeError):
        return None


def segment_spans(run, log=None) -> Optional[list]:
    """The records of the segment's solves, or None where the log cannot be
    read as those of `run.trace_solves` solves."""
    log = program_log() if log is None else log
    if log is None or not run.trace_solves:
        return None
    records, dropped, _ = log
    if dropped:
        return None
    solves = {r.solve for r in records if r.name == SOLVE}
    if sum(r.name == SOLVE for r in records) != run.trace_solves:
        return None
    return [r for r in records if r.solve in solves and r.end_ns >= r.start_ns]


def host_ms(run, name: str, log=None) -> Optional[float]:
    """The host time in the spans `name`, in ms per solve of the segment."""
    records = segment_spans(run, log)
    if records is None:
        return None
    return 1e-6 * sum(r.end_ns - r.start_ns for r in records if r.name == name) / run.trace_solves


def _merged(intervals) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_in(ops, inside) -> Optional[float]:
    """The share, in %, of the device's idle time between its first and last
    operation (the complement of the union of `ops`, each with `start_us`
    and `dur_us`) that falls inside the union of the intervals `inside`
    ((start_us, end_us) on the same axis). None with no idle time."""
    busy = _merged((o.start_us, o.start_us + o.dur_us) for o in ops)
    idle = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    inside = _merged(inside)
    covered, j = 0.0, 0
    for a, b in idle:
        while j < len(inside) and inside[j][1] <= a:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < b:
            covered += min(b, inside[k][1]) - max(a, inside[k][0])
            k += 1
    return 100.0 * covered / total


def idle_in_solve_pct(run, log=None) -> Optional[float]:
    """Of the device's idle time in the traced window, the share during
    which the host was inside an `mppi.solve` span, in %."""
    if run.trace is None:
        return None
    log = program_log() if log is None else log
    records = segment_spans(run, log)
    if records is None:
        return None
    base = log[2]()
    return idle_in(run.trace.ops, [((r.start_ns - base) / 1e3, (r.end_ns - base) / 1e3)
                                   for r in records if r.name == SOLVE])
