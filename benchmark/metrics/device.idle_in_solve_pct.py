"""Of the device's idle time in the traced window (the complement of the
union of its operations, as `device.idle_pct` takes it), the share during
which the host was inside an `mppi.solve` span, in %: the rest is the
caller's, u0's copy and the loop. The spans are put on the trace's axis
with the program's `trace_base_ns()` (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.idle_in_solve_pct(run)
