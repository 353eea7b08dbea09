"""K2's device time per solve (csrc/rollout_pick.cu, `rollout_pick_kernel`):
the sum over the traced segment's launches, in ms, over its solves, from
the profiler's trace. The run compares the launches with the solves
(`k2_launches_off`)."""

from harness.systems import K2_KERNEL


def read(run):
    if run.trace is None or not run.trace_solves:
        return None
    ks = run.trace.kernels(K2_KERNEL)
    if not ks:
        return None
    return 1e-3 * sum(k.dur_us for k in ks) / run.trace_solves
