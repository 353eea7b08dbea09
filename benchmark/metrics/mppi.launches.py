"""Device kernels per solve in the traced segment (the profiler's trace):
every kernel the solve launches, K2 and the glue around it."""


def read(run):
    if run.trace is None or not run.trace.kernels():
        return None
    return len(run.trace.kernels()) / run.trace_solves
