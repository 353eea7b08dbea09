"""The host's time in `solve()` until it returns, before the copy of u0
(the call returns before the device finishes), mean per solve of the
window, in ms: the MPPI loop's dispatch."""


def read(run):
    return 1e3 * sum(run.host_s) / len(run.host_s)
