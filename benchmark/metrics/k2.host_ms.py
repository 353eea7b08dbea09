"""The host's time in the span `k2.wrapper` (the CUDA branch of
`rollout_pick_costs`: its checks, the spec and model buffers, the start
state's `cat` and the ctypes launch), in ms per solve of the traced
segment, from the program's span log (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.host_ms(run, "k2.wrapper")
