"""The host's time in the span `mppi.update` (std, softmax, the weighted
sum, the clamp, argmin and the pick, once an iteration), in ms per solve
of the traced segment, from the program's span log (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.host_ms(run, "mppi.update")
