"""The host's time in the span `mppi.noise` (the noise draw, its sigma
scale and the AR(1) filter, once an iteration), in ms per solve of the
traced segment, from the program's span log (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.host_ms(run, "mppi.noise")
