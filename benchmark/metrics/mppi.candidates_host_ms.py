"""The host's time in the span `mppi.candidates` (slot 0's zeroed noise,
the clamp and the proposal's slot, once an iteration), in ms per solve of
the traced segment, from the program's span log (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.host_ms(run, "mppi.candidates")
