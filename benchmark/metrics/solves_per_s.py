"""Solves completed in the window over the window's length (host clock)."""


def read(run):
    return run.solves / run.window_s
