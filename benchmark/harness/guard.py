"""The check that the benchmark's process never loaded JAX.

Module names are compared by their top-level name (the part before the
first dot) whole: the port's package name begins with the letters of the
JAX package's, so a prefix test would be wrong."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gym_kmanip_tpu"})


def jax_modules(modules=None) -> list:
    """The forbidden top-level names among `modules` (default: sys.modules)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)
