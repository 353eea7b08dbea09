"""The share of K2's launches in the traced segment that ran two rollouts a
warp, in %: from the profiler's trace, where the name of each K2 launch
shows its team (`kmanip::HalfWarpTeam`, two a warp, or `kmanip::WarpTeam`).
Nothing where the trace has no K2 launch, or no K2 name shows a team (a
program whose K2 has one team width)."""

from harness.systems import K2_KERNEL


def read(run):
    if run.trace is None:
        return None
    ks = run.trace.kernels(K2_KERNEL)
    if not any("WarpTeam" in k.name for k in ks):
        return None
    return 100.0 * sum("HalfWarpTeam" in k.name for k in ks) / len(ks)
