"""`k2.pair_launch_pct` on synthetic traces whose K2 names carry each team
width, and on traces where it finds nothing to read."""

from types import SimpleNamespace

import pytest

from harness import manifest
from harness.trace import Trace

HALF = "void kmanip::rollout_pick_kernel<10, 2, true, true, kmanip::HalfWarpTeam>(float const*)"
WARP = "void kmanip::rollout_pick_kernel<10, 2, true, true, kmanip::WarpTeam>(float const*)"
UNNAMED = "void kmanip::rollout_pick_kernel<10, 2, true, true>(float const*)"


def _read(names):
    """The metric over a trace of glue kernels and one K2 launch per name."""
    ev, t = [], 0.0
    for name in names:
        for n, dur in (("glue_a", 10.0), (name, 600.0), ("glue_b", 20.0)):
            ev.append({"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": dur})
            t += dur + 15.0
    run = SimpleNamespace(trace=Trace.from_chrome(ev), trace_solves=len(names))
    return manifest.reader("k2.pair_launch_pct")(run)


@pytest.mark.parametrize("names,pct", [([HALF] * 4, 100.0), ([WARP] * 4, 0.0),
                                       ([HALF, WARP, WARP, WARP], 25.0)])
def test_pair_launch_pct_reads_the_team_in_each_k2_name(names, pct):
    assert _read(names) == pytest.approx(pct)


def test_pair_launch_pct_finds_nothing_without_a_k2_team():
    assert _read([]) is None  # no K2 launch
    assert _read([UNNAMED] * 2) is None  # K2 names without a team
    assert manifest.reader("k2.pair_launch_pct")(SimpleNamespace(trace=None)) is None
