"""The spans of `gym_kmanip_torch.utils.profiling` inside the MPPI solve, and
the solve's totals hook, on the CPU at a tiny size (K=8, H=3).

With no profiler session a solve records nothing and reads no clock;
under one, each solve records `mppi.solve` with `mppi.noise`,
`mppi.candidates` and `mppi.update` inside it once per iteration, on the
clock of the profiler's Chrome trace. The card's test of that clock
against K2's launch is in tests/test_torch_cuda.py.
"""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.mpc import mppi
from gym_kmanip_torch.utils import profiling

K, H = 8, 3
ITER = ("mppi.noise", "mppi.candidates", "mppi.update")


@pytest.fixture(autouse=True)
def _fresh_log():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear_spans()
    yield
    profiling.clear_spans()
    torch.set_num_threads(threads)


def _solver(n_iters=1, on_costs=None):
    m = get_model("solo_arm")
    cfg = mppi.MPPIConfig(horizon=H, n_samples=K, n_iters=n_iters)
    solve = mppi.make_fused_pick_solver(m, cfg, on_costs=on_costs)
    return solve, mppi.init_mppi(m, cfg, seed=3, device="cpu"), init_state(m, device="cpu")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_records_nothing_and_solves_the_same(monkeypatch):
    solve, st, s0 = _solver()
    assert profiling.span("mppi.solve") is profiling.span("mppi.noise")  # one shared no-op
    start = mppi.rewinder(st)
    counts = dict(profiling.TIMERS.report())

    def no_clock():
        raise AssertionError("a span read the clock with no profiler session")

    with monkeypatch.context() as mp:
        mp.setattr(time, "time_ns", no_clock)
        mp.setattr(time, "perf_counter", no_clock)
        off = solve(start(), s0)
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
    assert profiling.TIMERS.report() == counts
    with _cpu_profile():
        on = solve(start(), s0)
    assert len(profiling.spans()) == 4
    for a, b in zip((off[0].nominal, off[1], off[2]), (on[0].nominal, on[1], on[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_iters", [1, 2])
def test_each_solve_records_its_spans_nested_and_in_order(n_iters):
    solve, st, s0 = _solver(n_iters)
    before = profiling.TIMERS("mppi.update").count
    with _cpu_profile():
        st, _, _ = solve(st, s0)
        solve(st, s0)
    log = profiling.spans()
    assert len(log) == 2 * (1 + 3 * n_iters)
    roots = [i for i, s in enumerate(log) if s.name == "mppi.solve"]
    assert roots == [0, 1 + 3 * n_iters]
    assert log[0].solve != log[roots[1]].solve
    for r in roots:
        root = log[r]
        assert root.parent == -1 and root.start_ns <= root.end_ns
        kids = log[r + 1: r + 1 + 3 * n_iters]
        assert [s.name for s in kids] == list(ITER) * n_iters
        assert all(s.parent == r and s.solve == root.solve for s in kids)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert profiling.TIMERS("mppi.update").count == before + 2 * n_iters


def test_the_log_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling.SPANS, "cap", 5)
    solve, st, s0 = _solver(n_iters=2)  # 7 spans a solve
    with _cpu_profile():
        solve(st, s0)
    assert len(profiling.spans()) == 5 and profiling.dropped_spans() == 2
    assert all(s.end_ns >= s.start_ns for s in profiling.spans())
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_spans_lie_on_the_axis_of_the_trace(tmp_path):
    """A `record_function` mark in a CPU trace lies inside the span around
    it (within 50 us) once the span is put on the trace's axis with
    `trace_base_ns()`; `trace()` writes the spans into its trace."""
    base = profiling.trace_base_ns()
    with _cpu_profile() as prof:
        for _ in range(3):
            with profiling.span("outer"):
                with record_function("mark"):
                    torch.ones(16) + 1
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    assert trace.get("baseTimeNanoseconds", 0) == base
    marks = sorted(e["ts"] for e in trace["traceEvents"] if e.get("name") == "mark")
    outer = [((s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3) for s in profiling.spans()]
    assert len(marks) == len(outer) == 3
    for ts, (a, b) in zip(marks, outer):
        assert a - 50.0 <= ts <= b + 50.0

    profiling.clear_spans()
    solve, st, s0 = _solver()
    with profiling.trace(str(tmp_path / "t")):
        solve(st, s0)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    got = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in got] == ["mppi.solve", *ITER]
    a, b = got[0]["ts"], got[0]["ts"] + got[0]["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("name") == "aten::randn"]
    assert ops and all(a - 50.0 <= e["ts"] <= b + 50.0 for e in ops)


@pytest.mark.parametrize("n_iters", [1, 2])
def test_the_totals_hook_hands_out_what_a_tap_sees(monkeypatch, n_iters):
    """`on_costs` gets each iteration's totals, bit for bit those of a tap
    that stands in for `mppi.rollout_pick_costs` (as the benchmark's does)."""
    tapped, hooked = [], []
    fn = mppi.rollout_pick_costs

    def tap(*args, **kwargs):
        out = fn(*args, **kwargs)
        tapped.append(out)
        return out

    monkeypatch.setattr(mppi, "rollout_pick_costs", tap)
    solve, st, s0 = _solver(n_iters, on_costs=lambda it, c: hooked.append((it, c)))
    st, _, _ = solve(st, s0)
    solve(st, s0)
    assert [it for it, _ in hooked] == list(range(n_iters)) * 2
    assert len(tapped) == len(hooked) == 2 * n_iters
    for (_, c), t in zip(hooked, tapped):
        assert c is t and torch.equal(c, t)
