"""The readers of the program's spans (`harness/spans.py`): their arithmetic
on synthetic span logs, no reading where the log does not hold the
segment's solves, and the attribution of the device's idle time on a
hand-built timeline."""

from types import SimpleNamespace

import pytest
import torch

from harness import manifest, spans
from harness.systems import Program
from harness.trace import Op, Trace
from conftest import tiny_cell

HOST = ("mppi.noise_host_ms", "mppi.candidates_host_ms", "k2.host_ms", "mppi.update_host_ms")
BASE = 1_000_000_000_000  # the trace's origin, ns


def _span(name, a_us, b_us, parent, solve):
    from gym_kmanip_torch.utils.profiling import Span

    return Span(name, BASE + int(a_us * 1e3), BASE + int(b_us * 1e3), parent, solve)


def _log(n_solves=2, n_iters=1, dropped=0):
    """Solve j starts at 1000 j us and lasts 400 us: noise 10 us, candidates
    20 us, K2's wrapper 30 us, update 40 us an iteration."""
    recs = []
    for j in range(n_solves):
        t, root = 1000.0 * j, len(recs)
        recs.append(_span("mppi.solve", t, t + 400.0, -1, j + 1))
        for _ in range(n_iters):
            for name, d in (("mppi.noise", 10), ("mppi.candidates", 20), ("k2.wrapper", 30),
                            ("mppi.update", 40)):
                recs.append(_span(name, t + 1.0, t + 1.0 + d, root, j + 1))
                t += d + 2.0
    return recs, dropped, lambda: BASE


def _run(trace_solves=2, ops=()):
    return SimpleNamespace(trace_solves=trace_solves, trace=Trace(list(ops)))


@pytest.fixture
def log(monkeypatch):
    """Stands in a synthetic log for the program's."""
    held = {}

    def use(*args, **kw):
        held["log"] = _log(*args, **kw)
        monkeypatch.setattr(spans, "program_log", lambda: held["log"])

    return use


@pytest.mark.parametrize("n_iters", [1, 2])
def test_host_readers_sum_each_span_per_solve(log, n_iters):
    log(n_solves=2, n_iters=n_iters)
    got = [manifest.reader(m)(_run()) for m in HOST]
    assert got == pytest.approx([n_iters * d * 1e-3 for d in (10, 20, 30, 40)])


def test_no_reading_without_the_segment_s_solves(log, monkeypatch):
    log(n_solves=3)
    assert all(manifest.reader(m)(_run(trace_solves=2)) is None for m in HOST)
    log(n_solves=2, dropped=1)
    assert all(manifest.reader(m)(_run(trace_solves=2)) is None for m in HOST)
    assert manifest.reader("device.idle_in_solve_pct")(
        _run(2, [Op("k", "kernel", 0.0, 1.0), Op("k", "kernel", 5.0, 1.0)])) is None
    log(n_solves=2)
    assert manifest.reader("k2.host_ms")(_run(trace_solves=0)) is None
    monkeypatch.setattr(spans, "program_log", lambda: None)  # a program without spans
    assert all(manifest.reader(m)(_run()) is None for m in (*HOST, "device.idle_in_solve_pct"))


def test_a_program_without_the_span_log_reads_as_none(monkeypatch):
    from gym_kmanip_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.program_log() is None


def test_idle_time_is_split_by_the_solve_spans(log):
    # solves over [0, 400] and [1000, 1400] us. Device ops: busy [100, 200],
    # [300, 500], [900, 1100], [1300, 1600]. Idle: [200, 300] (all in solve
    # 0), [500, 900] (none), [1100, 1300] (all in solve 1): 300 of 700 us
    log(n_solves=2)
    ops = [Op("a", "kernel", 100.0, 100.0), Op("b", "kernel", 300.0, 150.0),
           Op("c", "gpu_memcpy", 400.0, 100.0), Op("d", "kernel", 900.0, 200.0),
           Op("e", "kernel", 1300.0, 300.0)]
    got = manifest.reader("device.idle_in_solve_pct")(_run(2, ops))
    assert got == pytest.approx(100.0 * 300.0 / 700.0)
    assert manifest.reader("device.idle_pct")(_run(2, ops)) == pytest.approx(
        100.0 * 700.0 / 1500.0)
    # a gap cut by a solve's edge counts the part inside it
    assert spans.idle_in([Op("a", "kernel", 0.0, 350.0), Op("b", "kernel", 450.0, 10.0)],
                         [(0.0, 400.0), (1000.0, 1400.0)]) == pytest.approx(50.0)
    assert spans.idle_in([Op("a", "kernel", 0.0, 10.0)], [(0.0, 5.0)]) is None


def test_the_program_s_own_spans_read_on_the_cpu():
    """Two solves of the program under a CPU profiler: every host reader
    reads, and the four sum to no more than the mean `mppi.solve` span."""
    from gym_kmanip_torch.utils import profiling

    from harness import traffic
    from reference import model as rmodel

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cell = tiny_cell()
    robot = rmodel.load(cell.config["robot"])
    program = Program(cell, robot, torch.device("cpu"))
    program.bind(traffic.start_pool(robot, cell.traffic, traffic.seeds(7).states,
                                    torch.device("cpu")))
    profiling.clear_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for i in range(2):
                program.solve(program.prepare(i, 100 + i))
        run = SimpleNamespace(trace_solves=2, trace=None)
        got = [manifest.reader(m)(run) for m in HOST]
        solve = [s for s in profiling.spans() if s.name == "mppi.solve"]
        mean_ms = 1e-6 * sum(s.end_ns - s.start_ns for s in solve) / len(solve)
    finally:
        program.close()
        profiling.clear_spans()
        torch.set_num_threads(threads)
    assert None not in got and got[2] == 0.0  # the CPU scores without K2's wrapper
    assert all(v >= 0.0 for v in got) and sum(got) <= mean_ms
