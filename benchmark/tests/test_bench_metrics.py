"""The metric readers: the rate and the tail are over every solve of the
window, and the trace's readers work on a small synthetic profiler trace."""

from types import SimpleNamespace

import numpy as np
import pytest

from harness import manifest, runner, work
from harness.trace import Trace
from harness.systems import solve_config
from reference import model as rmodel
from conftest import tiny_cell

K2 = "void kmanip::rollout_pick_kernel<10, 2, true, true>(float const*)"


def _run(**kw):
    cell = tiny_cell()
    base = dict(cell=cell, cfg=solve_config(cell), robot=rmodel.load("solo_arm"), solves=0,
                window_s=1.0, latencies_s=[], host_s=[], setup_s=9.5, trace=None,
                trace_solves=0, k2_launches=None, power="test card, 700 W")
    base.update(kw)
    return SimpleNamespace(**base)


def test_rate_and_tail_are_over_every_solve():
    # 900 fast solves and 100 slow ones: a median of chunks would hide the
    # slow tail, the 95th percentile over all of them does not
    lat = [0.001] * 900 + [0.010] * 100
    run = _run(solves=len(lat), window_s=2.0, latencies_s=lat, host_s=[0.0004] * len(lat))
    assert manifest.reader("solves_per_s")(run) == pytest.approx(500.0)
    assert manifest.reader("solve_ms_p95")(run) == pytest.approx(
        1e3 * np.percentile(np.asarray(lat), 95))
    assert manifest.reader("solve_ms_p95")(run) > 5.0
    assert manifest.reader("mppi.host_ms")(run) == pytest.approx(0.4)
    assert manifest.reader("setup_s")(run) == 9.5


def _chrome():
    """Two solves: two glue kernels, K2, a copy each; idle between them."""
    ev, t = [], 0.0
    for _ in range(2):
        for name, cat, dur in (("glue_a", "kernel", 10.0), (K2, "kernel", 600.0),
                               ("glue_b", "kernel", 20.0), ("Memcpy DtoH", "gpu_memcpy", 5.0)):
            ev.append({"ph": "X", "cat": cat, "name": name, "ts": t, "dur": dur})
            t += dur + 15.0
        t += 300.0
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 0.0, "dur": 5000.0})
    return ev


def test_trace_readers_on_a_synthetic_trace():
    tr = Trace.from_chrome(_chrome())
    run = _run(trace=tr, trace_solves=2, k2_launches=2)
    assert tr.busy_s() == pytest.approx(2 * 635e-6)
    window = (2 * (635 + 4 * 15) + 300 - 15) * 1e-6
    assert tr.window_s() == pytest.approx(window)
    assert manifest.reader("mppi.launches")(run) == 3.0
    assert manifest.reader("k2.device_ms")(run) == pytest.approx(0.6)
    assert manifest.reader("device.idle_pct")(run) == pytest.approx(100 * (1 - 2 * 635e-6 / window))
    c = run.cfg
    flops, nbytes = work.rollout_pick_work(run.robot, c.n_samples, c.horizon, c.n_substeps,
                                           c.contact)
    want = 100 * max(flops / work.FP32_FLOP_PER_S, nbytes / work.HBM_BYTES_PER_S) / 0.6e-3
    assert manifest.reader("k2.roofline_pct")(run) == pytest.approx(want)
    ops = dict((n, s) for n, s in tr.device_ops())
    assert ops[K2] == pytest.approx(1200e-6)
    gaps = dict((n, s) for n, s in tr.idle_gaps())
    assert gaps["before glue_a"] == pytest.approx(315e-6)
    assert gaps[f"before {K2}"] == pytest.approx(30e-6)


def test_k2_is_read_per_solve_and_its_launches_against_the_solves():
    """A K2 split into two launches a solve reads its time per solve, not
    per launch, and the run's comparison counts the extra launches."""
    ev = _chrome()
    ev.append({"ph": "X", "cat": "kernel", "name": K2, "ts": 5000.0, "dur": 300.0})
    tr = Trace.from_chrome(ev)
    run = _run(trace=tr, trace_solves=2, k2_launches=3)
    assert manifest.reader("k2.device_ms")(run) == pytest.approx(0.75)
    assert runner.k2_launches_off(tr, 3, 2) == 2.0
    assert runner.k2_launches_off(tr, None, 3) == 3.0
    assert runner.k2_launches_off(Trace.from_chrome(_chrome()), 2, 2) == 0.0


def test_trace_readers_find_nothing_without_a_trace():
    run = _run()
    for name in ("mppi.launches", "k2.device_ms", "k2.roofline_pct", "device.idle_pct"):
        assert manifest.reader(name)(run) is None
    empty = _run(trace=Trace([]), trace_solves=2)
    for name in ("mppi.launches", "k2.device_ms", "k2.roofline_pct", "device.idle_pct"):
        assert manifest.reader(name)(empty) is None
