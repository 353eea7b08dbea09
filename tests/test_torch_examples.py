"""The port's examples 8, 9 and 11 run end to end on the CPU at tiny
sizes (their `main()` keyword arguments): finite results and the shapes
the JAX examples print; example 8 also sharded, on a mesh of one rank.
Examples 0-5 are in tests/test_torch_sidecars.py."""

import importlib

import numpy as np
import torch

torch.set_num_threads(1)


def _example(name):
    return importlib.import_module(f"gym_kmanip_torch.examples.{name}")


def test_example_9_ilqr_reports_both_ee_errors():
    out = _example("9_mpc_ilqr").main(horizon=3, n_iters=2, device="cpu")
    assert out["finite"] and out["ee_err_mm"].shape == (3,)
    assert out["ee_err_mm_scored"] == out["ee_err_mm"][-2]
    assert out["ee_err_mm_final"] == out["ee_err_mm"][-1]
    trace = out["cost_trace"]
    assert trace.shape == (2,) and np.all(np.isfinite(trace)) and np.all(np.diff(trace) <= 1e-5)


def test_example_11_bimanual_and_torso():
    out = _example("11_bimanual_torso").main(device="cpu", dual_horizon=2, n_samples=8,
                                             n_solves=1, torso_horizon=2, n_iters=1)
    assert np.isfinite(out["dual"]["J"]) and out["dual"]["ms_per_solve"] > 0
    assert out["torso"]["cost_trace"].shape == (1,)
    assert np.all(np.isfinite(out["torso"]["cost_trace"]))


def test_example_8_mppi_closed_loop():
    ex = _example("8_mpc_mppi")
    out = ex.main(horizon=2, n_samples=8, n_control_steps=2, device="cpu")
    assert out["finite"] and np.isfinite(out["tip_cube_m"]) and out["hz"] > 0
    # sharded with no launcher: a mesh of one rank, the same closed loop to
    # the order of the proposal's float32 sums
    sharded = ex.main(horizon=2, n_samples=8, n_control_steps=2, sharded=True, device="cpu")
    assert not torch.distributed.is_initialized()
    for key in ("finite", "touch_steps", "lifted"):
        assert sharded[key] == out[key], key
    assert abs(sharded["tip_cube_m"] - out["tip_cube_m"]) <= 1e-5
