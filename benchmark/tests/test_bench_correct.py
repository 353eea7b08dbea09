"""The comparison that decides `correct`, driven through the rest of a run
on the CPU (the look for a card skipped): a sound run is correct; the
control (the reference in TF32 in the program's place) and each fault
planted under the timed path are not."""

import contextlib

import pytest
import torch

from harness import faults, runner
from conftest import tiny_cell
from reference import dynamics as rd
from reference import scene as sc


@pytest.mark.parametrize("name", ["solo_pick.k256", "torso_pick.k256"])
def test_sound_run_is_correct(name):
    run = runner.run_cell(tiny_cell(name), 2**31 + 11, 0.3, False, "cpu")
    assert run.correct, run.rows
    assert run.found["update_misses"] == 0 and run.found["totals"] < 1e-6
    line = runner.result_line(run, False)
    assert list(line)[-1] == "checked"
    assert set(line["checked"]) == {"totals", "update_misses", "nonfinite"}
    assert line["attempted"] == run.solves and line["failed"] == 0


@pytest.mark.parametrize("name", ["solo_pick.k256", "torso_pick.k256"])
def test_control_is_not_correct(name):
    """The reference computed in TF32 in the program's place, at the cells'
    horizon and a K the CPU runs in seconds, over the solves of a 3 s
    window (the chip's readings are at the cells' own sizes: PERF.md)."""
    run = runner.run_cell(tiny_cell(name, horizon=50, n_samples=16), 2**31 + 5, 3.0, False,
                          "cpu", system="control", warmup=1)
    assert not run.correct, run.rows
    assert run.found["totals"] > run.cell.limits["totals"]


@pytest.mark.parametrize("fault", [f for f in faults.NAMES if f != "tips_pass_through"])
def test_planted_fault_is_not_correct(fault):
    with faults.plant(fault):
        run = runner.run_cell(tiny_cell(n_samples=16), 2**31 + 3, 0.5, False, "cpu")
    assert not run.correct, (fault, run.rows)


def _cube_at_a_fingertip(start_pool):
    """The traffic's start states with the cube moved against the first
    fingertip: the tip's sphere overlaps the cube's face, its centre stays
    outside, so every rollout starts in contact."""

    def pool(robot, traffic, seed, device):
        p = start_pool(robot, traffic, seed, device)
        plain = rd.Plain(robot, device)
        xpos, xquat, _, _ = plain.rnea_terms(p["qpos"], p["qvel"])
        par = int(robot.tip_parent[0])
        tip = xpos[:, par] + rd.quat_rotate(xquat[:, par], plain.tip_pos[0])
        shift = sc.CUBE_HALF_SIZE + 0.5 * float(robot.tip_radius[0])
        p["cube_pos"] = tip + torch.tensor([shift, 0.0, 0.0], device=tip.device)
        return p

    return pool


@pytest.mark.parametrize("fault", [None, "tips_pass_through"])
def test_fingertips_passing_through_the_cube_are_not_correct(monkeypatch, fault):
    """Where the rollouts reach the cube, fingertips that no longer touch it
    read as not correct; the same start states are correct without it."""
    monkeypatch.setattr(runner.traffic, "start_pool", _cube_at_a_fingertip(runner.traffic.start_pool))
    with faults.plant(fault) if fault else contextlib.nullcontext():
        run = runner.run_cell(tiny_cell(n_samples=16), 2**31 + 3, 0.5, False, "cpu")
    assert run.correct == (fault is None), (fault, run.rows)


def test_faults_are_removed_after_the_run():
    from gym_kmanip_torch.mpc import mppi
    from gym_kmanip_torch.ops import rollout_pick_cuda

    before = (mppi.mppi_solve, mppi.rollout_pick_costs, rollout_pick_cuda._substep_torch)
    for fault in faults.NAMES:
        with faults.plant(fault):
            pass
    runner.run_cell(tiny_cell(), 1, 0.1, False, "cpu")
    assert (mppi.mppi_solve, mppi.rollout_pick_costs, rollout_pick_cuda._substep_torch) == before
