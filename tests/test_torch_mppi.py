"""The port's rollout, pick cost and MPPI solve against the JAX package.

Inputs are made with numpy from a seed; the MPPI noise is JAX's own draw
(its key split and `sample_noise`), injected into the port's solve. The
JAX package's rollouts and solves on these inputs are read from
tests/golden/mppi_refs.npz (`python tools/make_golden_mppi.py`: one jitted
program of ~56 s of XLA compile on an 8-core x86 host), which also holds
the inputs it was made from; the fixture checks them against its own.
Tolerances are those of tests/test_pallas.py: rollout totals 1e-5 at H=1,
1e-3 at H=3 and 1e-4 at H=3 with two 2 ms substeps; u0 1e-5, J 1e-4,
nominal 1e-5. The fused pick-cost rollout (K2) runs its plain version here,
on CPU tensors; tests/test_torch_cuda.py holds the kernel to it.
"""

import os

import jax
import numpy as np
import pytest
import torch

from gym_kmanip_tpu.dynamics.state import init_state as jinit_state
from gym_kmanip_tpu.models import get_model as jax_get_model
from gym_kmanip_tpu.mpc import mppi as jmppi
from gym_kmanip_tpu.mpc.cost import CostParams as JCostParams
from gym_kmanip_tpu.mpc.cost import cube_pick_cost as jcube_pick_cost
from gym_kmanip_tpu.ops.pallas_substep import PickCostSpec as JPickCostSpec

from gym_kmanip_torch.dynamics.state import state_from_numpy
from gym_kmanip_torch.models import from_numpy_model
from gym_kmanip_torch.mpc import mppi
from gym_kmanip_torch.mpc.cost import CostParams, cube_pick_cost
from gym_kmanip_torch.mpc.rollout import rollout, rollout_with_traj
from gym_kmanip_torch.ops import rollout_pick_cuda

torch.set_num_threads(1)

K, H = 8, 3
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mppi_refs.npz")
STATE_FIELDS = ("qpos", "qvel", "ctrl", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel",
                "time")


@pytest.fixture(scope="module")
def solo():
    jm = jax_get_model("solo_arm")
    m = from_numpy_model(jm)
    jparams, params = JCostParams(), CostParams()
    jcost = lambda s, aux, u: jcube_pick_cost(jm, s, aux, u, jparams)  # noqa: E731
    cost = lambda s, aux, u: cube_pick_cost(m, s, aux, u, params)  # noqa: E731
    return jm, m, jcost, cost


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               atol=atol, rtol=0, err_msg=msg)


@pytest.fixture(scope="module")
def jax_refs(solo):
    """The JAX package's results that the rollout and MPPI tests compare
    against (tests/golden/mppi_refs.npz): `rollout_with_traj` on seeded
    sequences at the MPC rate (dt=0.02, one substep) and at env fidelity
    (dt=0.002, two substeps), and the MPPI solve of `make_mppi_solver` at
    H=3 with one iteration and with two, with the noise each drew."""
    jm, m, jcost, _ = solo
    rng = np.random.RandomState(3)
    U = (jm.home_qpos[: jm.nu] + 0.1 * rng.randn(K, H, jm.nu)).astype(np.float32)
    with np.load(GOLDEN) as g:
        ref = {key: g[key] for key in g.files}
    # the golden was made from these inputs
    np.testing.assert_array_equal(ref["U"], U)
    js0 = jinit_state(jm)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(ref[f"s0/{f}"], np.asarray(getattr(js0, f)), err_msg=f)
    return dict(U=U, js0=js0,
                mppi=tuple(ref[f"mppi1/{n}"] for n in ("nominal", "u0", "J", "eps")),
                mppi2=tuple(ref[f"mppi2/{n}"] for n in ("nominal", "u0", "J", "eps")),
                steps={dt: ref[f"steps/{dt}"] for dt in (0.02, 0.002)},
                totals={dt: (ref[f"steps/{dt}"][:, 0], ref[f"total/{dt}"])
                        for dt in (0.02, 0.002)})


def _rollout_totals(solo, jax_refs, dt, n_substeps):
    """The JAX H=3 totals and per-step costs (whose first column is the H=1
    total) of seeded sequences, and the port's `rollout` and fused-rollout
    wrapper (on CPU tensors, that same rollout) on them."""
    jm, m, jcost, cost = solo
    U = jax_refs["U"]
    want1, want3 = jax_refs["totals"][dt]
    s0 = state_from_numpy(jax_refs["js0"], device="cpu")
    kw = dict(n_substeps=n_substeps, dt=dt)
    got1, _ = rollout(m, s0, torch.as_tensor(U[:, :1]), cost, **kw)
    got3, final = rollout(m, s0, torch.as_tensor(U), cost, **kw)
    assert final.qpos.shape == (K, m.nq)
    before = rollout_pick_cuda.rollout_pick_costs.launches
    fused1 = rollout_pick_cuda.rollout_pick_costs(m, torch.as_tensor(U[:, :1]), s0, **kw)
    fused3 = rollout_pick_cuda.rollout_pick_costs(m, torch.as_tensor(U), s0, **kw)
    assert rollout_pick_cuda.rollout_pick_costs.launches == before
    return want1, want3, (got1, fused1), (got3, fused3)


def test_rollout_totals_match_jax(solo, jax_refs):
    want1, want3, got1, got3 = _rollout_totals(solo, jax_refs, 0.02, 1)
    for g in got1:
        _close(g, want1, 1e-5, "H=1")
    for g in got3:
        _close(g, want3, 1e-3, "H=3")


def test_rollout_totals_at_env_fidelity_match_jax(solo, jax_refs):
    """n_substeps=2 at dt=0.002 (tests/test_pallas.py:252-267)."""
    want1, want3, got1, got3 = _rollout_totals(solo, jax_refs, 0.002, 2)
    for g in got1:
        _close(g, want1, 1e-5, "H=1")
    for g in got3:
        _close(g, want3, 1e-4, "H=3")


@pytest.mark.parametrize("dt,n_substeps,atol", [(0.02, 1, 1e-3), (0.002, 2, 1e-4)])
def test_rollout_with_traj_matches_jax(solo, jax_refs, dt, n_substeps, atol):
    """The per-step cost trace (K, H) against JAX's `rollout_with_traj`'s,
    at the H=3 total's band of each fidelity, and its sum against
    `rollout`'s total."""
    jm, m, jcost, cost = solo
    U = torch.as_tensor(jax_refs["U"])
    s0 = state_from_numpy(jax_refs["js0"], device="cpu")
    total, final, costs = rollout_with_traj(m, s0, U, cost, n_substeps=n_substeps, dt=dt)
    assert costs.shape == (K, H) and final.qpos.shape == (K, m.nq)
    _close(costs, jax_refs["steps"][dt], atol, "per-step costs")
    _close(total, costs.sum(-1), 0.0, "total")
    want, final_r = rollout(m, s0, U, cost, n_substeps=n_substeps, dt=dt)
    _close(total, want, 1e-5, "rollout's total")
    _close(final.qpos, final_r.qpos, 0.0, "final qpos")


def test_pick_cost_spec_defaults_match_cost_params():
    spec, params = rollout_pick_cuda.PickCostSpec(), CostParams()
    for f in ("w_vel", "w_grip_dist", "w_touch", "w_lift", "w_ctrl"):
        assert getattr(spec, f) == getattr(params, f) == getattr(JPickCostSpec(), f), f
    assert (spec.use_right, spec.use_left) == (True, False)


def test_fused_pick_solver_matches_plain_mppi(solo):
    """make_fused_pick_solver against make_mppi_solver on one injected
    noise draw (tests/test_pallas.py:310-314 tolerances)."""
    jm, m, _, cost = solo
    cfg = mppi.MPPIConfig(horizon=H, n_samples=K)
    eps = torch.as_tensor((0.05 * np.random.RandomState(7).randn(K, H, m.nu)).astype(np.float32))
    s0 = state_from_numpy(jinit_state(jm), device="cpu")
    ms = mppi.init_mppi(m, cfg, seed=0, device="cpu")
    ms_p, u0_p, J_p = mppi.make_mppi_solver(m, cfg, cost)(ms, s0, eps=eps)
    ms_f, u0_f, J_f = mppi.make_fused_pick_solver(m, cfg)(ms, s0, eps=eps)
    _close(u0_f, u0_p, 1e-5, "u0")
    _close(J_f, J_p, 1e-4, "J")
    _close(ms_f.nominal, ms_p.nominal, 1e-5, "nominal")


def test_mppi_solve_matches_jax_with_injected_noise(solo, jax_refs):
    jm, m, jcost, cost = solo
    cfg = mppi.MPPIConfig(horizon=H, n_samples=K)
    js0 = jax_refs["js0"]
    nominal_j, u0_j, J_j, eps = jax_refs["mppi"]
    # the draw JAX's solve made: its key split, then sample_noise
    ms = mppi.init_mppi(m, cfg, seed=0, device="cpu")
    solve = mppi.make_mppi_solver(m, cfg, cost)
    ms2, u0, J = solve(ms, state_from_numpy(js0, device="cpu"), eps=torch.as_tensor(eps[0]))
    _close(u0, u0_j, 1e-5, "u0")
    _close(J, J_j, 1e-4, "J")
    _close(ms2.nominal, nominal_j, 1e-5, "nominal")
    assert ms2.generator is ms.generator

    with pytest.raises(ValueError):
        solve(ms, state_from_numpy(js0, device="cpu"), eps=torch.zeros(K, H + 1, m.nu))


def test_mppi_two_iterations_match_jax_with_injected_noise(solo, jax_refs):
    """Two iterations on JAX's two draws (its key split each iteration):
    the proposal carried into slot 1 of the second iteration. Measured
    distances: u0 1.49e-8, nominal 1.19e-7, J equal; held at the
    one-iteration test's tolerances."""
    jm, m, _, cost = solo
    js0 = jax_refs["js0"]
    nominal_j, u0_j, J_j, draws = jax_refs["mppi2"]
    cfg = mppi.MPPIConfig(horizon=H, n_samples=K, n_iters=2)
    solve = mppi.make_mppi_solver(m, cfg, cost)
    ms = mppi.init_mppi(m, cfg, seed=0, device="cpu")
    s0 = state_from_numpy(js0, device="cpu")
    ms2, u0, J = solve(ms, s0, eps=torch.as_tensor(draws))
    _close(u0, u0_j, 1e-5, "u0")
    _close(J, J_j, 1e-4, "J")
    _close(ms2.nominal, nominal_j, 1e-5, "nominal")
    with pytest.raises(ValueError):
        solve(ms, s0, eps=torch.as_tensor(draws[0]))  # one draw for two iterations


def test_noise_filter_and_sigma_match_jax(solo):
    jm, m, _, _ = solo
    sig_j = jmppi.sigma_per_actuator(jm, 0.05)
    sig = mppi.sigma_per_actuator(m, 0.05)
    assert sig.dtype == np.float32 and isinstance(sig, np.ndarray)
    np.testing.assert_array_equal(sig, sig_j)
    np.testing.assert_array_equal(mppi._ar1_filter(7, 0.85), jmppi._ar1_filter(7, 0.85))

    # the same normal draws through both AR(1) filters (full FP32)
    key = jax.random.PRNGKey(4)
    want = jmppi.sample_noise(key, 16, 7, jm.nu, sig_j, 0.85)
    xi = jax.random.normal(key, (16, 7, jm.nu)) * sig_j
    got = mppi.correlate(torch.as_tensor(np.array(xi)), 0.85)
    _close(got, want, 1e-6)

    # the port's own draws: seeded, advancing the generator, std ~ sigma
    g = torch.Generator().manual_seed(0)
    a = mppi.sample_noise(g, 512, 7, m.nu, torch.as_tensor(sig), 0.85)
    b = mppi.sample_noise(g, 512, 7, m.nu, torch.as_tensor(sig), 0.85)
    again = mppi.sample_noise(torch.Generator().manual_seed(0), 512, 7, m.nu,
                              torch.as_tensor(sig), 0.85)
    assert a.shape == (512, 7, m.nu) and not torch.equal(a, b) and torch.equal(a, again)
    _close(a.std(dim=(0, 1)) / torch.as_tensor(sig), np.ones(m.nu), 0.1)


def test_reductions_follow_jax_semantics():
    """torch.argmin picks the first minimum and std(correction=0) is the
    population std, as jnp.argmin and jnp.std."""
    costs = np.array([3.0, 1.0, 2.0, 1.0], dtype=np.float32)
    t = torch.as_tensor(costs)
    assert int(torch.argmin(t)) == int(jax.numpy.argmin(costs)) == 1
    assert float(torch.std(t, correction=0)) == pytest.approx(float(np.std(costs)))
