"""The port's parallel-in-time LQR backward and the two iLQR options it
brings (`parallel_backward`, and `fd_linearize=False`, the jacfwd oracle).

- `backward_associative` against `backward_sequential` in float64 on the
  seeded affine problems of tests/test_parallel_lqr.py, with and without the
  cross term: 1e-8; against the JAX package's `backward_sequential` with
  x64 on: 1e-8; the gains' optimality as that file checks it.
- iLQR on the two-joint chain of tests/test_mpc.py:85: `parallel_backward`
  against the serial sweep at atol 1e-4 / rtol 1e-3 (test_mpc.py:286); FD
  against jacfwd at 5e-3 of the largest slope (test_mpc.py:170-171).
No JAX program here holds a substep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_kmanip_tpu.solvers import parallel_lqr as jplqr

from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models.spec import build_model
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.solvers import ilqr
from gym_kmanip_torch.solvers.parallel_lqr import (
    LQRProblem, backward_associative, backward_sequential)

torch.set_num_threads(1)


def random_problem(rng, H=12, n=6, m=3, cross=True):
    """tests/test_parallel_lqr.py's problem, as float64 numpy arrays."""
    def spd(k, d, scale=1.0):
        X = rng.randn(k, d, d) * scale
        return X @ X.transpose(0, 2, 1) + 0.5 * np.eye(d)

    A = rng.randn(H, n, n) * 0.3 + np.eye(n)
    B = rng.randn(H, n, m) * 0.5
    d = rng.randn(H, n) * 0.1
    Q = spd(H, n, 0.3)
    q = rng.randn(H, n) * 0.1
    R = spd(H, m, 0.3) + np.tile(np.eye(m), (H, 1, 1))
    r = rng.randn(H, m) * 0.1
    L = rng.randn(H, m, n) * (0.1 if cross else 0.0)
    Qf = spd(1, n, 0.5)[0]
    qf = rng.randn(n) * 0.1
    return A, B, d, Q, q, R, r, L, Qf, qf


def _torch(arrays):
    return LQRProblem(*(torch.as_tensor(a, dtype=torch.float64) for a in arrays))


@pytest.mark.parametrize("cross", [False, True])
def test_associative_matches_sequential(cross):
    arrays = random_problem(np.random.RandomState(0 if cross else 1), cross=cross)
    p = _torch(arrays)
    K1, k1 = backward_sequential(p)
    K2, k2 = backward_associative(p)
    assert K1.shape == (12, 3, 6) and k1.shape == (12, 3)
    np.testing.assert_allclose(K2.numpy(), K1.numpy(), atol=1e-8, rtol=0)
    np.testing.assert_allclose(k2.numpy(), k1.numpy(), atol=1e-8, rtol=0)
    # every horizon length: the doubling scan's ragged last rounds
    for H in (1, 2, 3, 5, 16):
        p = _torch(random_problem(np.random.RandomState(H), H=H, cross=cross))
        for a, b in zip(backward_associative(p), backward_sequential(p)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-8, rtol=0)


@pytest.mark.parametrize("cross", [False, True])
def test_backward_matches_jax_sequential(cross):
    arrays = random_problem(np.random.RandomState(0 if cross else 1), cross=cross)
    jax.config.update("jax_enable_x64", True)
    try:
        jK, jk = jplqr.backward_sequential(
            jplqr.LQRProblem(*(jnp.asarray(a, dtype=jnp.float64) for a in arrays)))
        jK, jk = np.asarray(jK), np.asarray(jk)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert jK.dtype == np.float64
    p = _torch(arrays)
    for fn in (backward_sequential, backward_associative):
        K, k = fn(p)
        np.testing.assert_allclose(K.numpy(), jK, atol=1e-8, rtol=0, err_msg=fn.__name__)
        np.testing.assert_allclose(k.numpy(), jk, atol=1e-8, rtol=0, err_msg=fn.__name__)


@pytest.mark.parametrize("backward", [backward_sequential, backward_associative])
def test_gains_are_optimal(backward):
    """Perturbing the gain-rolled controls must not lower the true LQR cost."""
    rng = np.random.RandomState(2)
    p = _torch(random_problem(rng, H=8, n=4, m=2))
    K, kff = backward(p)
    x0 = torch.as_tensor(rng.randn(4))

    def rollout_cost(us):
        x, c = x0, 0.0
        for t in range(8):
            u = us[t]
            c = c + (0.5 * x @ p.Q[t] @ x + p.q[t] @ x + 0.5 * u @ p.R[t] @ u + p.r[t] @ u
                     + u @ p.L[t] @ x)
            x = p.A[t] @ x + p.B[t] @ u + p.d[t]
        return float(c + 0.5 * x @ p.Qf @ x + p.qf @ x)

    us, x = [], x0
    for t in range(8):
        us.append(K[t] @ x + kff[t])
        x = p.A[t] @ x + p.B[t] @ us[-1] + p.d[t]
    us = torch.stack(us)
    c_opt = rollout_cost(us)
    for _ in range(5):
        assert rollout_cost(us + torch.as_tensor(rng.randn(8, 2) * 0.05)) >= c_opt - 1e-9


def _tiny_model():
    """tests/test_mpc.py's two-joint chain through the port's build_model."""
    joints = [
        dict(name="j0_x6_a", parent=-1, frames=[((0, 0, 0.5), (1.0, 0, 0, 0))],
             range=(-2.0, 2.0)),
        dict(name="j1_x4_a", parent=0,
             frames=[((0, 0, -0.2), (0.707107, 0.707107, 0, 0))], range=(-2.0, 2.0)),
    ]
    return build_model(
        name="tiny", joints=joints, sites=[dict(name="eer_site", parent=1, pos=(0, 0, -0.2))],
        cameras=[], fingertips=[],
        actuators=[dict(kp=100.0, ctrlrange=(-2.0, 2.0)), dict(kp=100.0, ctrlrange=(-2.0, 2.0))],
        home_qpos=np.zeros(2), mocap_pos0=np.zeros((1, 3)),
        mocap_quat0=np.array([[1.0, 0, 0, 0]]),
    )


@pytest.fixture(scope="module")
def tiny():
    m = _tiny_model()
    return m, init_state(m, device="cpu")


def test_ilqr_parallel_backward_matches_serial(tiny):
    m, s0 = tiny

    def cost_xu(x, u):
        s = ilqr.unflatten_state(m, x, s0)
        return (10.0 * torch.sum(s.qpos ** 2, -1) + 0.01 * torch.sum(s.qvel ** 2, -1)
                + 1e-2 * torch.sum(u ** 2, -1))

    u_init = torch.full((6, m.nu), 0.3)
    r_ser = ilqr.make_ilqr_solver(m, ilqr.ILQRConfig(horizon=6, n_iters=2,
                                                     pallas_backward=False), cost_xu)(s0, u_init)
    r_par = ilqr.make_ilqr_solver(m, ilqr.ILQRConfig(horizon=6, n_iters=2,
                                                     parallel_backward=True), cost_xu)(s0, u_init)
    np.testing.assert_allclose(r_par.us.numpy(), r_ser.us.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(r_par.cost_trace.numpy(), r_ser.cost_trace.numpy(), atol=1e-4,
                               rtol=1e-3)
    assert float(r_par.cost) < float(ilqr._build_pieces(
        m, ilqr.ILQRConfig(horizon=6), cost_xu)[0](ilqr.flatten_state(s0), u_init, s0)[1])

    # with lam_extra > 0 the lift scales with |cuu| + 1 per step
    rollout0, derivs, backward = ilqr._build_pieces(
        m, ilqr.ILQRConfig(horizon=6, parallel_backward=True), cost_xu)[:3]
    xs, _ = rollout0(ilqr.flatten_state(s0), u_init, s0)
    dv = derivs(xs, u_init, s0)
    lam = torch.tensor(0.5)
    ks, Ks = backward(*dv, lam)
    A, B, cx, cu, cxx, cuu, cux, Vx, Vxx = dv
    eye = torch.eye(m.nu)
    lift = cuu + (1e-6 + lam * (cuu.abs().amax(dim=(1, 2)) + 1.0))[:, None, None] * eye
    Kw, kw = backward_sequential(LQRProblem(A, B, torch.zeros(6, A.shape[1]), cxx, cx, lift, cu,
                                            cux, Vxx, Vx))
    np.testing.assert_allclose(ks.numpy(), kw.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(Ks.numpy(), Kw.numpy(), atol=1e-4, rtol=1e-3)


def test_ilqr_fd_linearization_matches_jacfwd(tiny):
    """The FD slopes against the exact jacfwd oracle on smooth dynamics
    (contact off), the relative band of tests/test_mpc.py:170-171; and the
    FD solve against the oracle's, as tests/test_mpc.py:231 holds them."""
    m, s0 = tiny

    def cost_xu(x, u):
        s = ilqr.unflatten_state(m, x, s0)
        return 10.0 * torch.sum(s.qpos ** 2, -1) + 1e-2 * torch.sum(u ** 2, -1)

    H = 6
    cfg_fd = ilqr.ILQRConfig(horizon=H, n_iters=1, contact=False)
    cfg_jac = ilqr.ILQRConfig(horizon=H, n_iters=1, contact=False, fd_linearize=False,
                              pallas_backward=False, fast_rollouts=False)
    pf = ilqr._build_pieces(m, cfg_fd, cost_xu)
    pj = ilqr._build_pieces(m, cfg_jac, cost_xu)
    us = torch.full((H, m.nu), 0.1)
    xs, _ = pj[0](ilqr.flatten_state(s0), us, s0)
    A_fd, B_fd = pf[1](xs, us, s0)[:2]
    A_j, B_j = pj[1](xs, us, s0)[:2]
    assert A_j.shape == A_fd.shape == (H, 17, 17) and B_j.shape == B_fd.shape == (H, 17, 2)
    assert A_j.dtype == torch.float32
    assert float((A_fd - A_j).abs().max()) < 5e-3 * float(A_j.abs().max())
    assert float((B_fd - B_j).abs().max()) < 5e-3 * float(B_j.abs().max())

    def ee_cost(x, u):
        s = ilqr.unflatten_state(m, x, s0)
        xp, xq, _ = kin.fk(m, s.qpos)
        ee, _ = kin.site_pose(m, xp, xq, "eer_site")
        return (100.0 * torch.sum((ee - torch.tensor([0.15, 0.0, 0.35])) ** 2, -1)
                + 0.01 * torch.sum(s.qvel ** 2, -1) + 1e-3 * torch.sum(u ** 2, -1))

    # tests/test_mpc.py:231: the production FD solve reaches a final cost
    # comparable to the oracle's. (From the rest state the oracle's first
    # slopes sit on a kink: the friction force clamp(., -0, 0) of a joint
    # with no frictionloss is exactly 0 there, and torch's clamp passes
    # the tangent at its bound, so the oracle does not descend from it.)
    u0 = torch.zeros((8, m.nu))
    r_fast = ilqr.make_ilqr_solver(m, cfg_fd._replace(horizon=8, n_iters=4), ee_cost)(s0, u0)
    r_oracle = ilqr.make_ilqr_solver(m, cfg_jac._replace(horizon=8, n_iters=4), ee_cost)(s0, u0)
    for r in (r_fast, r_oracle):
        trace = r.cost_trace.numpy()
        assert np.all(np.diff(trace) <= 1e-5) and bool(torch.isfinite(r.us).all())
    assert float(r_fast.cost) <= 1.1 * float(r_oracle.cost) + 1e-3
