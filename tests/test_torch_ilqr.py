"""The port's iLQR solve, its FD linearization and its Gauss-Newton
EE-tracking cost against the JAX package, solo arm, on the CPU.

The production configuration of bench.py:315-319 cut to H=3 and 2
iterations: contact=False, reduced_state (n=20, m=10), the Gauss-Newton
cost `make_ee_tracking_cost_ilqr`, one-sided FD, goal at the home EE +
[0, 0.05, -0.05] (bench.py:309). On the CPU the JAX package takes its
serial `jnp.linalg.solve` sweep and the scan forward. Tolerances:
- the port with `pallas_backward=False` (the same serial sweep; its
  forward route, the feedback rollout's plain version, is the same
  arithmetic as the scan): us and cost trace at atol 1e-4 / rtol 1e-3
  (tests/test_mpc.py:286);
- the port's card path (the Riccati sweep's and the feedback rollout's
  plain versions: Gershgorin lift, pivot drop) cannot match the serial
  sweep bit for bit: a monotone trace (np.diff <= 1e-5, test_mpc.py:136)
  and a final cost <= 1.1 x JAX's + 1e-3 (test_mpc.py:266);
- the GN cost and its quadratization: 1e-5 relative to each quantity's
  largest entry (J from jacrev there, analytic here).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_kmanip_tpu.dynamics.state import init_state as jinit_state
from gym_kmanip_tpu.models import get_model as jax_get_model
from gym_kmanip_tpu.mpc import cost as jcost
from gym_kmanip_tpu.ops import kinematics as jkin
from gym_kmanip_tpu.solvers import ilqr as jilqr

from gym_kmanip_torch.dynamics.state import state_from_numpy
from gym_kmanip_torch.models import from_numpy_model
from gym_kmanip_torch.mpc.cost import ee_tracking_cost, make_ee_tracking_cost_ilqr
from gym_kmanip_torch.ops import riccati_cuda, rollout_feedback_cuda, substep_cuda
from gym_kmanip_torch.solvers import ilqr

torch.set_num_threads(1)

H, N_ITERS = 3, 2


@pytest.fixture(scope="module")
def solo():
    jm = jax_get_model("solo_arm")
    m = from_numpy_model(jm)
    js0 = jinit_state(jm)
    xp, xq, _ = jkin.fk(jm, js0.qpos)
    p, _ = jkin.site_pose(jm, xp, xq, "eer_site")
    goal = (np.asarray(p) + np.array([0.0, 0.05, -0.05])).astype(np.float32)
    jfns = jcost.make_ee_tracking_cost_ilqr(jm, jnp.asarray(goal), w_pos=50.0, w_vel=0.01,
                                            w_ctrl=0.001)
    fns = make_ee_tracking_cost_ilqr(m, goal, w_pos=50.0, w_vel=0.01, w_ctrl=0.001)
    u_init = np.tile(jm.home_qpos[: jm.nu], (H, 1)).astype(np.float32)
    return dict(jm=jm, m=m, js0=js0, s0=state_from_numpy(js0, device="cpu"), goal=goal,
                jfns=jfns, fns=fns, u_init=u_init)


def _cfg(module, **kw):
    return module.ILQRConfig(horizon=H, n_iters=N_ITERS, contact=False, reduced_state=True,
                             **kw)


@pytest.fixture(scope="module")
def jax_ref(solo):
    """The JAX package's production solve on the CPU, as `make_ilqr_solver`
    runs it with fused_solve=False (`_build_pieces`, then `_run_pieces`),
    except that each iteration calls the body of its jitted `iteration`,
    whose pieces (derivs, backward, linesearch) are jitted one by one: the
    same iterates, and the FD test reuses the compiled `derivs`."""
    jcost_xu, jquad_xu = solo["jfns"]
    js0 = solo["js0"]
    rollout0, derivs, _, _, iteration, _ = jilqr._build_pieces(
        solo["jm"], _cfg(jilqr, fused_solve=False), js0, jcost_xu, jilqr._zero_final,
        jnp.float32, quad_xu=jquad_xu)
    x0 = jilqr.flatten_state(js0, reduced=True)
    us = jilqr._clip_u(solo["jm"], jnp.asarray(solo["u_init"]))
    xs, cost = rollout0(x0, us)
    lam = jnp.asarray(0.0, jnp.float32)
    trace = []
    for _ in range(N_ITERS):
        xs, us, cost, lam = iteration.__wrapped__(x0, xs, us, cost, lam)
        trace.append(cost)
    return dict(us=np.asarray(us), xs=np.asarray(xs), cost=np.asarray(cost),
                cost_trace=np.asarray(trace), derivs=derivs)


def _port_solve(solo, **kw):
    cost_xu, quad_xu = solo["fns"]
    solve = ilqr.make_ilqr_solver(solo["m"], _cfg(ilqr, **kw), cost_xu, quad_xu=quad_xu)
    return solve(solo["s0"], torch.as_tensor(solo["u_init"]))


def test_ee_tracking_costs_match_jax(solo, jax_ref):
    """JAX's quadratization comes from the solve's compiled `derivs` piece,
    which applies `quad_xu` to xs[:-1] and us (its slopes are not used
    here): the seeded points are K = H states plus one unscored last row."""
    jm, m = solo["jm"], solo["m"]
    rng = np.random.RandomState(0)
    K, n = H, 2 * m.nq
    x = np.concatenate([jm.home_qpos + 0.1 * rng.randn(K + 1, m.nq),
                        0.3 * rng.randn(K + 1, m.nq)], axis=1).astype(np.float32)
    u = (jm.home_qpos[: m.nu] + 0.1 * rng.randn(K, m.nu)).astype(np.float32)
    jcost_xu, _ = solo["jfns"]
    cost_xu, quad_xu = solo["fns"]
    want = [jax.jit(jax.vmap(jcost_xu))(x[:K], u)] + list(jax_ref["derivs"](x, u)[2:7])
    x = x[:K]
    got = [cost_xu(torch.as_tensor(x), torch.as_tensor(u))] + list(
        quad_xu(torch.as_tensor(x), torch.as_tensor(u)))
    for name, g, w in zip(("cost", "cx", "cu", "cxx", "cuu", "cux"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    assert tuple(got[3].shape) == (K, n, n)

    # the plain EE goal-reaching cost on a state and a step's diagnostics
    site_pos = (0.5 + 0.1 * rng.randn(K, len(m.sites), 3)).astype(np.float32)
    qpos, qvel = x[:, : m.nq], x[:, m.nq:]
    want = jax.vmap(lambda sp, q, v, c: jcost.ee_tracking_cost(
        jm, SimpleNamespace(qpos=q, qvel=v), SimpleNamespace(site_pos=sp), c, solo["goal"],
    ))(site_pos, qpos, qvel, u)
    t = torch.as_tensor
    got = ee_tracking_cost(m, SimpleNamespace(qpos=t(qpos), qvel=t(qvel)),
                           SimpleNamespace(site_pos=t(site_pos)), t(u), t(solo["goal"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)


def test_ilqr_solve_matches_jax(solo, jax_ref):
    """pallas_backward=False: the serial linalg.solve sweep, as the JAX
    package runs it on the CPU.

    The arm's hinge actuators hold atol 1e-4 / rtol 1e-3. The gripper
    sliders' direction of Quu is cuu = 2 w_ctrl = 2e-3 against ~1e2 for the
    arm (condition ~1e5), so float32 rounding anywhere in the iteration
    moves their controls: the JAX package against itself, with the same
    FD slopes and the backward sweep in float64, moves them by 3.4e-4 m,
    and the port against itself, with the substep's Cholesky in the JAX
    package's Crout order instead of the library's, by 4.6e-4 m (run
    `measure_slider_spread` below). This port sits 1.02e-3 m from JAX (3%
    of the 0.034 m ctrlrange): held at 2e-3 (ROADMAP.md, known behaviours
    of the reference)."""
    r = _port_solve(solo, pallas_backward=False)
    hinge = np.asarray(solo["jm"].jnt_type[: solo["m"].nu]) == 0
    us, want = r.us.numpy(), jax_ref["us"]
    np.testing.assert_allclose(us[:, hinge], want[:, hinge], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(us[:, ~hinge], want[:, ~hinge], atol=2e-3, rtol=0)
    np.testing.assert_allclose(r.cost_trace.numpy(), jax_ref["cost_trace"], atol=1e-4,
                               rtol=1e-3)
    assert r.cost_trace.shape == (N_ITERS,) and r.xs.shape == (H + 1, 2 * solo["m"].nq)


def test_ilqr_card_path_on_cpu_descends_like_jax(solo, jax_ref):
    """The default route (the Riccati sweep with lift and pivot drop, the
    feedback rollout for the forward passes) through the kernels' plain
    versions, since the tensors are on the CPU: no kernel launches."""
    wrappers = (substep_cuda.substep_batched, rollout_feedback_cuda.rollout_feedback,
                riccati_cuda.riccati_sweep)
    before = [w.launches for w in wrappers]
    r = _port_solve(solo)
    assert [w.launches for w in wrappers] == before
    trace = r.cost_trace.numpy()
    assert np.all(np.diff(trace) <= 1e-5)
    assert np.all(np.isfinite(r.us.numpy()))
    assert float(r.cost) <= 1.1 * float(jax_ref["cost"]) + 1e-3
    # the kernels' plain versions as ops give the same solve on the CPU
    cost_xu, quad_xu = solo["fns"]
    plain = ilqr.make_ilqr_solver(solo["m"], _cfg(ilqr), cost_xu, quad_xu=quad_xu,
                                  ops=ilqr.PLAIN_OPS)(solo["s0"], torch.as_tensor(solo["u_init"]))
    assert torch.equal(plain.us, r.us) and torch.equal(plain.cost_trace, r.cost_trace)


def test_ilqr_refuses_unported_options(solo):
    cost_xu, quad_xu = solo["fns"]
    for kw in (dict(parallel_backward=True), dict(fd_linearize=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ilqr.make_ilqr_solver(solo["m"], _cfg(ilqr, **kw), cost_xu)
    with pytest.raises(ValueError):
        ilqr.make_ilqr_solver(solo["m"], ilqr.ILQRConfig(reduced_state=True), cost_xu)
    # flatten / unflatten round trip on a batch, the cube from the template
    s0 = solo["s0"]
    x = ilqr.flatten_state(s0, reduced=True).expand(4, -1)
    s = ilqr.unflatten_state(solo["m"], x, s0)
    assert s.qpos.shape == (4, solo["m"].nq) and s.cube_pos.shape == (4, 3)
    assert torch.equal(ilqr.flatten_state(s), torch.cat(
        [x, ilqr.flatten_state(s0)[2 * solo["m"].nq:].expand(4, -1)], dim=-1))


@pytest.mark.parametrize("fd_order", [1, 2])
def test_fd_derivs_match_jax(solo, jax_ref, fd_order):
    """The FD linearization and the GN quadratization at the same seeded
    (xs, us), the production config with fd_order 1 and 2. A and B are held
    at 1e-4 of the largest slope: each slope divides a float32 state
    difference by eps = 1e-3, which turns the ~1e-7 relative rounding of two
    implementations' substeps into ~1e-4 relative slope error (the 20 ms
    step's slopes reach ~46). The cost blocks: 1e-5 relative."""
    jm, m, js0, s0 = solo["jm"], solo["m"], solo["js0"], solo["s0"]
    jcost_xu, jquad_xu = solo["jfns"]
    cost_xu, quad_xu = solo["fns"]
    rng = np.random.RandomState(1)
    us = torch.as_tensor(np.clip(jm.home_qpos[: m.nu] + 0.05 * rng.randn(H, m.nu),
                                 jm.ctrl_range[:, 0], jm.ctrl_range[:, 1]).astype(np.float32))
    rollout0, derivs = ilqr._build_pieces(m, _cfg(ilqr, fd_order=fd_order), cost_xu,
                                          quad_xu=quad_xu)[:2]
    xs, _ = rollout0(ilqr.flatten_state(s0, reduced=True), us, s0)
    got = derivs(xs, us, s0)
    if fd_order == 1:
        jderivs = jax_ref["derivs"]
    else:
        jderivs = jilqr._build_pieces(jm, _cfg(jilqr, fd_order=2), js0, jcost_xu,
                                      jilqr._zero_final, jnp.float32, quad_xu=jquad_xu)[1]
    want = jderivs(xs.numpy(), us.numpy())
    names = ("A", "B", "cx", "cu", "cxx", "cuu", "cux", "Vx_T", "Vxx_T")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        rel = 1e-4 if name in ("A", "B") else 1e-5
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30), err_msg=name)


def measure_slider_spread():
    """How far the same two-iteration solve (the fixtures' problem) moves
    the gripper sliders' controls when it is computed another valid way;
    prints the largest differences of the hinge and slider controls.

        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ilqr.py

    JAX: its pieces (`fused_solve=False`, as `jax_ref`) against its fused
    solve, and against the pieces with the backward sweep in float64 (the
    same FD slopes). The port: its plain substep (the library's Cholesky)
    against the staged substep (the JAX package's Crout order) inside the
    FD linearization. A few minutes on a CPU, most of it XLA compiling."""
    from gym_kmanip_torch.dynamics import engine

    solo_ = solo.__wrapped__()
    jm, m, js0 = solo_["jm"], solo_["m"], solo_["js0"]
    jcost_xu, jquad_xu = solo_["jfns"]
    hinge = np.asarray(jm.jnt_type[: jm.nu]) == 0
    ref = jax_ref.__wrapped__(solo_)
    rollout0, derivs, _, linesearch, _, _ = jilqr._build_pieces(
        jm, _cfg(jilqr, fused_solve=False), js0, jcost_xu, jilqr._zero_final, jnp.float32,
        quad_xu=jquad_xu)

    def sweep64(A, B, cx, cu, cxx, cuu, cux, Vx, Vxx, lam):
        A, B, cx, cu, cxx, cuu, cux, Vx, Vxx = (np.asarray(a, np.float64) for a in
                                                 (A, B, cx, cu, cxx, cuu, cux, Vx, Vxx))
        eye = np.eye(B.shape[2])
        ks, Ks = [None] * H, [None] * H
        for t in range(H - 1, -1, -1):
            Qx, Qu = cx[t] + A[t].T @ Vx, cu[t] + B[t].T @ Vx
            Qxx = cxx[t] + A[t].T @ Vxx @ A[t]
            Quu = cuu[t] + B[t].T @ Vxx @ B[t] + 1e-6 * eye
            Qux = cux[t] + B[t].T @ Vxx @ A[t]
            Quu = 0.5 * (Quu + Quu.T)
            Quu = Quu + lam * np.abs(Quu).max() * eye
            Kk = -np.linalg.solve(Quu, np.concatenate([Qu[:, None], Qux], axis=1))
            ks[t], Ks[t] = Kk[:, 0], Kk[:, 1:]
            Vx = Qx + Ks[t].T @ Quu @ ks[t] + Ks[t].T @ Qu + Qux.T @ ks[t]
            Vxx = Qxx + Ks[t].T @ Quu @ Ks[t] + Ks[t].T @ Qux + Qux.T @ Ks[t]
            Vxx = 0.5 * (Vxx + Vxx.T)
        return np.stack(ks).astype(np.float32), np.stack(Ks).astype(np.float32)

    x0 = jilqr.flatten_state(js0, reduced=True)
    us = jilqr._clip_u(jm, jnp.asarray(solo_["u_init"]))
    xs, cost = rollout0(x0, us)
    lam = 0.0
    for _ in range(N_ITERS):
        ks, Ks = sweep64(*derivs(xs, us), lam)
        xs_c, us_c, cost_c = linesearch(x0, xs, us, jnp.asarray(ks), jnp.asarray(Ks))
        better = bool(cost_c < cost)
        xs, us = (xs_c, us_c) if better else (xs, us)
        lam = lam * 0.25 if better else max(lam * 32.0, 1e-3)
        cost = min(float(cost_c), float(cost))
    us64 = np.asarray(us)
    fused = np.asarray(jilqr.make_ilqr_solver(jm, _cfg(jilqr), jcost_xu, quad_xu=jquad_xu)(
        js0, jnp.asarray(solo_["u_init"])).us)
    port = _port_solve(solo_, pallas_backward=False).us.numpy()
    cost_xu, quad_xu = solo_["fns"]
    staged = ilqr.make_ilqr_solver(
        m, _cfg(ilqr, pallas_backward=False), cost_xu, quad_xu=quad_xu,
        ops=ilqr.KERNEL_OPS._replace(substep=engine.substep_staged))(
        solo_["s0"], torch.as_tensor(solo_["u_init"])).us.numpy()
    for name, a, b in (("JAX pieces vs JAX fused solve", ref["us"], fused),
                       ("JAX pieces vs JAX with the sweep in float64", ref["us"], us64),
                       ("port vs JAX pieces", port, ref["us"]),
                       ("port vs port with the Crout-order substep", port, staged)):
        d = np.abs(a - b)
        print(f"{name}: hinge {d[:, hinge].max():.3e}, slider {d[:, ~hinge].max():.3e}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    measure_slider_spread()
