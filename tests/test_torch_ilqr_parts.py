"""The iLQR solve's kernels' plain versions against the JAX package, on the
CPU: the feedback rollout (K3) and the Riccati sweep (K4). The FD
linearization is held in tests/test_torch_ilqr.py.

Tolerances, with their reasons:
- Feedback rollout: us atol 2e-5 / rtol 1e-4, xs 5e-4 / 1e-3
  (tests/test_pallas.py:377-380).
- Riccati sweep, and each variant of the sweep-floor experiment (K8):
  1e-4 of the largest gain against itself in float64;
  2e-3 of it against the Pallas kernel in interpret mode, whose
  bf16x3-emulated products (~2^-21 relative) the lifted recursion grows to
  8e-4 of the largest gain on the indefinite problem (measured against
  float64). Against the JAX serial sweep, which has no lift and no pivot
  drop: 5e-3 (tests/test_mpc.py:227-228).
"""

import importlib.util
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gym_kmanip_tpu.dynamics.state import init_state as jinit_state
from gym_kmanip_tpu.models import get_model as jax_get_model
from gym_kmanip_tpu.mpc.rollout import mpc_step as jmpc_step
from gym_kmanip_tpu.ops import pallas_riccati
from gym_kmanip_tpu.solvers import ilqr as jilqr

from gym_kmanip_torch.dynamics.state import state_from_numpy
from gym_kmanip_torch.models import from_numpy_model
from gym_kmanip_torch.ops import riccati_cuda, rollout_feedback_cuda, sweep_floor_cuda

torch.set_num_threads(1)

REG = 1e-6


@pytest.fixture(scope="module")
def solo():
    jm = jax_get_model("solo_arm")
    js0 = jinit_state(jm)
    return jm, from_numpy_model(jm), js0, state_from_numpy(js0, device="cpu")


def test_rollout_feedback_plain_matches_jax_forward(solo):
    """The JAX scan forward of test_pallas.py:346-366 (reduced layout, the
    cube from the template), H=3, alpha in {0, 0.3, 1}."""
    jm, m, js0, s0 = solo
    H, n, nu = 3, 2 * m.nq, m.nu
    rng = np.random.RandomState(5)
    x0 = np.array(jilqr.flatten_state(js0, reduced=True))
    us_nom = (jm.home_qpos[:nu] + 0.05 * rng.randn(H, nu)).astype(np.float32)
    xs_nom = (x0[None] + 0.02 * rng.randn(H, n)).astype(np.float32)
    ks = (0.03 * rng.randn(H, nu)).astype(np.float32)
    Ks = (0.05 * rng.randn(H, nu, n)).astype(np.float32)
    alphas = np.array([0.0, 0.3, 1.0], np.float32)
    lo = jnp.asarray(jm.ctrl_range[:, 0], jnp.float32)
    hi = jnp.asarray(jm.ctrl_range[:, 1], jnp.float32)

    def f_fast(x, u):
        s = jilqr.unflatten_state(jm, x, js0)
        s2, _ = jmpc_step(jm, s, u, 1, 0.02, contact=False, unrolled_solve=True)
        return jilqr.flatten_state(s2, reduced=True)

    def forward(alpha):
        def body(x, inp):
            x_nom, u_nom, kff, K = inp
            u = jnp.clip(u_nom + alpha * kff + K @ (x - x_nom), lo, hi)
            x2 = jax.vmap(f_fast)(x[None], u[None])[0]
            return x2, (x2, u)

        _, (xs_t, us_t) = jax.lax.scan(body, jnp.asarray(x0), (xs_nom, us_nom, ks, Ks))
        return xs_t, us_t

    xs_ref, us_ref = jax.jit(jax.vmap(forward))(alphas)
    t = torch.as_tensor
    cube0 = torch.cat([s0.cube_pos, s0.cube_quat, s0.cube_linvel, s0.cube_angvel])
    before = rollout_feedback_cuda.rollout_feedback.launches
    xs, us = rollout_feedback_cuda.rollout_feedback(
        m, t(x0), cube0, t(xs_nom), t(us_nom), t(ks), t(Ks), t(alphas))
    assert rollout_feedback_cuda.rollout_feedback.launches == before
    np.testing.assert_allclose(us.numpy(), np.asarray(us_ref), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_ref), atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def pallas_sweep():
    return jax.jit(lambda *a: pallas_riccati.riccati_sweep_pallas(
        *a[:-1], REG, interpret=True, lam_extra=a[-1]))


@pytest.mark.parametrize("indefinite", [False, True])
@pytest.mark.parametrize("lam_extra", [0.0, 1e-3])
def test_riccati_plain_matches_pallas_interpret(pallas_sweep, indefinite, lam_extra):
    """The plain sweep in float32 stays within 1e-4 of the largest gain of
    itself in float64. The Pallas kernel's bf16x3 products (~2^-21) grow
    through the lifted recursion: on the indefinite problem its gains sit
    8e-4 of the largest gain from float64 (1e-3 for Ks), so the two are held
    at 2e-3 of it."""
    prob = riccati_cuda.random_problem(3, 6, 7, 3, indefinite)
    if indefinite:  # the lift acts: some step's Quu has a negative eigenvalue
        assert np.linalg.eigvalsh(prob[5].astype(np.float64)).min() < -1.0
    lam = torch.tensor(lam_extra)
    ks_j, Ks_j = pallas_sweep(*prob, jnp.float32(lam_extra))
    ks, Ks = riccati_cuda.riccati_sweep(*(torch.as_tensor(a) for a in prob), REG, lam_extra=lam)
    ks64, Ks64 = riccati_cuda.riccati_sweep_reference(
        *(torch.as_tensor(a).double() for a in prob), REG, lam_extra=lam)
    for g, w, w64 in ((ks, ks_j, ks64), (Ks, Ks_j, Ks64)):
        w, w64 = np.asarray(w), w64.numpy()
        scale = np.abs(w64).max()
        np.testing.assert_allclose(g.numpy(), w64, rtol=0, atol=1e-4 * scale)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-3 * scale)


def test_riccati_plain_matches_jax_serial_sweep():
    """On a well-conditioned problem the lift (~1e-5 relative) is the only
    difference from the serial sweep (tests/test_mpc.py:196-228)."""
    prob = riccati_cuda.random_problem(3, 6, 7, 3)
    m = prob[1].shape[2]

    def serial(A, B, cx, cu, cxx, cuu, cux, VxT, VxxT):
        eye_u = jnp.eye(m, dtype=jnp.float32)

        def step(carry, inp):
            Vx, Vxx = carry
            A_t, B_t, cx_t, cu_t, cxx_t, cuu_t, cux_t = inp
            Qx = cx_t + A_t.T @ Vx
            Qu = cu_t + B_t.T @ Vx
            Qxx = cxx_t + A_t.T @ Vxx @ A_t
            Quu = cuu_t + B_t.T @ Vxx @ B_t + REG * eye_u
            Qux = cux_t + B_t.T @ Vxx @ A_t
            Quu = 0.5 * (Quu + Quu.T)
            Kk = -jnp.linalg.solve(Quu, jnp.concatenate([Qu[:, None], Qux], axis=1))
            kff, K = Kk[:, 0], Kk[:, 1:]
            Vx_n = Qx + K.T @ Quu @ kff + K.T @ Qu + Qux.T @ kff
            Vxx_n = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            return (Vx_n, 0.5 * (Vxx_n + Vxx_n.T)), (kff, K)

        (_, _), (ks, Ks) = jax.lax.scan(step, (VxT, VxxT), (A, B, cx, cu, cxx, cuu, cux),
                                        reverse=True)
        return ks, Ks

    ks_s, Ks_s = jax.jit(serial)(*prob)
    ks, Ks = riccati_cuda.riccati_sweep_reference(*(torch.as_tensor(a) for a in prob), REG)
    np.testing.assert_allclose(ks.numpy(), np.asarray(ks_s), atol=5e-3)
    np.testing.assert_allclose(Ks.numpy(), np.asarray(Ks_s), atol=5e-3)


def test_chol_solve_drops_pivots_like_jax():
    """With the lift, an equilibrated pivot stays above ~1.1e-4 / (m + 1)
    in exact arithmetic, so at m = 3 no pivot is dropped inside a sweep;
    the drop is held here on a singular matrix with lam = 0 against the
    JAX package's row formulation and its default (hybrid) one."""
    rng = np.random.RandomState(2)
    m, r = 5, 4
    v = rng.randn(m, 3)
    Q = (v @ v.T).astype(np.float32)  # rank 3: the last two pivots vanish
    RHS = rng.randn(m, r).astype(np.float32)
    got = riccati_cuda.chol_solve_dropping(torch.as_tensor(Q), torch.as_tensor(RHS),
                                           torch.tensor(0.0))
    for impl in (pallas_riccati._chol_solve_rows, pallas_riccati._chol_solve_hybrid):
        want = np.asarray(impl(jnp.asarray(Q), jnp.asarray(RHS), m, jnp.float32(0.0)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the dropped directions carry zero gain
    assert np.all(got.numpy()[3:] == 0.0) and np.all(got.numpy()[:3] != 0.0)


@pytest.fixture(scope="module")
def floor_tool():
    """The JAX package's experiment tools/exp_sweep_floor.py, loaded by path
    with FLOOR_H=3 (it reads the horizon when it is imported); its other
    widths stay n=40, m=20. The tool puts a fixed directory at the front
    of `sys.path` when it is imported; a copy of `sys.path` takes that
    insert and is dropped when the context ends."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "exp_sweep_floor.py")
    search_path = list(sys.path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOOR_H", "3")
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location("exp_sweep_floor_h3", path)
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
    assert sys.path == search_path
    return tool


@pytest.mark.parametrize("variant", sweep_floor_cuda.VARIANTS)
def test_sweep_floor_plain_matches_jax(floor_tool, variant):
    """The floor experiment's plain version (`sweep` on CPU tensors) against
    itself in float64 at 1e-4 of the largest gain, and against the
    experiment's Pallas kernel `_kernel` in interpret mode (bf16x3 products)
    at 2e-3 of it, as the Riccati sweep above. `load1nostore` writes only
    row 0 (the JAX kernel leaves the other rows undefined; the port's are
    zero), so that variant is compared on row 0."""
    H, n, m = floor_tool.H, floor_tool.N, floor_tool.M
    inputs = sweep_floor_cuda.random_inputs(H, n, m)
    ks_j, Ks_j = pl.pallas_call(
        partial(floor_tool._kernel, variant, 1),
        out_shape=(jax.ShapeDtypeStruct((H, m), jnp.float32),
                   jax.ShapeDtypeStruct((H, m, n), jnp.float32)),
        interpret=True)(*inputs)
    before = sweep_floor_cuda.sweep.launches
    ks, Ks = sweep_floor_cuda.sweep(variant, *(torch.as_tensor(a) for a in inputs))
    assert sweep_floor_cuda.sweep.launches == before
    ks64, Ks64 = sweep_floor_cuda.sweep_reference(
        variant, *(torch.as_tensor(a).double() for a in inputs))
    rows = slice(0, 1) if variant == "load1nostore" else slice(None)
    if variant == "load1nostore":
        assert not ks[1:].any() and not Ks[1:].any()
    scale = max(float(ks64[rows].abs().max()), float(Ks64[rows].abs().max()))
    for g, w, w64 in ((ks, ks_j, ks64), (Ks, Ks_j, Ks64)):
        g, w, w64 = g.numpy()[rows], np.asarray(w)[rows], w64.numpy()[rows]
        np.testing.assert_allclose(g, w64, rtol=0, atol=1e-4 * scale)
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * scale)
