"""The port's rotations, kinematics, contacts and substep against the JAX package on the same seeded inputs.

Both sides compute on identical constants (`from_numpy_model` of the JAX
model). Tolerances are those the JAX package holds its Pallas kernels to
(tests/test_pallas.py): kinematics 1e-5, bias 1e-4, contacts 1e-4, the
substep qpos and xpos 1e-5, qvel and cube 1e-4, touch flags exact.
"""

import ctypes
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_kmanip_tpu.dynamics import contacts as jcontacts
from gym_kmanip_tpu.dynamics.engine import _substep_jnp
from gym_kmanip_tpu.dynamics.state import SimState as JSimState
from gym_kmanip_tpu.models import get_model as jax_get_model
from gym_kmanip_tpu.ops import kinematics as jkin
from gym_kmanip_tpu.utils import rotations as jrot

from gym_kmanip_torch.dynamics import contacts, engine
from gym_kmanip_torch.dynamics.state import SimState, init_state
from gym_kmanip_torch.models import from_numpy_model, model_tensors
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.ops import riccati_cuda, rollout_feedback_cuda, rollout_pick_cuda
from gym_kmanip_torch.ops import substep_cuda
from gym_kmanip_torch.utils import rotations as rot

torch.set_num_threads(1)

MODES = [(0.02, True), (0.002, False)]  # MPC (stable PD) and env (explicit)


@pytest.fixture(scope="module")
def solo():
    jm = jax_get_model("solo_arm")
    return jm, from_numpy_model(jm)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               atol=atol, rtol=0, err_msg=msg)


def _unit_quats(rng, n):
    q = rng.randn(n, 4)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def test_rotations_match_jax():
    rng = np.random.RandomState(0)
    a, b = _unit_quats(rng, 16), _unit_quats(rng, 16)
    v = rng.randn(16, 3).astype(np.float32)
    # half the angular velocities inside the small-angle branch
    omega = np.concatenate([rng.randn(8, 3), rng.randn(8, 3) * 1e-7]).astype(np.float32)
    euler = rng.uniform(-3, 3, (16, 3)).astype(np.float32)
    _close(rot.quat_mul(_t(a), _t(b)), jrot.quat_mul(a, b), 1e-6)
    _close(rot.quat_rotate(_t(a), _t(v)), jrot.quat_rotate(a, v), 1e-6)
    _close(rot.quat_to_mat(_t(a)), jrot.quat_to_mat(a), 1e-6)
    _close(rot.quat_integrate(_t(a), _t(omega), 0.02),
           jrot.quat_integrate(a, omega, 0.02), 1e-6)
    _close(rot.euler_xyz_to_quat(_t(euler)), jrot.euler_xyz_to_quat(euler), 1e-6)
    # float64 numpy twins of the loader
    _close(rot.quat_mul_np(a[0], b[0]), jrot.quat_mul(a[0], b[0]), 1e-6)
    _close(rot.quat_rotate_np(a[0], v[0]), jrot.quat_rotate(a[0], v[0]), 1e-6)
    _close(rot.quat_to_mat_np(a[0]), jrot.quat_to_mat(a[0]), 1e-6)
    _close(rot.euler_xyz_to_quat_np(euler[0]), jrot.euler_xyz_to_quat(euler[0]), 1e-6)


def test_kinematics_match_jax():
    """On the torso, the branching 20-dof tree (the solo arm's frames are
    held by the substep test)."""
    jm = jax_get_model("torso")
    m = from_numpy_model(jm)
    K = 4
    rng = np.random.RandomState(0)
    q = rng.uniform(m.jnt_range[:, 0].clip(-3), m.jnt_range[:, 1].clip(max=3),
                    (K, m.nq)).astype(np.float32)
    v = (rng.randn(K, m.nq) * 0.4).astype(np.float32)

    got = kin.rnea_terms(m, _t(q), _t(v))
    want = jax.vmap(lambda a, b: jkin.rnea_terms(jm, a, b))(q, v)
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-4)):
        _close(g, w, tol)

    xp, xq, ax = kin.fk(m, _t(q))
    jxp, jxq, jax_ = jax.vmap(lambda a: jkin.fk(jm, a))(q)
    for g, w in ((xp, jxp), (xq, jxq), (ax, jax_)):
        _close(g, w, 1e-5)
    sp, sq = kin.all_site_poses(m, xp, xq)
    jsp, jsq = jax.vmap(lambda a, b: jkin.all_site_poses(jm, a, b))(jxp, jxq)
    _close(sp, jsp, 1e-5)
    _close(sq, jsq, 1e-5)
    p0, q0 = kin.site_pose(m, xp, xq, "eer_site")
    _close(p0, jsp[:, jm.site_index("eer_site")], 1e-5)
    _close(q0, jsq[:, jm.site_index("eer_site")], 1e-5)
    M = kin.mass_matrix_from_frames(m, xp, xq, ax)
    jM = jax.vmap(lambda a, b, c: jkin.mass_matrix_from_frames(jm, a, b, c))(jxp, jxq, jax_)
    _close(M, jM, 1e-5)


def test_contact_forces_match_jax(solo):
    jm, m = solo
    T, K = len(m.fingertips), 16
    rng = np.random.RandomState(1)
    tip_pos = (np.array([0.2, 0.5, 0.62]) + rng.randn(K, T, 3) * 0.02).astype(np.float32)
    tip_vel = (rng.randn(K, T, 3) * 0.2).astype(np.float32)
    cube_pos = (np.array([0.2, 0.5, 0.62]) + rng.randn(K, 3) * 0.005).astype(np.float32)
    qn = rng.randn(K, 4) * 0.1 + np.array([1.0, 0, 0, 0])
    cube_quat = (qn / np.linalg.norm(qn, axis=1, keepdims=True)).astype(np.float32)
    clv = (rng.randn(K, 3) * 0.1).astype(np.float32)
    cav = (rng.randn(K, 3) * 0.3).astype(np.float32)
    rad = np.asarray([t.radius for t in m.fingertips], dtype=np.float32)

    got = contacts.contact_forces(*(_t(a) for a in (tip_pos, tip_vel, rad, cube_pos,
                                                     cube_quat, clv, cav)))
    want = jax.jit(jax.vmap(
        lambda a, b, c, d, e, g: jcontacts.contact_forces(a, b, rad, c, d, e, g)
    ))(tip_pos, tip_vel, cube_pos, cube_quat, clv, cav)
    assert want.touch_tip.any() and not want.touch_tip.all()
    for f in ("force_cube", "torque_cube", "tip_forces"):
        _close(getattr(got, f), getattr(want, f), 1e-4, f)
    np.testing.assert_array_equal(got.touch_tip.numpy(), np.asarray(want.touch_tip))
    np.testing.assert_array_equal(got.touch_table.numpy(), np.asarray(want.touch_table))

    # a sphere centre inside the box leaves by the nearest face, the first
    # one on a tie (as jnp.argmin)
    centres = _t([[0.005, 0.005, -0.012], [0.01, -0.01, 0.0], [0.0, 0.0, 0.0]])
    pen, n = contacts.sphere_box(centres, 0.008, 0.02)
    _close(n, [[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], 0)
    _close(pen, [0.008 + 0.008, 0.008 + 0.01, 0.008 + 0.02], 1e-7)


def _jax_substep(jm, dt, implicit):
    def one(q, v, c, cube):
        s = JSimState(q, v, c, cube[:3], cube[3:7], cube[7:10], cube[10:13],
                      jnp.zeros(()))
        s2, (touch, xpos, xquat) = _substep_jnp(jm, s, dt, True, True, implicit)
        cube2 = jnp.concatenate([s2.cube_pos, s2.cube_quat, s2.cube_linvel,
                                 s2.cube_angvel])
        return s2.qpos, s2.qvel, cube2, touch, xpos, xquat

    return jax.jit(jax.vmap(one))


def _assert_substep_outputs(got, want):
    names = ("qpos", "qvel", "cube13", "touch", "xpos", "xquat")
    for name, g, w, tol in zip(names, got, want, (1e-5, 1e-4, 1e-4, None, 1e-5, 1e-5)):
        if tol is None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
        else:
            _close(g, w, tol, name)


@pytest.mark.parametrize("dt,implicit", MODES)
def test_substep_matches_jax(solo, dt, implicit):
    jm, m = solo
    q, v, c, cube = substep_cuda.random_inputs(m, 8, seed=3)
    want = _jax_substep(jm, dt, implicit)(q, v, c, cube)
    assert np.asarray(want[3]).any() and not np.asarray(want[3]).all()
    got = substep_cuda.substep_batched_reference(m, dt, True, implicit,
                                                 *(_t(a) for a in (q, v, c, cube)))
    _assert_substep_outputs([x.numpy() for x in got], want)


def test_substep_on_cpu_runs_plain(solo):
    _, m = solo
    q, v, c, cube = (_t(a) for a in substep_cuda.random_inputs(m, 4, seed=0))
    s = SimState(q, v, c, cube[:, :3], cube[:, 3:7], cube[:, 7:10], cube[:, 10:13],
                 torch.zeros(4))
    before = substep_cuda.substep_batched.launches
    new, (touch, xp, xq) = engine.substep(m, s, 0.02, True, True)
    ref, (rtouch, rxp, rxq) = engine._substep_torch(m, s, 0.02, True, True)
    for a, b in zip(tuple(new) + (touch, xp, xq), tuple(ref) + (rtouch, rxp, rxq)):
        assert torch.equal(a, b)
    # the kernel's wrapper on CPU tensors runs the plain version too
    out = substep_cuda.substep_batched(m, 0.02, True, True, q, v, c, cube)
    plain = substep_cuda.substep_batched_reference(m, 0.02, True, True, q, v, c, cube)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert substep_cuda.substep_batched.launches == before
    # an unbatched state keeps its shapes
    one, (t1, x1, _) = engine.substep(m, init_state(m, device="cpu"), 0.002)
    assert one.qpos.shape == (m.nq,) and t1.shape == (2,) and x1.shape == (m.nq, 3)


def test_substep_cuda_imports_without_nvcc(solo):
    _, m = solo
    # importing built nothing: the library is built at the first launch
    assert substep_cuda._library.cache_info().currsize == 0
    # the packed model matches the layout the header declares
    with open(os.path.join(substep_cuda._build.CSRC_DIR, "substep.cuh")) as f:
        header = f.read()
    n_floats = re.search(r"N_FLOATS = (\d+) \* NQ \+ (\d+) \* T", header).groups()
    n_ints = re.search(r"I_NU = (\d+) \* NQ \+ NQ \* NQ \+ T, N_INTS = I_NU \+ 1", header)
    floats, ints = substep_cuda.pack_model(m)
    T = len(m.fingertips)
    assert floats.size == int(n_floats[0]) * m.nq + int(n_floats[1]) * T
    assert n_ints is not None and ints.size == 2 * m.nq + m.nq**2 + T + 1
    # a device that is neither the CPU nor CUDA is refused, not computed
    meta = [torch.empty(4, n, device="meta") for n in (m.nq, m.nq, m.nu, 13)]
    with pytest.raises(ValueError):
        substep_cuda.substep_batched(m, 0.02, True, True, *meta)


_HOST_HARNESS = r"""
#include <cmath>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "substep.cuh"
#include "rollout.cuh"
#include "riccati.cuh"
extern "C" int host_substep(int nq, int T, const float* mf, const int* mi, double dt,
    int contact, int implicit, int K, const float* qpos, const float* qvel,
    const float* ctrl, const float* cube13, float* qo, float* vo, float* co,
    bool* touch, float* xp, float* xq) {
  using namespace kmanip;
  const StepConsts c = make_consts(dt);
  if (nq == 10 && T == 2) {
    ModelView<10, 2> m{mf, mi};
    for (int k = 0; k < K; ++k)
      substep_rollout<10, 2>(k, m, c, contact, implicit, qpos, qvel, ctrl, cube13,
                             qo, vo, co, touch, xp, xq);
    return 0;
  }
  if (nq == 20 && T == 4) {
    ModelView<20, 4> m{mf, mi};
    for (int k = 0; k < K; ++k)
      substep_rollout<20, 4>(k, m, c, contact, implicit, qpos, qvel, ctrl, cube13,
                             qo, vo, co, touch, xp, xq);
    return 0;
  }
  return -1;
}

// the whole-horizon kernels, thread by thread (csrc/rollout.cuh)
extern "C" int host_rollout_pick(int nq, int T, const float* mf, const int* mi, double dt,
    int contact, int implicit, int n_substeps, int K, int H, const float* spec_f,
    const int* spec_i, const float* ctrl_seqs, const float* state0, float* cost) {
  using namespace kmanip;
  const StepConsts c = make_consts(dt);
  const PickSpec spec = make_pick_spec(spec_f, spec_i);
  if (nq == 10 && T == 2) {
    ModelView<10, 2> m{mf, mi};
    for (int k = 0; k < K; ++k)
      cost[k] = rollout_pick_thread<10, 2>(k, m, c, contact, implicit, n_substeps, H, spec,
                                           ctrl_seqs, state0);
    return 0;
  }
  if (nq == 20 && T == 4) {
    ModelView<20, 4> m{mf, mi};
    for (int k = 0; k < K; ++k)
      cost[k] = rollout_pick_thread<20, 4>(k, m, c, contact, implicit, n_substeps, H, spec,
                                           ctrl_seqs, state0);
    return 0;
  }
  return -1;
}

extern "C" int host_rollout_feedback(int nq, int T, const float* mf, const int* mi, double dt,
    int n_substeps, int B, int H, const float* alphas, const float* x0, const float* cube0,
    const float* xs_nom, const float* us_nom, const float* ks, const float* Ks,
    const float* lo, const float* hi, float* xs, float* us) {
  using namespace kmanip;
  const StepConsts c = make_consts(dt);
  if (nq == 10 && T == 2) {
    ModelView<10, 2> m{mf, mi};
    for (int b = 0; b < B; ++b)
      rollout_feedback_thread<10, 2>(b, m, c, n_substeps, H, alphas, x0, cube0, xs_nom,
                                     us_nom, ks, Ks, lo, hi, xs, us);
    return 0;
  }
  if (nq == 20 && T == 4) {
    ModelView<20, 4> m{mf, mi};
    for (int b = 0; b < B; ++b)
      rollout_feedback_thread<20, 4>(b, m, c, n_substeps, H, alphas, x0, cube0, xs_nom,
                                     us_nom, ks, Ks, lo, hi, xs, us);
    return 0;
  }
  return -1;
}

// the Riccati sweep's block code with one thread and a no-op barrier
struct NoSync {
  void operator()() const {}
};

extern "C" void host_riccati(int H, int n, int m, double reg, float lam_extra, const float* A,
    const float* B, const float* cx, const float* cu, const float* cxx, const float* cuu,
    const float* cux, const float* VxT, const float* VxxT, float* ks, float* Ks) {
  std::vector<float> sm(kmanip::riccati_layout(n, m).total);
  kmanip::riccati_sweep_block(0, 1, NoSync{}, H, n, m, (float)reg, lam_extra, A, B, cx, cu,
                              cxx, cuu, cux, VxT, VxxT, ks, Ks, sm.data());
}

extern "C" void host_chol_solve(int m, int r, const float* Q, float lam, const float* RHS,
    float* X) {
  std::vector<float> S(m * m), dsc(m), piv(m), keep(m);
  kmanip::chol_solve_dropping(0, 1, NoSync{}, m, r, Q, lam, RHS, X, S.data(), dsc.data(),
                              piv.data(), keep.data());
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The CUDA kernel's device code (csrc/substep.cuh) compiled as host C++,
    so its arithmetic is checked on a machine without a GPU."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the kernel source for the host")
    d = tmp_path_factory.mktemp("host_kernel")
    src, lib = d / "host_substep.cpp", d / "host_substep.so"
    src.write_text(_HOST_HARNESS)
    subprocess.run(
        [cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-I", substep_cuda._build.CSRC_DIR, "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    so = ctypes.CDLL(str(lib))
    P = ctypes.c_void_p
    so.host_substep.argtypes = [ctypes.c_int] * 2 + [P] * 2 + [
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int
    ] + [P] * 10
    so.host_substep.restype = ctypes.c_int
    so.host_rollout_pick.argtypes = [ctypes.c_int] * 2 + [P] * 2 + [ctypes.c_double] + [
        ctypes.c_int] * 5 + [P] * 5
    so.host_rollout_pick.restype = ctypes.c_int
    so.host_rollout_feedback.argtypes = [ctypes.c_int] * 2 + [P] * 2 + [ctypes.c_double] + [
        ctypes.c_int] * 3 + [P] * 11
    so.host_rollout_feedback.restype = ctypes.c_int
    so.host_riccati.argtypes = [ctypes.c_int] * 3 + [ctypes.c_double, ctypes.c_float] + [P] * 11
    so.host_riccati.restype = None
    so.host_chol_solve.argtypes = [ctypes.c_int] * 2 + [P, ctypes.c_float, P, P]
    so.host_chol_solve.restype = None
    return so


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
@pytest.mark.parametrize("dt,implicit", MODES)
def test_kernel_source_matches_plain_on_host(host_kernel, name, dt, implicit):
    m = from_numpy_model(jax_get_model(name))
    K, T = 64, len(m.fingertips)
    q, v, c, cube = substep_cuda.random_inputs(m, K, seed=7)
    mf, mi = substep_cuda.pack_model(m)
    out = [np.zeros((K, m.nq), np.float32), np.zeros((K, m.nq), np.float32),
           np.zeros((K, 13), np.float32), np.zeros((K, T), bool),
           np.zeros((K, m.nq, 3), np.float32), np.zeros((K, m.nq, 4), np.float32)]
    rc = host_kernel.host_substep(
        m.nq, T, mf.ctypes.data, mi.ctypes.data, dt, 1, int(implicit), K,
        *(a.ctypes.data for a in (q, v, c, cube)), *(o.ctypes.data for o in out),
    )
    assert rc == 0
    plain = substep_cuda.substep_batched_reference(m, dt, True, implicit,
                                                   *(_t(a) for a in (q, v, c, cube)))
    assert plain[3].any()
    _assert_substep_outputs(out, [x.numpy() for x in plain])


def _ptr(a):
    return a.ctypes.data


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_rollout_kernel_sources_match_plain_on_host(host_kernel, name):
    """csrc/rollout.cuh on the host: the pick-cost rollout (K2) against
    `rollout_pick_costs_reference` (H=3 totals at 1e-3, as
    tests/test_torch_mppi.py holds the H=3 rollout), and the feedback
    rollout (K3) against `rollout_feedback_reference` (us 2e-5 / 1e-4, xs
    5e-4 / 1e-3, tests/test_pallas.py:377-380)."""
    m = from_numpy_model(jax_get_model(name))
    nq, nu, T = m.nq, m.nu, len(m.fingertips)
    mf, mi = substep_cuda.pack_model(m)
    rng = np.random.RandomState(9)
    s0 = init_state(m, cube_pos=np.array([0.25, 0.5, 0.62]), device="cpu")
    start = torch.cat([s0.qpos, s0.qvel, s0.cube_pos, s0.cube_quat, s0.cube_linvel,
                       s0.cube_angvel]).numpy()
    K, H = 6, 3
    U = (m.home_qpos[:nu] + 0.1 * rng.randn(K, H, nu)).astype(np.float32)
    spec = rollout_pick_cuda.PickCostSpec(use_left=T > 2)
    spec_f, spec_i = rollout_pick_cuda.spec_arrays(m, spec)
    for dt, n_sub in ((0.02, 1), (0.002, 2)):
        cost = np.zeros(K, np.float32)
        assert host_kernel.host_rollout_pick(
            nq, T, _ptr(mf), _ptr(mi), dt, 1, 1, n_sub, K, H, _ptr(spec_f), _ptr(spec_i),
            _ptr(U), _ptr(start), _ptr(cost)) == 0
        want = rollout_pick_cuda.rollout_pick_costs_reference(
            m, torch.as_tensor(U), s0, spec, n_substeps=n_sub, dt=dt).numpy()
        _close(cost, want, 1e-3, f"pick dt={dt}")

    n, B, H = 2 * nq, 3, 4
    t = model_tensors(m, "cpu")
    x0 = start[:n].copy()
    cube0 = start[n:].copy()
    xs_nom = (x0[None] + 0.02 * rng.randn(H, n)).astype(np.float32)
    us_nom = (m.home_qpos[:nu] + 0.05 * rng.randn(H, nu)).astype(np.float32)
    ks = (0.03 * rng.randn(H, nu)).astype(np.float32)
    Ks = (0.05 * rng.randn(H, nu, n)).astype(np.float32)
    alphas = np.array([0.0, 0.3, 1.0], np.float32)
    lo, hi = t.ctrl_lo.numpy(), t.ctrl_hi.numpy()
    xs = np.zeros((B, H, n), np.float32)
    us = np.zeros((B, H, nu), np.float32)
    assert host_kernel.host_rollout_feedback(
        nq, T, _ptr(mf), _ptr(mi), 0.02, 1, B, H, *(_ptr(a) for a in (
            alphas, x0, cube0, xs_nom, us_nom, ks, Ks, lo, hi, xs, us))) == 0
    wxs, wus = rollout_feedback_cuda.rollout_feedback_reference(
        m, *(torch.as_tensor(a) for a in (x0, cube0, xs_nom, us_nom, ks, Ks, alphas)))
    np.testing.assert_allclose(us, wus.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(xs, wxs.numpy(), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("H,n,m,indefinite", [(5, 20, 10, False), (6, 7, 3, True)])
@pytest.mark.parametrize("lam_extra", [0.0, 1e-3])
def test_riccati_kernel_source_matches_plain_on_host(host_kernel, H, n, m, indefinite,
                                                     lam_extra):
    """csrc/riccati.cuh run with one thread and a no-op barrier against
    `riccati_sweep_reference`: both float32, summed in other orders, held
    at 1e-4 of the largest gain (each is within ~1e-5 of float64)."""
    prob = riccati_cuda.random_problem(4, H, n, m, indefinite)
    ks = np.zeros((H, m), np.float32)
    Ks = np.zeros((H, m, n), np.float32)
    host_kernel.host_riccati(H, n, m, 1e-6, lam_extra, *(_ptr(a) for a in prob),
                             _ptr(ks), _ptr(Ks))
    wks, wKs = riccati_cuda.riccati_sweep_reference(*(torch.as_tensor(a) for a in prob), 1e-6,
                                                    lam_extra=lam_extra)
    for g, w in ((ks, wks.numpy()), (Ks, wKs.numpy())):
        assert np.isfinite(g).all()
        _close(g, w, 1e-4 * np.abs(w).max())

    # the solve on its own drops the vanishing pivots of a singular matrix
    rng = np.random.RandomState(2)
    v = rng.randn(5, 3)
    Q = (v @ v.T).astype(np.float32)
    RHS = rng.randn(5, 4).astype(np.float32)
    X = np.zeros((5, 4), np.float32)
    host_kernel.host_chol_solve(5, 4, _ptr(Q), 0.0, _ptr(RHS), _ptr(X))
    want = riccati_cuda.chol_solve_dropping(torch.as_tensor(Q), torch.as_tensor(RHS),
                                            torch.tensor(0.0)).numpy()
    assert np.all(X[3:] == 0.0)
    _close(X, want, 1e-4 * np.abs(want).max())
