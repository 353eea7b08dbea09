"""The port's rotations, kinematics, contacts and substep against the JAX package on the same seeded inputs.

Both sides compute on identical constants (`from_numpy_model` of the JAX
model). Tolerances are those the JAX package holds its Pallas kernels to
(tests/test_pallas.py): kinematics 1e-5, bias 1e-4, contacts 1e-4, the
substep qpos and xpos 1e-5, qvel and cube 1e-4, touch flags exact.
"""

import ctypes
import functools
import os
import re
import shutil
import subprocess
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gym_kmanip_tpu.dynamics import contacts as jcontacts
from gym_kmanip_tpu.dynamics.engine import _substep_jnp
from gym_kmanip_tpu.dynamics.state import SimState as JSimState
from gym_kmanip_tpu.models import get_model as jax_get_model
from gym_kmanip_tpu.ops import linalg as jlinalg
from gym_kmanip_tpu.ops.pallas_contacts import _contacts_kernel
from gym_kmanip_tpu.ops.pallas_dynamics import _rnea_kernel
from gym_kmanip_tpu.ops.pallas_linalg import _chol_solve_kernel
from gym_kmanip_tpu.utils import rotations as jrot

from gym_kmanip_torch.dynamics import contacts, engine
from gym_kmanip_torch.dynamics.state import SimState, init_state
from gym_kmanip_torch.models import from_numpy_model, model_tensors
from gym_kmanip_torch.ops import chol_solve_cuda, contacts_cuda, linalg, rnea_cuda
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.ops import riccati_cuda, rollout_feedback_cuda, rollout_pick_cuda
from gym_kmanip_torch.ops import substep_cuda, sweep_floor_cuda
from gym_kmanip_torch.utils import rotations as rot
from test_torch_cuda import float64_twin

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


@functools.lru_cache(maxsize=None)
def _jax_rnea(name):
    """(JAX model, port model, q, v, {JAX output: array}) on the inputs of
    tests/test_pallas.py:56-73 (K=4). The outputs are the JAX seam
    `kinematics.rnea_terms_fast` under vmap (on the CPU it runs
    `jax.vmap(rnea_terms)`), and on the torso `fk`, `all_site_poses` and
    `mass_matrix_from_frames` under vmap, read from tests/golden/rnea_refs.npz
    (`python tools/make_golden_rnea.py`: ~15-20 s of eager op compiles),
    which holds the inputs too."""
    jm = jax_get_model(name)
    m = from_numpy_model(jm)
    rng = np.random.RandomState(0)
    q = rng.uniform(m.jnt_range[:, 0].clip(-3), m.jnt_range[:, 1].clip(max=3),
                    (4, m.nq)).astype(np.float32)
    v = (rng.randn(4, m.nq) * 0.4).astype(np.float32)
    with np.load(os.path.join(os.path.dirname(__file__), "golden", "rnea_refs.npz")) as g:
        ref = {key[len(name) + 1:]: g[key] for key in g.files if key.startswith(f"{name}/")}
    np.testing.assert_array_equal(ref["q"], q)
    np.testing.assert_array_equal(ref["v"], v)
    return jm, m, q, v, ref


def test_kinematics_match_jax():
    """On the torso, the branching 20-dof tree (the solo arm's frames are
    held by the substep test)."""
    jm, m, q, v, ref = _jax_rnea("torso")
    got = kin.rnea_terms(m, _t(q), _t(v))
    for g, key, tol in zip(got, ("xpos", "xquat", "axis", "bias"), (1e-5, 1e-5, 1e-5, 1e-4)):
        _close(g, ref[f"seam/{key}"], tol)

    xp, xq, ax = kin.fk(m, _t(q))
    for g, key in ((xp, "xpos"), (xq, "xquat"), (ax, "axis")):
        _close(g, ref[f"fk/{key}"], 1e-5)
    sp, sq = kin.all_site_poses(m, xp, xq)
    jsp, jsq = ref["fk/site_pos"], ref["fk/site_quat"]
    _close(sp, jsp, 1e-5)
    _close(sq, jsq, 1e-5)
    p0, q0 = kin.site_pose(m, xp, xq, "eer_site")
    _close(p0, jsp[:, jm.site_index("eer_site")], 1e-5)
    _close(q0, jsq[:, jm.site_index("eer_site")], 1e-5)
    M = kin.mass_matrix_from_frames(m, xp, xq, ax)
    _close(M, ref["fk/M"], 1e-5)


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


def _pallas_outputs(kernel, out_shapes, *inputs, interpret=True):
    """A JAX package Pallas kernel on (rows, K) inputs and outputs, on the
    CPU. With `interpret`, in interpret mode, as tests/test_pallas.py runs
    it; that compiles the whole trace-time-unrolled kernel first (13 s for
    the solo arm's FK + RNEA, 23 s for the torso's, 4.6 s for the n=20
    solve, measured on an 8-core x86 CPU). Without, the kernel function
    itself runs eagerly, host arrays standing in for its refs: the same
    operations, for well under a second."""
    if interpret:
        return pl.pallas_call(kernel, out_shape=tuple(
            jax.ShapeDtypeStruct(s, jnp.float32) for s in out_shapes), interpret=True)(*inputs)
    outs = [np.zeros(s, np.float32) for s in out_shapes]
    kernel(*(np.ascontiguousarray(a, np.float32) for a in inputs), *outs)
    return outs


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_rnea_terms_fast_matches_jax(name):
    """`rnea_terms_fast` (K5's plain version on CPU tensors) against the JAX
    seam `kinematics.rnea_terms_fast` under vmap and against the Pallas
    kernel `_rnea_kernel` (run eagerly: interpret mode costs 13-23 s here,
    and tests/test_pallas.py:55-88 already runs it), on the inputs of
    tests/test_pallas.py:56-73: frames 1e-5, bias 1e-4 (:85-88)."""
    jm, m, q, v, ref = _jax_rnea(name)
    seam = tuple(ref[f"seam/{key}"] for key in ("xpos", "xquat", "axis", "bias"))
    K, nq = q.shape
    got = kin.rnea_terms_fast(m, _t(q), _t(v))
    xp, xq, ax, bias = _pallas_outputs(partial(_rnea_kernel, jm, -9.81),
                                       ((nq * 3, K), (nq * 4, K), (nq * 3, K), (nq, K)),
                                       q.T, v.T, interpret=False)
    kernel = (xp.T.reshape(K, nq, 3), xq.T.reshape(K, nq, 4), ax.T.reshape(K, nq, 3), bias.T)
    for want in (seam, kernel):
        for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-4)):
            _close(g, w, tol)
    # leading batch dimensions and an unbatched state
    two = kin.rnea_terms_fast(m, _t(q).reshape(2, 2, nq), _t(v).reshape(2, 2, nq))
    one = kin.rnea_terms_fast(m, _t(q[1]), _t(v[1]))
    for g, g2, g1 in zip(got, two, one):
        _close(g2.reshape(g.shape), g, 1e-6)
        _close(g1, g[1], 1e-6)


def _pallas_contact_inputs(m):
    """The inputs of tests/test_pallas.py:101-117 (K=8)."""
    T, K = len(m.fingertips), 8
    rng = np.random.RandomState(1)
    tip_pos = np.array([0.2, 0.5, 0.62]) + rng.randn(K, T, 3) * 0.02
    tip_vel = rng.randn(K, T, 3) * 0.2
    cube_pos = np.tile([0.2, 0.5, 0.62], (K, 1)) + rng.randn(K, 3) * 0.005
    qn = rng.randn(K, 4) * 0.1 + np.array([1.0, 0, 0, 0])
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    clv = rng.randn(K, 3) * 0.1
    cav = rng.randn(K, 3) * 0.3
    return [a.astype(np.float32) for a in (tip_pos, tip_vel, cube_pos, qn, clv, cav)]


def test_contact_forces_fast_matches_jax(solo):
    """`contact_forces_fast` (K6's plain version on CPU tensors) against the
    JAX seam `contacts.contact_forces_fast` under vmap and against the
    Pallas kernel `_contacts_kernel` in interpret mode: forces 1e-4, flags
    equal (tests/test_pallas.py:135-141)."""
    jm, m = solo
    inputs = _pallas_contact_inputs(m)
    K, T = inputs[0].shape[:2]
    got = contacts.contact_forces_fast(m, *(_t(a) for a in inputs))
    seam = jax.jit(jax.vmap(lambda *a: jcontacts.contact_forces_fast(jm, *a)))(*inputs)
    fc, tc, tf, touch, ttab = _pallas_outputs(
        partial(_contacts_kernel, jm), ((3, K), (3, K), (T * 3, K), (T, K), (1, K)),
        inputs[0].reshape(K, T * 3).T, inputs[1].reshape(K, T * 3).T,
        np.concatenate(inputs[2:], axis=1).T)
    kernel = (fc.T, tc.T, tf.T.reshape(K, T, 3), touch.T > 0.5, ttab[0] > 0.5)
    assert np.asarray(seam.touch_tip).any() and not np.asarray(seam.touch_tip).all()
    for want in (tuple(seam), kernel):
        for name, g, w in zip(contacts.ContactOut._fields, got, want):
            if g.dtype == torch.bool:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
            else:
                _close(g, w, 1e-4, name)
    # leading batch dimensions and an unbatched state
    two = contacts.contact_forces_fast(m, *(_t(a).reshape((2, 4) + a.shape[1:]) for a in inputs))
    one = contacts.contact_forces_fast(m, *(_t(a[3]) for a in inputs))
    for g, g2, g1 in zip(got, two, one):
        _close(g2.reshape(g.shape), g, 1e-6)
        _close(g1, g[3], 1e-6)


@pytest.mark.parametrize("n", [6, 10, 20])
def test_batch_aware_solve_matches_jax(n):
    """`batch_aware_cholesky_solve` (K7's plain version on CPU tensors)
    against the JAX package's under vmap, against the Pallas kernel
    `_chol_solve_kernel` (in interpret mode up to n=10, eagerly at n=20)
    and against float64, on the problem of tests/test_pallas.py:14-22
    (K=8): 1e-4 of the largest entry. A matrix that is not positive
    definite gives NaN on both sides."""
    K = 8
    rng = np.random.RandomState(0)
    A = rng.randn(K, n, n)
    M = (A @ A.transpose(0, 2, 1) + 5 * np.eye(n)).astype(np.float32)
    b = rng.randn(K, n).astype(np.float32)
    got = linalg.batch_aware_cholesky_solve(_t(M), _t(b)).numpy()
    want64 = np.linalg.solve(M.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    seam = jax.vmap(jlinalg.batch_aware_cholesky_solve)(M, b)
    (kernel,) = _pallas_outputs(partial(_chol_solve_kernel, n), ((n, K),),
                                M.reshape(K, n * n).T, b.T, interpret=n <= 10)
    for want in (want64, seam, kernel.T):
        _close(got, want, 1e-4 * np.abs(want64).max())
    # the same solve with a leading (2, 4) batch, an unbatched problem, and
    # the kernel wrapper's plain version
    two = linalg.batch_aware_cholesky_solve(_t(M).reshape(2, 4, n, n), _t(b).reshape(2, 4, n))
    _close(two.reshape(K, n), got, 1e-6 * np.abs(got).max())
    _close(linalg.batch_aware_cholesky_solve(_t(M[5]), _t(b[5])), got[5],
           1e-6 * np.abs(got).max())
    assert torch.equal(chol_solve_cuda.cholesky_solve_batched(_t(M), _t(b)), torch.as_tensor(got))
    if n == 6:
        bad = np.eye(n, dtype=np.float32)
        bad[n // 2, n // 2] = -1.0
        assert np.isnan(linalg.batch_aware_cholesky_solve(_t(bad), _t(b[0])).numpy()).all()
        assert np.isnan(np.asarray(jlinalg.batch_aware_cholesky_solve(bad, b[0]))).all()


def test_staged_wrappers_run_plain_on_cpu(solo):
    """On CPU tensors the K5, K6 and K7 wrappers run their plain versions
    and count no launch; a device that is neither the CPU nor CUDA is
    refused."""
    _, m = solo
    q, v, c, cube = (_t(a) for a in substep_cuda.random_inputs(m, 4, seed=0))
    wrappers = (rnea_cuda.rnea_terms_batched, contacts_cuda.contact_forces_batched,
                chol_solve_cuda.cholesky_solve_batched)
    before = [w.launches for w in wrappers]
    for g, w in zip(rnea_cuda.rnea_terms_batched(m, q, v), kin.rnea_terms(m, q, v)):
        assert torch.equal(g, w)
    xp, xq, ax, _ = kin.rnea_terms(m, q, v)
    tips, tip_vel, _, rad = engine._tip_state(m, xp, xq, ax, v)
    args = (tips, tip_vel, cube[:, :3], cube[:, 3:7], cube[:, 7:10], cube[:, 10:])
    for g, w in zip(contacts_cuda.contact_forces_batched(m, *args),
                    contacts.contact_forces(tips, tip_vel, rad, *args[2:])):
        assert torch.equal(g, w)
    M = torch.eye(m.nq).expand(4, -1, -1).contiguous()
    assert torch.equal(chol_solve_cuda.cholesky_solve_batched(M, q), q)
    assert [w.launches for w in wrappers] == before
    meta = torch.empty(4, m.nq, device="meta")
    with pytest.raises(ValueError):
        rnea_cuda.rnea_terms_batched(m, meta, meta)
    with pytest.raises(ValueError):
        kin.rnea_terms_fast(m, meta, meta)
    with pytest.raises(ValueError):
        linalg.batch_aware_cholesky_solve(torch.empty(4, 3, 3, device="meta"),
                                          torch.empty(4, 3, device="meta"))
    with pytest.raises(ValueError):
        chol_solve_cuda.cholesky_solve_batched(M, q.to("meta"))


def _jax_substep(jm, dt, implicit):
    def one(q, v, c, cube):
        s = JSimState(q, v, c, cube[:3], cube[3:7], cube[7:10], cube[10:13],
                      jnp.zeros(()))
        s2, (touch, xpos, xquat) = _substep_jnp(jm, s, dt, True, True, implicit)
        cube2 = jnp.concatenate([s2.cube_pos, s2.cube_quat, s2.cube_linvel,
                                 s2.cube_angvel])
        return s2.qpos, s2.qvel, cube2, touch, xpos, xquat

    return jax.vmap(one)


@pytest.fixture(scope="module")
def jax_substeps(solo):
    """JAX's `_substep_jnp(..., contact=True, unrolled_solve=True, ...)`
    under vmap on seeded inputs, both modes in one compiled program: the
    counterpart of the plain substep and of the staged route (whose seams
    and batch-aware solve it calls)."""
    jm, m = solo
    inputs = substep_cuda.random_inputs(m, 8, seed=3)
    outs = jax.jit(lambda *a: [_jax_substep(jm, dt, imp)(*a) for dt, imp in MODES])(*inputs)
    return inputs, dict(zip(MODES, outs))


def _assert_substep_outputs(got, want):
    names = ("qpos", "qvel", "cube13", "touch", "xpos", "xquat")
    for name, g, w, tol in zip(names, got, want, (1e-5, 1e-4, 1e-4, None, 1e-5, 1e-5)):
        if tol is None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
        else:
            _close(g, w, tol, name)


def _staged(m, dt, implicit, q, v, c, cube):
    s = SimState(q, v, c, cube[:, :3], cube[:, 3:7], cube[:, 7:10], cube[:, 10:13],
                 torch.zeros(q.shape[0]))
    s2, (touch, xpos, xquat) = engine.substep_staged(m, s, dt, True, implicit)
    cube2 = torch.cat([s2.cube_pos, s2.cube_quat, s2.cube_linvel, s2.cube_angvel], -1)
    return s2.qpos, s2.qvel, cube2, touch, xpos, xquat


@pytest.mark.parametrize("dt,implicit,route", [
    pytest.param(dt, imp, route, id=f"{dt}-{imp}" + ("" if route == "plain" else "-staged"))
    for route in ("plain", "staged") for dt, imp in MODES])
def test_substep_matches_jax(solo, jax_substeps, dt, implicit, route):
    """The plain substep, and the staged route (K5, K6 and K7 stages; their
    plain versions on the CPU), against `_substep_jnp` with its seams."""
    _, m = solo
    inputs, want = jax_substeps
    want = want[(dt, implicit)]
    assert np.asarray(want[3]).any() and not np.asarray(want[3]).all()
    args = [_t(a) for a in inputs]
    if route == "plain":
        got = substep_cuda.substep_batched_reference(m, dt, True, implicit, *args)
    else:
        got = _staged(m, dt, implicit, *args)
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


_HOST_PRELUDE = r"""
#include <pthread.h>

#include <cmath>
#include <thread>
#include <type_traits>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "substep.cuh"
#include "rollout.cuh"
#include "feedback_warp.cuh"
#include "riccati.cuh"
#include "staged.cuh"
#include "staged_team.cuh"
#include "sweep_floor.cuh"
// the cooperative kernels' device code on host threads: a team of S
// threads behind one barrier (S = 1: no barrier), as one warp on the card
struct HostBarrier {
  pthread_barrier_t* bar;
  void operator()() const {
    if (bar) pthread_barrier_wait(bar);
  }
};

template <int S>
struct HostTeam {
  static constexpr int SIZE = S;
  int lane;
  pthread_barrier_t* bar;
  float* slot;  // S floats shared by the team
  void sync() const {
    if (bar) pthread_barrier_wait(bar);
  }
  float bcast(float v, int src) const {
    if (!bar) return v;
    sync();
    if (lane == src) slot[0] = v;
    sync();
    return slot[0];
  }
  float max(float v) const { return reduce(v, true); }
  float min(float v) const { return reduce(v, false); }
  float reduce(float v, bool is_max) const {
    if (!bar) return v;
    sync();
    slot[lane] = v;
    sync();
    float r = slot[0];
    for (int i = 1; i < S; ++i) r = is_max ? std::fmax(r, slot[i]) : std::fmin(r, slot[i]);
    return r;
  }
};

// f(thread index, barrier or nullptr) on S threads
template <int S, class F>
void run_team(F f) {
  if (S == 1) {
    f(0, nullptr);
    return;
  }
  pthread_barrier_t bar;
  pthread_barrier_init(&bar, nullptr, S);
  std::vector<std::thread> threads;
  for (int t = 0; t < S; ++t) threads.emplace_back([&, t] { f(t, &bar); });
  for (auto& th : threads) th.join();
  pthread_barrier_destroy(&bar);
}

// The team kernels K1 and K2 (csrc/substep_team.cuh, csrc/rollout.cuh) on
// one team of S host threads (the shape of one of a block's teams on the
// card), the team running the batch's rows one after another.
template <int V>
using IC = std::integral_constant<int, V>;

// f(nq, T, contact, implicit, S) with compile-time values, for the model
// of nq = HOST_NQ (each team part is compiled once per model); -1 for
// another
template <class F>
int with_team(int threads, int nq, int T, int contact, int implicit, F f) {
  auto modes = [&](auto n, auto t, auto s) {
    if (contact && implicit) f(n, t, IC<1>{}, IC<1>{}, s);
    else if (contact) f(n, t, IC<1>{}, IC<0>{}, s);
    else if (implicit) f(n, t, IC<0>{}, IC<1>{}, s);
    else f(n, t, IC<0>{}, IC<0>{}, s);
  };
  auto widths = [&](auto n, auto t) {
    if (threads == 1) modes(n, t, IC<1>{});
    else if (threads == 4) modes(n, t, IC<4>{});
#ifdef HOST_HALF_WARP
    else if (threads == 16) modes(n, t, IC<16>{});
#endif
    else return -1;
    return 0;
  };
#if HOST_NQ == 10
  if (nq == 10 && T == 2) return widths(IC<10>{}, IC<2>{});
#elif HOST_NQ == 20
  if (nq == 20 && T == 4) return widths(IC<20>{}, IC<4>{});
#endif
  return -1;
}

"""

# the harness in four parts: the serial references, K3, K4 and the staged
# kernels (K7's team solve too); the team substep K1 and K5's team FK +
# RNEA; the team pick-cost rollout K2 (these two compiled once per model);
# K6's team contact model and the floor experiment K8
_HOST_HARNESS = (r"""extern "C" int host_substep(int nq, int T, const float* mf, const int* mi, double dt,
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

// the serial references of the team kernels K1 (above) and K2
// (csrc/rollout.cuh), rollout by rollout
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

// K3: the team rollout (csrc/feedback_warp.cuh), one team per step size
template <int NQ, int T, int S>
void feedback_team(const float* mf, const int* mi, const kmanip::StepConsts& c, int n_sub,
                   int B, int H, const float* alphas, const float* x0, const float* xs_nom,
                   const float* us_nom, const float* ks, const float* Ks, const float* lo,
                   const float* hi, float* xs, float* us) {
  using namespace kmanip;
  for (int b = 0; b < B; ++b) {
    std::vector<FeedbackShared<NQ, T>> s(1);
    float slot[S];
    run_team<S>([&](int lane, pthread_barrier_t* bar) {
      rollout_feedback_team<NQ, T>(HostTeam<S>{lane, bar, slot}, s[0], b, mf, mi, c, n_sub, H,
                                   alphas, x0, xs_nom, us_nom, ks, Ks, lo, hi, xs, us);
    });
  }
}

// The same rollout, one step size at a time over substep_core: the serial
// order every sum of the team rollout keeps.
template <int NQ, int T>
void feedback_serial(int b, const kmanip::ModelView<NQ, T>& m, const kmanip::StepConsts& c,
                     int n_sub, int H, const float* alphas, const float* x0, const float* cube0,
                     const float* xs_nom, const float* us_nom, const float* ks, const float* Ks,
                     const float* lo, const float* hi, float* xs_out, float* us_out) {
  using namespace kmanip;
  constexpr int N = 2 * NQ;
  const int nu = m.nu();
  float q[NQ], v[NQ], u[NQ], dx[N];
  for (int i = 0; i < NQ; ++i) {
    q[i] = x0[i];
    v[i] = x0[NQ + i];
    u[i] = 0.f;
  }
  bool touch[T];
  V3 x[NQ];
  Q4 qq[NQ];
  for (int h = 0; h < H; ++h) {
    for (int j = 0; j < NQ; ++j) {
      dx[j] = q[j] - xs_nom[h * N + j];
      dx[NQ + j] = v[j] - xs_nom[h * N + NQ + j];
    }
    for (int i = 0; i < nu; ++i) {
      const float* Ki = Ks + (h * nu + i) * N;
      float fb = 0.f;
      for (int j = 0; j < N; ++j) fb = fb + Ki[j] * dx[j];
      u[i] = clampf((us_nom[h * nu + i] + alphas[b] * ks[h * nu + i]) + fb, lo[i], hi[i]);
    }
    Cube cube{{cube0[0], cube0[1], cube0[2]}, {cube0[3], cube0[4], cube0[5], cube0[6]},
              {cube0[7], cube0[8], cube0[9]}, {cube0[10], cube0[11], cube0[12]}};
    for (int s = 0; s < n_sub; ++s) substep_core<NQ, T>(m, c, false, true, q, v, u, cube, touch, x, qq);
    for (int j = 0; j < NQ; ++j) {
      xs_out[(b * H + h) * N + j] = q[j];
      xs_out[(b * H + h) * N + NQ + j] = v[j];
    }
    for (int i = 0; i < nu; ++i) us_out[(b * H + h) * nu + i] = u[i];
  }
}

// threads = 1 or 4: the team rollout; threads = 0: the serial rollout
extern "C" int host_rollout_feedback(int threads, int nq, int T, const float* mf, const int* mi,
    double dt, int n_sub, int B, int H, const float* alphas, const float* x0,
    const float* cube0, const float* xs_nom, const float* us_nom, const float* ks,
    const float* Ks, const float* lo, const float* hi, float* xs, float* us) {
  using namespace kmanip;
  const StepConsts c = make_consts(dt);
#define KMANIP_FEEDBACK(NQ_, T_)                                                              \
  if (nq == NQ_ && T == T_) {                                                                 \
    if (threads == 0) {                                                                       \
      ModelView<NQ_, T_> m{mf, mi};                                                           \
      for (int b = 0; b < B; ++b)                                                             \
        feedback_serial<NQ_, T_>(b, m, c, n_sub, H, alphas, x0, cube0, xs_nom, us_nom, ks,    \
                                 Ks, lo, hi, xs, us);                                         \
      return 0;                                                                               \
    }                                                                                         \
    if (threads == 1)                                                                         \
      feedback_team<NQ_, T_, 1>(mf, mi, c, n_sub, B, H, alphas, x0, xs_nom, us_nom, ks, Ks,   \
                                lo, hi, xs, us);                                              \
    else if (threads == 4)                                                                    \
      feedback_team<NQ_, T_, 4>(mf, mi, c, n_sub, B, H, alphas, x0, xs_nom, us_nom, ks, Ks,   \
                                lo, hi, xs, us);                                              \
    else                                                                                      \
      return -1;                                                                              \
    return 0;                                                                                 \
  }
  KMANIP_FEEDBACK(10, 2)
  KMANIP_FEEDBACK(20, 4)
#undef KMANIP_FEEDBACK
  return -1;
}

// contacts.cube_table's `touching` of each of K cubes (13 floats each)
extern "C" void host_cube_on_table(int K, const float* cube13, bool* out) {
  for (int k = 0; k < K; ++k) out[k] = kmanip::cube_on_table(kmanip::cube_from(cube13 + 13 * k));
}

// The contacts a serial pick rollout over substep_core makes: the number
// of (rollout, control step) pairs with a fingertip on the cube, and with
// the post-step cube on the table.
extern "C" int host_pick_contacts(int nq, int T, const float* mf, const int* mi, double dt,
    int implicit, int n_substeps, int K, int H, const float* ctrl_seqs, const float* state0,
    int* n_touch, int* n_table) {
  using namespace kmanip;
  const StepConsts c = make_consts(dt);
  *n_touch = *n_table = 0;
  auto run = [&](auto n, auto t) {
    constexpr int NQ = decltype(n)::value, TT = decltype(t)::value;
    const ModelView<NQ, TT> m{mf, mi};
    const int nu = m.nu();
    for (int k = 0; k < K; ++k) {
      float q[NQ], v[NQ], u[NQ];
      for (int i = 0; i < NQ; ++i) {
        q[i] = state0[i];
        v[i] = state0[NQ + i];
        u[i] = 0.f;
      }
      Cube cube = cube_from(state0 + 2 * NQ);
      bool touch[TT];
      V3 x[NQ];
      Q4 qq[NQ];
      for (int h = 0; h < H; ++h) {
        for (int i = 0; i < nu; ++i) u[i] = ctrl_seqs[(k * H + h) * nu + i];
        for (int s = 0; s < n_substeps; ++s)
          substep_core<NQ, TT>(m, c, true, implicit, q, v, u, cube, touch, x, qq);
        bool any = false;
        for (int i = 0; i < TT; ++i) any = any || touch[i];
        *n_touch += any;
        *n_table += cube_on_table(cube);
      }
    }
  };
  if (nq == 10 && T == 2) run(IC<10>{}, IC<2>{});
  else if (nq == 20 && T == 4) run(IC<20>{}, IC<4>{});
  else return -1;
  return 0;
}

// K4: the sweep's block code on S threads, which form one team
template <int NT, int MT, int TR, int TC, int S>
void riccati_host(int H, int n, int m, float reg, float lam_extra, const float* A,
                  const float* B, const float* cx, const float* cu, const float* cxx,
                  const float* cuu, const float* cux, const float* VxT, const float* VxxT,
                  float* ks, float* Ks) {
  std::vector<float> sm(kmanip::riccati_layout(n, m).total);
  float slot[S];
  run_team<S>([&](int tid, pthread_barrier_t* bar) {
    kmanip::riccati_sweep_block<NT, MT, TR, TC>(tid, S, HostTeam<S>{tid, bar, slot},
                                                HostBarrier{bar}, H, n, m, reg, lam_extra, A,
                                                B, cx, cu, cxx, cuu, cux, VxT, VxxT, ks, Ks,
                                                sm.data());
  });
}

template <int S>
void riccati_widths(int H, int n, int m, float reg, float lam_extra, const float* A,
                    const float* B, const float* cx, const float* cu, const float* cxx,
                    const float* cuu, const float* cux, const float* VxT, const float* VxxT,
                    float* ks, float* Ks) {
  if (n == 20 && m == 10)  // the kernel's instantiations (csrc/riccati.cu)
    riccati_host<20, 10, 2, 2, S>(H, n, m, reg, lam_extra, A, B, cx, cu, cxx, cuu, cux, VxT,
                                  VxxT, ks, Ks);
  else if (n == 40 && m == 20)
    riccati_host<40, 20, 4, 2, S>(H, n, m, reg, lam_extra, A, B, cx, cu, cxx, cuu, cux, VxT,
                                  VxxT, ks, Ks);
  else
    riccati_host<0, 0, 2, 2, S>(H, n, m, reg, lam_extra, A, B, cx, cu, cxx, cuu, cux, VxT,
                                VxxT, ks, Ks);
}

extern "C" int host_riccati(int threads, int H, int n, int m, double reg, float lam_extra,
    const float* A, const float* B, const float* cx, const float* cu, const float* cxx,
    const float* cuu, const float* cux, const float* VxT, const float* VxxT, float* ks,
    float* Ks) {
  if (threads == 1)
    riccati_widths<1>(H, n, m, (float)reg, lam_extra, A, B, cx, cu, cxx, cuu, cux, VxT, VxxT,
                      ks, Ks);
  else if (threads == 4)
    riccati_widths<4>(H, n, m, (float)reg, lam_extra, A, B, cx, cu, cxx, cuu, cux, VxT, VxxT,
                      ks, Ks);
  else
    return -1;
  return 0;
}

// the factor and both substitutions alone, one thread
extern "C" void host_chol_solve(int m, int r, const float* Q, float lam, const float* RHS,
    float* X) {
  std::vector<float> S(m * m), dsc(m), inv(m), keep(m);
  const HostTeam<1> team{0, nullptr, nullptr};
  using kmanip::RICCATI_MAX_M;
  using kmanip::SOLVE_COLS;
  kmanip::team_factor<RICCATI_MAX_M>(team, m, Q, lam, S.data(), dsc.data(), inv.data(),
                                     keep.data());
  for (int c0 = 0; c0 < r; c0 += SOLVE_COLS)
    kmanip::team_solve_cols<RICCATI_MAX_M>(team, m, c0, r - c0 < SOLVE_COLS ? r - c0 : SOLVE_COLS,
                                           RHS, X, r, 1.f, S.data(), dsc.data(), inv.data(),
                                           keep.data(), [](int, const float(&)[SOLVE_COLS]) {});
}

// the staged route's per-item kernels (csrc/staged.cuh), item by item
extern "C" int host_rnea(int nq, int T, const float* mf, const int* mi, int K, const float* q,
    const float* v, float* xpos, float* xquat, float* axis, float* bias) {
  using namespace kmanip;
  if (nq == 10 && T == 2) {
    ModelView<10, 2> m{mf, mi};
    for (int k = 0; k < K; ++k) rnea_item<10, 2>(k, m, q, v, xpos, xquat, axis, bias);
    return 0;
  }
  if (nq == 20 && T == 4) {
    ModelView<20, 4> m{mf, mi};
    for (int k = 0; k < K; ++k) rnea_item<20, 4>(k, m, q, v, xpos, xquat, axis, bias);
    return 0;
  }
  return -1;
}

extern "C" int host_contacts(int nq, int T, const float* mf, const int* mi, int K,
    const float* tp, const float* tv, const float* cp, const float* cq, const float* cl,
    const float* ca, float* force, float* torque, float* tip_forces, bool* touch_tip,
    bool* touch_table) {
  using namespace kmanip;
  if (nq == 10 && T == 2) {
    ModelView<10, 2> m{mf, mi};
    for (int k = 0; k < K; ++k)
      contacts_item<10, 2>(k, m, tp, tv, cp, cq, cl, ca, force, torque, tip_forces, touch_tip,
                           touch_table);
    return 0;
  }
  if (nq == 20 && T == 4) {
    ModelView<20, 4> m{mf, mi};
    for (int k = 0; k < K; ++k)
      contacts_item<20, 4>(k, m, tp, tv, cp, cq, cl, ca, force, torque, tip_forces, touch_tip,
                           touch_table);
    return 0;
  }
  return -1;
}

extern "C" int host_spd_solve(int n, int K, const float* M, const float* b, float* x) {
  using namespace kmanip;
  for (int k = 0; k < K; ++k) {
    if (n == 6) chol_solve_item<6>(k, M, b, x);
    else if (n == 10) chol_solve_item<10>(k, M, b, x);
    else if (n == 20) chol_solve_item<20>(k, M, b, x);
    else if (n == 24) chol_solve_item<24>(k, M, b, x);
    else return -1;
  }
  return 0;
}

// K7's team solve (csrc/staged_team.cuh), item by item, on one thread or
// on the kernel's team width (16 threads for n <= 16, 32 above) behind a
// barrier
template <int N, int S>
void chol_team_host(int K, const float* M, const float* b, float* x) {
  std::vector<float> L(kmanip::chol_scratch<N>());
  float slot[S];
  for (int k = 0; k < K; ++k)
    run_team<S>([&](int lane, pthread_barrier_t* bar) {
      kmanip::chol_solve_team<N>(HostTeam<S>{lane, bar, slot}, M + (long)k * N * N,
                                 b + (long)k * N, L.data(), x + (long)k * N, true);
    });
}

extern "C" int host_chol_solve_team(int threads, int n, int K, const float* M, const float* b,
    float* x) {
  auto widths = [&](auto nn) {
    constexpr int N = decltype(nn)::value, S = N <= 16 ? 16 : 32;
    if (threads == 1) chol_team_host<N, 1>(K, M, b, x);
    else if (threads == S) chol_team_host<N, S>(K, M, b, x);
    else return -1;
    return 0;
  };
  if (n == 6) return widths(IC<6>{});
  if (n == 10) return widths(IC<10>{});
  if (n == 20) return widths(IC<20>{});
  if (n == 24) return widths(IC<24>{});
  return -1;
}

""", r"""extern "C" int host_substep_team(int threads, int nq, int T, const float* mf, const int* mi,
    double dt, int contact, int implicit, int K, const float* qpos, const float* qvel,
    const float* ctrl, const float* cube13, float* qo, float* vo, float* co, bool* touch,
    float* xp, float* xq) {
  using namespace kmanip;
  const StepConsts c = make_consts(dt);
  return with_team(threads, nq, T, contact, implicit, [&](auto n, auto t, auto ct, auto im,
                                                          auto s) {
    constexpr int NQ = decltype(n)::value, TT = decltype(t)::value, S = decltype(s)::value;
    std::vector<TeamModel<NQ, TT>> M(1);
    std::vector<TeamWork<NQ, TT>> w(1);
    float slot[S];
    run_team<S>([&](int lane, pthread_barrier_t* bar) {
      const HostTeam<S> team{lane, bar, slot};
      team_model_load(M[0], lane, S, mf, mi, c, (bool)decltype(im)::value,
                      [&] { team.sync(); });
      for (int k = 0; k < K; ++k)
        substep_team_row<NQ, TT, (bool)decltype(ct)::value, (bool)decltype(im)::value>(
            team, M[0], w[0], c, k, true, qpos, qvel, ctrl, cube13, qo, vo, co, touch, xp, xq);
    });
  });
}

// K5's team FK + RNEA (csrc/staged_team.cuh) on 1, 4 or 32 threads (the
// kernel's warp) behind a barrier, the team running the batch's rows one
// after another
extern "C" int host_rnea_team(int threads, int nq, int T, const float* mf, const int* mi, int K,
    const float* q, const float* v, float* xpos, float* xquat, float* axis, float* bias) {
  using namespace kmanip;
  if (nq != HOST_NQ || T != (HOST_NQ == 10 ? 2 : 4)) return -1;
  auto run = [&](auto s) {
    constexpr int S = decltype(s)::value;
    std::vector<TreeModel<HOST_NQ>> M(1);
    std::vector<TreeWork<HOST_NQ>> w(1);
    float slot[S];
    run_team<S>([&](int lane, pthread_barrier_t* bar) {
      const HostTeam<S> team{lane, bar, slot};
      tree_model_load(M[0], lane, S, mf, mi, [&] { team.sync(); });
      for (int k = 0; k < K; ++k)
        rnea_team_row<HOST_NQ>(team, M[0], w[0], k, true, q, v, xpos, xquat, axis, bias);
    });
  };
  if (threads == 1) run(IC<1>{});
  else if (threads == 4) run(IC<4>{});
  else if (threads == 32) run(IC<32>{});
  else return -1;
  return 0;
}

""", r"""extern "C" int host_rollout_pick_team(int threads, int nq, int T, const float* mf,
    const int* mi, double dt, int contact, int implicit, int n_substeps, int K, int H,
    const float* spec_f, const int* spec_i, const float* ctrl_seqs, const float* state0,
    float* cost) {
  using namespace kmanip;
  const StepConsts c = make_consts(dt);
  const PickSpec spec = make_pick_spec(spec_f, spec_i);
  return with_team(threads, nq, T, contact, implicit, [&](auto n, auto t, auto ct, auto im,
                                                          auto s) {
    constexpr int NQ = decltype(n)::value, TT = decltype(t)::value, S = decltype(s)::value;
    std::vector<TeamModel<NQ, TT>> M(1);
    std::vector<TeamWork<NQ, TT>> w(1);
    std::vector<float> stage(2 * NQ);
    float slot[S];
    run_team<S>([&](int lane, pthread_barrier_t* bar) {
      const HostTeam<S> team{lane, bar, slot};
      team_model_load(M[0], lane, S, mf, mi, c, (bool)decltype(im)::value,
                      [&] { team.sync(); });
      const long nu = ModelView<NQ, TT>{M[0].mf, M[0].mi}.nu();
      for (int k = 0; k < K; ++k) {
        const float total =
            rollout_pick_team<NQ, TT, (bool)decltype(ct)::value, (bool)decltype(im)::value>(
                team, M[0], w[0], stage.data(), c, n_substeps, H, spec,
                ctrl_seqs + k * H * nu, state0);
        if (lane == 0) cost[k] = total;
      }
    });
  });
}

""", r"""// K6's team contact model (csrc/staged_team.cuh): the kernel's blocks of
// `items` teams of S threads, one block after another, each team behind a
// barrier of its own and the block behind one more
template <int NQ, int TT, int S>
void contacts_team_host(int items, const float* mf, int K, const float* const* in,
                        float* force, float* torque, float* tip_forces, bool* touch_tip,
                        bool* touch_table) {
  using namespace kmanip;
  const int nthr = S * items, n_blocks = (K + items - 1) / items;
  std::vector<float> stage(contact_stage_floats<TT>(items)), slots(nthr);
  std::vector<ContactWork<TT>> work(items);
  std::vector<pthread_barrier_t> team_bar(items);
  pthread_barrier_t block_bar;
  for (auto& b : team_bar) pthread_barrier_init(&b, nullptr, S);
  pthread_barrier_init(&block_bar, nullptr, nthr);
  std::vector<std::thread> threads;
  for (int tid = 0; tid < nthr; ++tid)
    threads.emplace_back([&, tid] {
      const HostTeam<S> team{tid % S, S > 1 ? &team_bar[tid / S] : nullptr,
                             slots.data() + (tid / S) * S};
      const HostBarrier sync{nthr > 1 ? &block_bar : nullptr};
      for (int b = 0; b < n_blocks; ++b) {
        contacts_block<TT>(tid, nthr, team, sync, items, (long)b * items, K,
                           mf + ModelView<NQ, TT>::F_TIPRAD, stage.data(), work.data(), in[0],
                           in[1], in[2], in[3], in[4], in[5], force, torque, tip_forces,
                           touch_tip, touch_table);
        sync();  // the stage and the teams' work are the next block's
      }
    });
  for (auto& th : threads) th.join();
  for (auto& b : team_bar) pthread_barrier_destroy(&b);
  pthread_barrier_destroy(&block_bar);
}

extern "C" int host_contacts_team(int threads, int items, int nq, int T, const float* mf, int K,
    const float* tp, const float* tv, const float* cp, const float* cq, const float* cl,
    const float* ca, float* force, float* torque, float* tip_forces, bool* touch_tip,
    bool* touch_table) {
  const float* in[6] = {tp, tv, cp, cq, cl, ca};
  auto widths = [&](auto n, auto t) {
    constexpr int NQ = decltype(n)::value, TT = decltype(t)::value;
    if (threads == 1) contacts_team_host<NQ, TT, 1>(items, mf, K, in, force, torque, tip_forces,
                                                    touch_tip, touch_table);
    else if (threads == 4) contacts_team_host<NQ, TT, 4>(items, mf, K, in, force, torque,
                                                         tip_forces, touch_tip, touch_table);
    else if (threads == 16) contacts_team_host<NQ, TT, 16>(items, mf, K, in, force, torque,
                                                           tip_forces, touch_tip, touch_table);
    else if (threads == 32) contacts_team_host<NQ, TT, 32>(items, mf, K, in, force, torque,
                                                           tip_forces, touch_tip, touch_table);
    else return -1;
    return 0;
  };
  if (nq == 10 && T == 2) return widths(IC<10>{}, IC<2>{});
  if (nq == 20 && T == 4) return widths(IC<20>{}, IC<4>{});
  return -1;
}

// K8: the floor experiment's block code (csrc/sweep_floor.cuh) at the
// experiment's widths, on S threads that form one team, as K4's
template <int VAR, int S>
void floor_host(int H, const float* const* in, float* ks, float* Ks) {
  std::vector<float> sm(kmanip::riccati_layout(40, 20).total);
  float slot[S];
  run_team<S>([&](int tid, pthread_barrier_t* bar) {
    kmanip::sweep_floor_block<VAR, 40, 20, 4, 2>(tid, S, HostTeam<S>{tid, bar, slot},
                                                 HostBarrier{bar}, H, 40, 20, in[0], in[1],
                                                 in[2], in[3], in[4], in[5], in[6], ks, Ks,
                                                 sm.data());
  });
}

template <int VAR>
int floor_variant(int variant, int threads, int H, const float* const* in, float* ks,
                  float* Ks) {
  if constexpr (VAR >= kmanip::FLOOR_N_VARIANTS) {
    return -1;
  } else {
    if (variant != VAR) return floor_variant<VAR + 1>(variant, threads, H, in, ks, Ks);
    if (threads == 1) floor_host<VAR, 1>(H, in, ks, Ks);
    else if (threads == 4) floor_host<VAR, 4>(H, in, ks, Ks);
    else if (VAR == kmanip::FLOOR_GERSH && threads == 32) floor_host<VAR, 32>(H, in, ks, Ks);
    else return -1;
    return 0;
  }
}

// threads = 1 or 4, or 32 for gersh (its lift reduces over a warp)
extern "C" int host_sweep_floor(int threads, int variant, int H, int n, int m, const float* AB,
    const float* cx, const float* cu, const float* cxx, const float* cuu, const float* cux,
    const float* WT, float* ks, float* Ks) {
  if (n != 40 || m != 20) return -1;
  const float* in[7] = {AB, cx, cu, cxx, cuu, cux, WT};
  return floor_variant<0>(variant, threads, H, in, ks, Ks);
}

""")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The CUDA kernels' device code (csrc/*.cuh) compiled as host C++, so
    its arithmetic is checked on a machine without a GPU: the harness's
    three parts, one g++ each, all started together, their functions on one
    object."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the kernel source for the host")
    d = tmp_path_factory.mktemp("host_kernel")
    base, k1, k2, k8 = _HOST_HARNESS
    # the team parts once per model, their entry points named host_*_team_<nq>;
    # K2's at solo width also on 16 threads, its half-warp team's width
    parts = [_HOST_PRELUDE + base, _HOST_PRELUDE + k8] + [
        f"#define HOST_NQ {nq}\n" + ("#define HOST_HALF_WARP\n" if part is k2 and nq == 10
                                     else "") + _HOST_PRELUDE
        + re.sub(r"(host_\w+_team)\(", rf"\1_{nq}(", part)
        for nq in (10, 20) for part in (k1, k2)]
    procs, libs = [], []
    for i, part in enumerate(parts):
        src, lib = d / f"host_part{i}.cpp", d / f"host_part{i}.so"
        src.write_text(part)
        procs.append(subprocess.Popen(
            [cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-I", substep_cuda._build.CSRC_DIR, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        libs.append(lib)
    for proc in procs:
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
    names = re.findall(r'extern "C" \w+ (host_\w+)\(', "".join(parts))
    so = types.SimpleNamespace(**{
        name: getattr(lib, name) for lib in map(ctypes.CDLL, map(str, libs))
        for name in names if hasattr(lib, name)})
    P = ctypes.c_void_p
    so.host_substep.argtypes = [ctypes.c_int] * 2 + [P] * 2 + [
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int
    ] + [P] * 10
    so.host_substep.restype = ctypes.c_int
    for nq in (10, 20):
        f = getattr(so, f"host_substep_team_{nq}")
        f.argtypes = [ctypes.c_int] * 3 + [P] * 2 + [
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [P] * 10
        f.restype = ctypes.c_int
        f = getattr(so, f"host_rollout_pick_team_{nq}")
        f.argtypes = [ctypes.c_int] * 3 + [P] * 2 + [ctypes.c_double] + [ctypes.c_int] * 5 + [
            P] * 5
        f.restype = ctypes.c_int
        f = getattr(so, f"host_rnea_team_{nq}")
        f.argtypes = [ctypes.c_int] * 3 + [P] * 2 + [ctypes.c_int] + [P] * 6
        f.restype = ctypes.c_int
    # (threads, nq, ...) -> the model's build
    so.host_substep_team = lambda threads, nq, *a: getattr(so, f"host_substep_team_{nq}")(
        threads, nq, *a)
    so.host_rnea_team = lambda threads, nq, *a: getattr(so, f"host_rnea_team_{nq}")(
        threads, nq, *a)
    so.host_rollout_pick_team = lambda threads, nq, *a: getattr(
        so, f"host_rollout_pick_team_{nq}")(threads, nq, *a)
    so.host_pick_contacts.argtypes = [ctypes.c_int] * 2 + [P] * 2 + [ctypes.c_double] + [
        ctypes.c_int] * 4 + [P] * 4
    so.host_pick_contacts.restype = ctypes.c_int
    so.host_cube_on_table.argtypes = [ctypes.c_int, P, P]
    so.host_cube_on_table.restype = None
    so.host_rollout_pick.argtypes = [ctypes.c_int] * 2 + [P] * 2 + [ctypes.c_double] + [
        ctypes.c_int] * 5 + [P] * 5
    so.host_rollout_pick.restype = ctypes.c_int
    so.host_rollout_feedback.argtypes = [ctypes.c_int] * 3 + [P] * 2 + [ctypes.c_double] + [
        ctypes.c_int] * 3 + [P] * 11
    so.host_rollout_feedback.restype = ctypes.c_int
    so.host_riccati.argtypes = [ctypes.c_int] * 4 + [ctypes.c_double, ctypes.c_float] + [P] * 11
    so.host_riccati.restype = ctypes.c_int
    so.host_chol_solve.argtypes = [ctypes.c_int] * 2 + [P, ctypes.c_float, P, P]
    so.host_chol_solve.restype = None
    so.host_rnea.argtypes = [ctypes.c_int] * 2 + [P] * 2 + [ctypes.c_int] + [P] * 6
    so.host_rnea.restype = ctypes.c_int
    so.host_contacts.argtypes = [ctypes.c_int] * 2 + [P] * 2 + [ctypes.c_int] + [P] * 11
    so.host_contacts.restype = ctypes.c_int
    so.host_spd_solve.argtypes = [ctypes.c_int] * 2 + [P] * 3
    so.host_spd_solve.restype = ctypes.c_int
    so.host_chol_solve_team.argtypes = [ctypes.c_int] * 3 + [P] * 3
    so.host_chol_solve_team.restype = ctypes.c_int
    so.host_contacts_team.argtypes = [ctypes.c_int] * 4 + [P, ctypes.c_int] + [P] * 11
    so.host_contacts_team.restype = ctypes.c_int
    so.host_sweep_floor.argtypes = [ctypes.c_int] * 5 + [P] * 9
    so.host_sweep_floor.restype = ctypes.c_int
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
    rollout (K3, csrc/feedback_warp.cuh) at B=6, H=8 on one thread and on a
    team of four threads behind a barrier: bit for bit the serial rollout
    over substep_core (every sum keeps its order; also with two substeps
    per control step), against
    `rollout_feedback_reference` (us 2e-5 / 1e-4, xs 5e-4 / 1e-3,
    tests/test_pallas.py:377-380) and, as on the card, no farther from the
    float64 plain rollout than twice the float32 plain version."""
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

    # the inputs of tests/test_torch_cuda.py's K3 test, and its float64 witness
    n, B, H = 2 * nq, 6, 8
    rng = np.random.RandomState(5)
    t = model_tensors(m, "cpu")
    x0 = start[:n].copy()
    cube0 = start[n:].copy()
    xs_nom = (x0[None] + (0.02 * rng.randn(H, n)).astype(np.float32)).astype(np.float32)
    us_nom = (m.home_qpos[:nu] + 0.05 * rng.randn(H, nu)).astype(np.float32)
    ks = (0.03 * rng.randn(H, nu)).astype(np.float32)
    Ks = (0.05 * rng.randn(H, nu, n)).astype(np.float32)
    alphas = np.array([1.0, 0.6, 0.3, 0.1, 0.03, 0.01], np.float32)
    lo, hi = t.ctrl_lo.numpy(), t.ctrl_hi.numpy()
    runs = {}
    for threads in (0, 1, 4):  # 0: the serial rollout over substep_core
        xs = np.zeros((B, H, n), np.float32)
        us = np.zeros((B, H, nu), np.float32)
        assert host_kernel.host_rollout_feedback(
            threads, nq, T, _ptr(mf), _ptr(mi), 0.02, 1, B, H, *(_ptr(a) for a in (
                alphas, x0, cube0, xs_nom, us_nom, ks, Ks, lo, hi, xs, us))) == 0
        runs[threads] = xs, us
    for threads in (1, 4):
        for got, want in zip(runs[threads], runs[0]):
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                          err_msg=f"{threads} thread(s) vs serial")
    xs, us = runs[4]
    # two substeps per control step, also bit for bit
    twice = [[np.zeros((B, H, n), np.float32), np.zeros((B, H, nu), np.float32)]
             for _ in range(2)]
    for threads, out in zip((0, 4), twice):
        assert host_kernel.host_rollout_feedback(
            threads, nq, T, _ptr(mf), _ptr(mi), 0.01, 2, B, H, *(_ptr(a) for a in (
                alphas, x0, cube0, xs_nom, us_nom, ks, Ks, lo, hi, *out))) == 0
    for got, want in zip(*twice):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    args = [torch.as_tensor(a) for a in (x0, cube0, xs_nom, us_nom, ks, Ks, alphas)]
    wxs, wus = rollout_feedback_cuda.rollout_feedback_reference(m, *args)
    with pytest.MonkeyPatch.context() as mp:
        _, us64 = rollout_feedback_cuda.rollout_feedback_reference(
            float64_twin(m, "cpu", mp), *(a.double() for a in args))
    _, us_ulp = rollout_feedback_cuda.rollout_feedback_reference(
        m, args[0] * (1 + 2.0 ** -23), *args[1:])
    kernel64, plain64 = (float(np.abs(u.astype(np.float64) - us64.numpy()).max())
                         for u in (us, wus.numpy()))
    print(f"{name}: us from float64: host kernel {kernel64:.3e}, plain {plain64:.3e}; one ulp "
          f"of x0 moves the plain us by {float((us_ulp - wus).abs().max()):.3e}")
    assert kernel64 <= 2 * plain64
    np.testing.assert_allclose(us, wus.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(xs, wxs.numpy(), atol=5e-4, rtol=1e-3)


def _host_substep(host_kernel, threads, m, dt, contact, implicit, inputs):
    """One substep of the batch `inputs` on the host build: threads = 0 the
    serial substep_rollout, 1 or 4 the team substep on that many threads."""
    K, nq, T = inputs[0].shape[0], m.nq, len(m.fingertips)
    mf, mi = substep_cuda.pack_model(m)
    out = [np.zeros((K, nq), np.float32), np.zeros((K, nq), np.float32),
           np.zeros((K, 13), np.float32), np.zeros((K, T), bool),
           np.zeros((K, nq, 3), np.float32), np.zeros((K, nq, 4), np.float32)]
    args = (nq, T, _ptr(mf), _ptr(mi), dt, int(contact), int(implicit), K,
            *(_ptr(a) for a in inputs), *(_ptr(o) for o in out))
    rc = (host_kernel.host_substep(*args) if threads == 0
          else host_kernel.host_substep_team(threads, *args))
    assert rc == 0
    return out


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
@pytest.mark.parametrize("dt,implicit", MODES)
@pytest.mark.parametrize("contact", [True, False])
def test_substep_team_matches_serial_on_host(host_kernel, name, dt, implicit, contact):
    """K1's team substep (csrc/substep_team.cuh) on one thread and on a team
    of four threads behind a barrier: bit for bit the serial substep_rollout
    over substep_core, every output. The seeded inputs put fingertips on
    the cube (even rows) and the cube on the table (odd rows), so the tip
    and corner lanes of the contact model run."""
    m = from_numpy_model(jax_get_model(name))
    inputs = substep_cuda.random_inputs(m, 16, seed=7)
    serial = _host_substep(host_kernel, 0, m, dt, contact, implicit, inputs)
    on_table = np.zeros(16, bool)
    host_kernel.host_cube_on_table(16, _ptr(inputs[3]), _ptr(on_table))
    assert on_table.any() and not on_table.all()
    assert serial[3].any() == contact
    for threads in (1, 4):
        team = _host_substep(host_kernel, threads, m, dt, contact, implicit, inputs)
        for name_, got, want in zip(("qpos", "qvel", "cube13", "touch", "xpos", "xquat"),
                                    team, serial):
            np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                          err_msg=f"{name_}, {threads} thread(s)")


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
@pytest.mark.parametrize("dt,implicit", MODES)
def test_rollout_pick_team_matches_serial_on_host(host_kernel, name, dt, implicit):
    """K2's team rollout (csrc/rollout.cuh) at H=8 with contact, on one
    thread and on a team of four threads behind a barrier, and at solo width
    on sixteen (the half-warp team's layout): bit for bit the serial
    rollout_pick_thread's totals (at dt=0.002 two substeps per control
    step), from two start states: the cube at rest on the table, and the
    cube at the first fingertip. The serial rollouts have the cube on the
    table and a fingertip on it at some steps."""
    m = from_numpy_model(jax_get_model(name))
    nq, nu, T = m.nq, m.nu, len(m.fingertips)
    mf, mi = substep_cuda.pack_model(m)
    home = torch.as_tensor(m.home_qpos, dtype=torch.float32)
    tip0 = engine._tips_from_frames(m, *kin.fk(m, home)[:2])[0].numpy()
    K, H, n_sub = 8, 8, 1 if dt == 0.02 else 2
    rng = np.random.RandomState(9)
    U = (m.home_qpos[:nu] + 0.1 * rng.randn(K, H, nu)).astype(np.float32)
    spec_f, spec_i = rollout_pick_cuda.spec_arrays(
        m, rollout_pick_cuda.PickCostSpec(use_left=T > 2))
    touched = on_table = 0
    for cube_pos in (np.array([0.25, 0.5, 0.62]), tip0):
        s0 = init_state(m, cube_pos=cube_pos, device="cpu")
        start = torch.cat([s0.qpos, s0.qvel, s0.cube_pos, s0.cube_quat, s0.cube_linvel,
                           s0.cube_angvel]).numpy()
        n_touch, n_table = ctypes.c_int(), ctypes.c_int()
        assert host_kernel.host_pick_contacts(
            nq, T, _ptr(mf), _ptr(mi), dt, int(implicit), n_sub, K, H, _ptr(U), _ptr(start),
            ctypes.byref(n_touch), ctypes.byref(n_table)) == 0
        touched += n_touch.value
        on_table += n_table.value
        costs = {}
        widths = (1, 4, 16) if nq <= 16 else (1, 4)
        for threads in (0,) + widths:
            cost = np.zeros(K, np.float32)
            args = (nq, T, _ptr(mf), _ptr(mi), dt, 1, int(implicit), n_sub, K, H,
                    _ptr(spec_f), _ptr(spec_i), _ptr(U), _ptr(start), _ptr(cost))
            rc = (host_kernel.host_rollout_pick(*args) if threads == 0
                  else host_kernel.host_rollout_pick_team(threads, *args))
            assert rc == 0 and np.isfinite(cost).all()
            costs[threads] = cost
        for threads in widths:
            np.testing.assert_array_equal(costs[threads].view(np.uint32),
                                          costs[0].view(np.uint32),
                                          err_msg=f"{threads} thread(s) vs serial")
    assert touched > 0 and on_table > 0, (touched, on_table)


@pytest.mark.parametrize("H,n,m,indefinite", [(5, 20, 10, False), (3, 40, 20, False),
                                              (6, 7, 3, True)])
@pytest.mark.parametrize("lam_extra", [0.0, 1e-3])
@pytest.mark.parametrize("threads", [1, 4])
def test_riccati_kernel_source_matches_plain_on_host(host_kernel, H, n, m, indefinite,
                                                     lam_extra, threads):
    """csrc/riccati.cuh against `riccati_sweep_reference`, at the kernel's
    two instantiated widths and through its runtime-width code (n=7, m=3),
    on one thread with a no-op barrier and on four threads behind a barrier
    (a missing barrier or a bad partition shows there): both float32,
    summed in other orders, held at 1e-4 of the largest gain (each is
    within ~1e-5 of float64)."""
    prob = riccati_cuda.random_problem(4, H, n, m, indefinite)
    ks = np.zeros((H, m), np.float32)
    Ks = np.zeros((H, m, n), np.float32)
    assert host_kernel.host_riccati(threads, H, n, m, 1e-6, lam_extra,
                                    *(_ptr(a) for a in prob), _ptr(ks), _ptr(Ks)) == 0
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


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_staged_kernel_sources_match_plain_on_host(host_kernel, name):
    """csrc/staged.cuh on the host: the FK + RNEA item (K5) against
    `rnea_terms` (frames 1e-5, bias 1e-4) and the contact item (K6) against
    `contact_forces` (1e-4, flags equal), on seeded states with contact."""
    m = from_numpy_model(jax_get_model(name))
    K, nq, T = 64, m.nq, len(m.fingertips)
    q, v, _, cube = substep_cuda.random_inputs(m, K, seed=7)
    mf, mi = substep_cuda.pack_model(m)
    out = [np.zeros((K, nq, 3), np.float32), np.zeros((K, nq, 4), np.float32),
           np.zeros((K, nq, 3), np.float32), np.zeros((K, nq), np.float32)]
    assert host_kernel.host_rnea(nq, T, _ptr(mf), _ptr(mi), K, _ptr(q), _ptr(v),
                                 *(_ptr(o) for o in out)) == 0
    want = kin.rnea_terms(m, _t(q), _t(v))
    for g, w, tol in zip(out, want, (1e-5, 1e-5, 1e-5, 1e-4)):
        _close(g, w.numpy(), tol)

    tips, tip_vel, _, rad = engine._tip_state(m, *want[:3], _t(v))
    args = [a.contiguous().numpy() for a in (tips, tip_vel)] + [
        np.ascontiguousarray(cube[:, a:b]) for a, b in ((0, 3), (3, 7), (7, 10), (10, 13))]
    got = [np.zeros((K, 3), np.float32), np.zeros((K, 3), np.float32),
           np.zeros((K, T, 3), np.float32), np.zeros((K, T), bool), np.zeros(K, bool)]
    assert host_kernel.host_contacts(nq, T, _ptr(mf), _ptr(mi), K, *(_ptr(a) for a in args),
                                     *(_ptr(o) for o in got)) == 0
    want = contacts.contact_forces(tips, tip_vel, rad, *(_t(a) for a in args[2:]))
    assert want.touch_tip.any() and want.touch_table.any()
    for g, w in zip(got, want):
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w.numpy())
        else:
            _close(g, w.numpy(), 1e-4)


@pytest.mark.parametrize("n", [6, 10, 20])
def test_spd_solve_kernel_source_matches_plain_on_host(host_kernel, n):
    """csrc/staged.cuh's SPD solve item (K7) on the host against
    `cholesky_solve_unrolled` and float64: 1e-4 of the largest entry; NaN
    for a matrix that is not positive definite."""
    K = 16
    rng = np.random.RandomState(n)
    A = rng.randn(K, n, n)
    M = (A @ A.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)
    M[-1] = np.eye(n, dtype=np.float32)
    M[-1, 1, 1] = -1.0
    b = rng.randn(K, n).astype(np.float32)
    x = np.zeros((K, n), np.float32)
    assert host_kernel.host_spd_solve(n, K, _ptr(M), _ptr(b), _ptr(x)) == 0
    want = linalg.cholesky_solve_unrolled(_t(M), _t(b)).numpy()
    want64 = np.linalg.solve(M[:-1].astype(np.float64), b[:-1, :, None].astype(np.float64))[..., 0]
    scale = np.abs(want64).max()
    _close(x[:-1], want[:-1], 1e-4 * scale)
    _close(x[:-1], want64, 1e-4 * scale)
    assert np.isnan(x[-1]).all() and np.isnan(want[-1]).all()


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_rnea_team_matches_serial_on_host(host_kernel, name):
    """K5's team FK + RNEA (csrc/staged_team.cuh) on one thread, on four
    and on 32 (the kernel's warp) behind a barrier: bit for bit the serial
    rnea_item, every output, on seeded states."""
    m = from_numpy_model(jax_get_model(name))
    K, nq, T = 16, m.nq, len(m.fingertips)
    q, v, _, _ = substep_cuda.random_inputs(m, K, seed=7)
    mf, mi = substep_cuda.pack_model(m)

    def run(fn, *threads):
        out = [np.zeros((K, nq, 3), np.float32), np.zeros((K, nq, 4), np.float32),
               np.zeros((K, nq, 3), np.float32), np.zeros((K, nq), np.float32)]
        assert fn(*threads, nq, T, _ptr(mf), _ptr(mi), K, _ptr(q), _ptr(v),
                  *(_ptr(o) for o in out)) == 0
        return out

    serial = run(host_kernel.host_rnea)
    for threads in (1, 4, 32):
        for name_, got, want in zip(("xpos", "xquat", "axis", "bias"),
                                    run(host_kernel.host_rnea_team, threads), serial):
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                          err_msg=f"{name_}, {threads} thread(s)")


@pytest.mark.parametrize("n", [6, 10, 20, 24])
def test_spd_solve_team_matches_serial_on_host(host_kernel, n):
    """K7's team solve (csrc/staged_team.cuh) on one thread and at the
    kernel's team width (16 threads for n <= 16, 32 above) behind a
    barrier: bit for bit the serial
    chol_solve_item; all NaN, as it is, for a matrix that is not positive
    definite."""
    K = 8
    rng = np.random.RandomState(n)
    A = rng.randn(K, n, n)
    M = (A @ A.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)
    M[-1] = np.eye(n, dtype=np.float32)
    M[-1, 1, 1] = -1.0
    b = rng.randn(K, n).astype(np.float32)
    serial = np.zeros((K, n), np.float32)
    assert host_kernel.host_spd_solve(n, K, _ptr(M), _ptr(b), _ptr(serial)) == 0
    assert np.isfinite(serial[:-1]).all() and np.isnan(serial[-1]).all()
    for threads in (1, 16 if n <= 16 else 32):
        x = np.zeros((K, n), np.float32)
        assert host_kernel.host_chol_solve_team(threads, n, K, _ptr(M), _ptr(b), _ptr(x)) == 0
        np.testing.assert_array_equal(x[:-1].view(np.uint32), serial[:-1].view(np.uint32),
                                      err_msg=f"{threads} thread(s)")
        assert np.isnan(x[-1]).all()


@pytest.mark.parametrize("variant", sweep_floor_cuda.VARIANTS)
def test_sweep_floor_kernel_source_matches_plain_on_host(host_kernel, variant):
    """csrc/sweep_floor.cuh (on K4's pieces) on one thread and on four
    behind a barrier, and gersh, whose lift reduces over a warp, also on
    32, against `sweep_reference` at the experiment's widths (n=40, m=20),
    H=6: 1e-4 of the largest gain."""
    H, n, m = 6, 40, 20
    inputs = sweep_floor_cuda.random_inputs(H, n, m)
    wks, wKs = sweep_floor_cuda.sweep_reference(variant, *(torch.as_tensor(a) for a in inputs))
    scale = max(float(wks.abs().max()), float(wKs.abs().max()))
    for threads in (1, 4, 32) if variant == "gersh" else (1, 4):
        ks = np.full((H, m), np.nan, np.float32)
        Ks = np.full((H, m, n), np.nan, np.float32)
        assert host_kernel.host_sweep_floor(threads, sweep_floor_cuda.VARIANTS.index(variant), H,
                                            n, m, *(_ptr(a) for a in inputs), _ptr(ks),
                                            _ptr(Ks)) == 0
        for g, w in ((ks, wks.numpy()), (Ks, wKs.numpy())):
            _close(g, w, 1e-4 * scale, f"{threads} thread(s)")


# K6's rollouts per block on the card (csrc/contacts.cu: a warp per
# rollout, 4 warps per block)
CONTACT_ITEMS = 4


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
@pytest.mark.parametrize("touching", [True, False])
def test_contacts_team_matches_serial_on_host(host_kernel, name, touching):
    """K6's team contact model (csrc/staged_team.cuh::contacts_block) on
    teams of 1, 4, 16 and 32 threads behind barriers, in blocks of the
    kernel's rollouts: bit for bit the serial contacts_item, every output.
    On a batch with fingertip and table contacts whose size is not a
    multiple of the block's rollouts (K=37), and on one with the cubes
    lifted clear of the tips and the table."""
    m = from_numpy_model(jax_get_model(name))
    K, nq, T = 37 if touching else 16, m.nq, len(m.fingertips)
    q, v, _, cube = substep_cuda.random_inputs(m, K, seed=7)
    if not touching:
        cube[:, 2] += 10.0
    mf, mi = substep_cuda.pack_model(m)
    xp, xq, ax, _ = kin.rnea_terms(m, _t(q), _t(v))
    tips, tip_vel, _, _ = engine._tip_state(m, xp, xq, ax, _t(v))
    args = [a.contiguous().numpy() for a in (tips, tip_vel)] + [
        np.ascontiguousarray(cube[:, a:b]) for a, b in ((0, 3), (3, 7), (7, 10), (10, 13))]

    def outputs():
        return [np.zeros((K, 3), np.float32), np.zeros((K, 3), np.float32),
                np.zeros((K, T, 3), np.float32), np.zeros((K, T), bool), np.zeros(K, bool)]

    serial = outputs()
    assert host_kernel.host_contacts(nq, T, _ptr(mf), _ptr(mi), K, *(_ptr(a) for a in args),
                                     *(_ptr(o) for o in serial)) == 0
    assert serial[3].any() == touching and serial[4].any() == touching
    for threads in (1, 4, 16, 32):
        got = outputs()
        assert host_kernel.host_contacts_team(threads, CONTACT_ITEMS, nq, T, _ptr(mf), K,
                                              *(_ptr(a) for a in args),
                                              *(_ptr(o) for o in got)) == 0
        for what, g, w in zip(("force", "torque", "tip_forces", "touch_tip", "touch_table"),
                              got, serial):
            np.testing.assert_array_equal(g.view(np.uint8 if g.dtype == bool else np.uint32),
                                          w.view(np.uint8 if w.dtype == bool else np.uint32),
                                          err_msg=f"{what}, {threads} thread(s)")
