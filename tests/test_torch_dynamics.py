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
from gym_kmanip_torch.models import from_numpy_model
from gym_kmanip_torch.ops import kinematics as kin
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
    one, (t1, x1, _) = engine.substep(m, init_state(m), 0.002)
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
#define __device__
#define __forceinline__ inline
#include "substep.cuh"
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
    so.host_substep.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int
    ] + [ctypes.c_void_p] * 10
    so.host_substep.restype = ctypes.c_int
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
