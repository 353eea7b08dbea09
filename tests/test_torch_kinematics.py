"""The port's frames against the MuJoCo goldens in tests/golden/, its
dynamics identities against the JAX package's, and its rotation helpers.

Frames from `kinematics.rnea_terms_fast` on CPU tensors, which runs the
FK + RNEA kernel's plain version, then the sites' world poses and their
Jacobians, against the MuJoCo traces of tools/make_golden.py at the bands
of tests/test_kinematics.py:49,56,77,81: position 2e-5, orientation
(rotation matrix) 5e-5, Jacobians 1e-4.

The identities (`mass_matrix`, `gravity_potential`, `bias_forces`, the
autodiff oracle `bias_forces_ad`) against the JAX package's on
tests/test_dynamics.py:73-86's draws, read from
tests/golden/dynamics_identities.npz (`python
tools/make_golden_identities.py`: JAX's autodiff oracle takes 14-20 s a
robot eagerly on the CPU), and the cheap JAX functions run eagerly here
beside it: frames and M at 1e-5, bias at 1e-4 (tests/test_pallas.py), the
RNEA against the oracle at atol = rtol = 1e-4 (tests/test_dynamics.py:85).
No JAX program is jitted.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_kmanip_tpu.models import get_model as jax_get_model
from gym_kmanip_tpu.ops import kinematics as jkin
from gym_kmanip_tpu.utils import rotations as jrot

from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.utils import rotations as rot

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NAMES = ("solo_arm", "dual_arm", "torso")

CASES = [
    ("solo_arm", {"eer_site_pos": "eer_site"}),
    ("dual_arm", {"eer_site_pos": "eer_site", "eel_site_pos": "eel_site"}),
    ("torso", {"eer_site_pos": "eer_site", "eel_site_pos": "eel_site"}),
]


@pytest.mark.parametrize("robot,sites", CASES)
def test_frames_match_mujoco(robot, sites):
    data = np.load(os.path.join(GOLDEN, f"{robot}.npz"))
    model = get_model(robot)
    np.testing.assert_allclose(data["jnt_range"], model.jnt_range, atol=1e-6)
    qs = torch.as_tensor(data["qpos"], dtype=torch.float32)
    xpos, xquat, axis_w, _ = kin.rnea_terms_fast(model, qs, torch.zeros_like(qs))
    for golden, site in sites.items():
        pos, quat = kin.site_pose(model, xpos, xquat, site)
        np.testing.assert_allclose(pos.numpy(), data[f"{golden}_pos"], atol=2e-5,
                                   err_msg=f"{robot}/{site} position")
        np.testing.assert_allclose(rot.quat_to_mat(quat).reshape(-1, 9).numpy(),
                                   data[f"{golden}_mat"], atol=5e-5,
                                   err_msg=f"{robot}/{site} orientation")
        jacp, jacr = kin.point_jacobian(model, xpos, axis_w, pos, model.site(site).parent)
        np.testing.assert_allclose(jacp.numpy(), data[f"{golden}_jacp"], atol=1e-4,
                                   err_msg=f"{robot}/{site} jacp")
        np.testing.assert_allclose(jacr.numpy(), data[f"{golden}_jacr"], atol=1e-4,
                                   err_msg=f"{robot}/{site} jacr")


def _identity_draws():
    """tests/test_dynamics.py:73-86's draws: RandomState(0) over the three
    robots in order, three states each."""
    rng = np.random.RandomState(0)
    out = {}
    for name in NAMES:
        m = get_model(name)
        lo, hi = np.maximum(m.jnt_range[:, 0], -3), np.minimum(m.jnt_range[:, 1], 3)
        qv = [(rng.uniform(lo, hi), rng.randn(m.nq) * 0.5) for _ in range(3)]
        out[name] = tuple(np.stack([x[i] for x in qv]).astype(np.float32) for i in (0, 1))
    return out


def _close(got, want, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("name", NAMES)
def test_identities_match_jax(name):
    with np.load(os.path.join(GOLDEN, "dynamics_identities.npz")) as g:
        ref = {key.split("/")[1]: g[key] for key in g.files if key.startswith(f"{name}/")}
    q, v = _identity_draws()[name]
    np.testing.assert_array_equal(ref["q"], q)  # the golden was made from these draws
    np.testing.assert_array_equal(ref["v"], v)
    m = get_model(name)
    tq, tv = torch.as_tensor(q), torch.as_tensor(v)
    M = kin.mass_matrix(m, tq)
    bias = kin.bias_forces(m, tq, tv)
    bias_ad = kin.bias_forces_ad(m, tq, tv)
    assert M.shape == (3, m.nq, m.nq) and bias_ad.shape == (3, m.nq)
    _close(M, ref["M"], 1e-5, msg="M")
    _close(kin.gravity_potential(m, tq), ref["U"], 0.0, 1e-6, "U")
    _close(bias, ref["bias"], 1e-4, msg="bias")
    _close(bias_ad, ref["bias_ad"], 1e-4, msg="bias_ad")
    # the RNEA against the oracle (tests/test_dynamics.py:85), M symmetric
    # and positive definite (tests/test_dynamics.py:89-99)
    _close(bias, bias_ad, 1e-4, 1e-4, "RNEA vs autodiff")
    _close(M, M.transpose(-1, -2), 1e-5, msg="M symmetric")
    assert torch.linalg.eigvalsh(M.double()).min() > 0
    # one state alone is that state of the batch
    _close(kin.bias_forces_ad(m, tq[1], tv[1]), bias_ad[1], 1e-6, msg="unbatched")


def test_identities_match_jax_eagerly():
    """JAX's mass matrix, potential and RNEA run eagerly on one state of
    the solo arm, and the zero-velocity bias against the gravity gradient
    (tests/test_kinematics.py:97-103)."""
    q, v = (a[0] for a in _identity_draws()["solo_arm"])
    jm, m = jax_get_model("solo_arm"), get_model("solo_arm")
    tq, tv = torch.as_tensor(q), torch.as_tensor(v)
    _close(kin.gravity_potential(m, tq), jkin.gravity_potential(jm, jnp.asarray(q)), 0.0, 1e-6,
           "U")
    _close(kin.bias_forces(m, tq, tv), jkin.bias_forces(jm, jnp.asarray(q), jnp.asarray(v)),
           1e-4, msg="bias")
    home = torch.as_tensor(m.home_qpos, dtype=torch.float32)
    grad = torch.func.grad(lambda x: kin.gravity_potential(m, x[None])[0])(home)
    _close(kin.bias_forces(m, home, torch.zeros_like(home)), grad, 1e-5, msg="g(q) = dU/dq")


def _unit_quats(rng, n):
    q = rng.randn(n, 4)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def test_rotation_helpers_match_jax():
    rng = np.random.RandomState(5)
    qs = _unit_quats(rng, 128)
    v = rng.randn(128, 3).astype(np.float32)
    euler = rng.uniform(-3, 3, (16, 3)).astype(np.float32)
    tq = torch.as_tensor(qs)
    # mat_to_quat round-trips up to sign (tests/test_rotations.py:40-47)
    back = rot.mat_to_quat(rot.quat_to_mat(tq)).numpy()
    sign = np.sign(np.sum(back * qs, axis=1, keepdims=True))
    _close(back * sign, qs, 1e-6, msg="mat_to_quat round trip")
    assert (back[:, 0] >= 0).all()
    mats = rot.quat_to_mat(tq).numpy()
    _close(back, jrot.mat_to_quat(jnp.asarray(mats)), 1e-6, msg="mat_to_quat")
    _close(rot.quat_inv(tq), jrot.quat_inv(jnp.asarray(qs)), 0.0, msg="quat_inv")
    _close(rot.quat_rotate_inv(tq, torch.as_tensor(v)),
           jrot.quat_rotate_inv(jnp.asarray(qs), jnp.asarray(v)), 1e-6, msg="quat_rotate_inv")
    _close(rot.quat_rotate(tq, rot.quat_rotate_inv(tq, torch.as_tensor(v))), v, 1e-5,
           msg="rotate(rotate_inv(v))")
    _close(rot.euler_seq_to_quat(torch.as_tensor(euler)),
           jrot.euler_seq_to_quat(jnp.asarray(euler)), 1e-6, msg="euler_seq_to_quat")
