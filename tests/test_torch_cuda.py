"""The CUDA kernels (substep K1, pick-cost rollout K2, feedback rollout K3,
Riccati sweep K4) against their plain PyTorch versions, on the card, and
their wrappers' launch counts and input checks.

Skips without a GPU. This file imports neither JAX nor the JAX package, so
it runs on a GPU host that has neither; there, skip tests/conftest.py
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances for the substep are those the JAX package holds its Pallas
substep to (tests/test_pallas.py:202-207): qpos and xpos 1e-5, qvel and
cube 1e-4, touch flags exact; the others are stated at each test.
"""

import numpy as np
import pytest
import torch

from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.ops import substep_cuda

pytestmark = pytest.mark.cuda

MODES = [(0.02, True), (0.002, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU, and nvcc to build the kernel")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
@pytest.mark.parametrize("dt,implicit", MODES)
def test_kernel_matches_plain_on_cuda(cuda, name, dt, implicit):
    m = get_model(name)
    inputs = [torch.as_tensor(a, device=cuda)
              for a in substep_cuda.random_inputs(m, 256, seed=11)]
    before = substep_cuda.substep_batched.launches
    got = substep_cuda.substep_batched(m, dt, True, implicit, *inputs)
    want = substep_cuda.substep_batched_reference(m, dt, True, implicit, *inputs)
    torch.cuda.synchronize()
    assert substep_cuda.substep_batched.launches == before + 1
    for name_, g, w, tol in zip(("qpos", "qvel", "cube13", "touch", "xpos", "xquat"),
                                got, want, (1e-5, 1e-4, 1e-4, None, 1e-5, 1e-5)):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if tol is None:
            np.testing.assert_array_equal(g, w, err_msg=name_)
        else:
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name_)


def test_wrapper_refuses_bad_inputs(cuda):
    m = get_model("solo_arm")
    q, v, c, cube = (torch.as_tensor(a, device=cuda)
                     for a in substep_cuda.random_inputs(m, 8, seed=0))
    with pytest.raises(TypeError):
        substep_cuda.substep_batched(m, 0.02, True, True, q.double(), v, c, cube)
    with pytest.raises(ValueError):
        substep_cuda.substep_batched(m, 0.02, True, True, q, v, c, cube[:, :12])
    wide = torch.zeros(8, 2 * m.nq, device=cuda)
    with pytest.raises(ValueError):
        substep_cuda.substep_batched(m, 0.02, True, True, wide[:, ::2], v, c, cube)
    with pytest.raises(ValueError):
        substep_cuda.substep_batched(m, 0.02, True, True, q.cpu(), v, c, cube)


def _state(m, cuda):
    from gym_kmanip_torch.dynamics.state import init_state

    return init_state(m, cube_pos=np.array([0.25, 0.5, 0.62]), device=cuda)


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_rollout_pick_kernel_matches_plain_on_cuda(cuda, name):
    """K2 against `rollout_pick_costs_reference`: H=1 at 1e-5, H=3 at 1e-3
    (tests/test_pallas.py:249,284)."""
    from gym_kmanip_torch.ops import rollout_pick_cuda as rp

    m = get_model(name)
    s0 = _state(m, cuda)
    rng = np.random.RandomState(3)
    spec = rp.PickCostSpec(use_left=len(m.fingertips) > 2)
    for H, tol in ((1, 1e-5), (3, 1e-3)):
        U = torch.as_tensor((m.home_qpos[: m.nu] + 0.1 * rng.randn(128, H, m.nu)).astype(
            np.float32), device=cuda)
        before = rp.rollout_pick_costs.launches
        got = rp.rollout_pick_costs(m, U, s0, spec)
        want = rp.rollout_pick_costs_reference(m, U, s0, spec)
        torch.cuda.synchronize()
        assert rp.rollout_pick_costs.launches == before + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=tol, rtol=0)
    with pytest.raises(TypeError):
        rp.rollout_pick_costs(m, U.double(), s0, spec)
    with pytest.raises(ValueError):
        rp.rollout_pick_costs(m, U[..., :-1].contiguous(), s0, spec)
    with pytest.raises(ValueError):
        rp.rollout_pick_costs(m, U.transpose(0, 1), s0, spec)
    with pytest.raises(ValueError):
        rp.rollout_pick_costs(m, U, s0._replace(qpos=s0.qpos.cpu()), spec)


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_rollout_feedback_kernel_matches_plain_on_cuda(cuda, name):
    """K3 against `rollout_feedback_reference` at B=6, H=8: us 2e-5 / 1e-4,
    xs 5e-4 / 1e-3 (tests/test_pallas.py:377-380)."""
    from gym_kmanip_torch.ops import rollout_feedback_cuda as rf

    m = get_model(name)
    s0 = _state(m, cuda)
    n, nu, H = 2 * m.nq, m.nu, 8
    rng = np.random.RandomState(5)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=cuda)

    x0 = torch.cat([s0.qpos, s0.qvel])
    cube0 = torch.cat([s0.cube_pos, s0.cube_quat, s0.cube_linvel, s0.cube_angvel])
    args = [x0, cube0, x0[None] + t(0.02 * rng.randn(H, n)),
            t(m.home_qpos[:nu] + 0.05 * rng.randn(H, nu)), t(0.03 * rng.randn(H, nu)),
            t(0.05 * rng.randn(H, nu, n)), t([1.0, 0.6, 0.3, 0.1, 0.03, 0.01])]
    before = rf.rollout_feedback.launches
    xs, us = rf.rollout_feedback(m, *args)
    wxs, wus = rf.rollout_feedback_reference(m, *args)
    torch.cuda.synchronize()
    assert rf.rollout_feedback.launches == before + 1
    np.testing.assert_allclose(us.cpu().numpy(), wus.cpu().numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(xs.cpu().numpy(), wxs.cpu().numpy(), atol=5e-4, rtol=1e-3)
    bad = list(args)
    bad[5] = args[5].double()
    with pytest.raises(TypeError):
        rf.rollout_feedback(m, *bad)
    bad[5] = args[5][:, :, :-1].contiguous()
    with pytest.raises(ValueError):
        rf.rollout_feedback(m, *bad)
    bad[5] = args[5].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        rf.rollout_feedback(m, *bad)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError):
        rf.rollout_feedback(m, *bad)


@pytest.mark.parametrize("H,n,m", [(50, 20, 10), (100, 40, 20)])
def test_riccati_kernel_matches_plain_on_cuda(cuda, H, n, m):
    """K4 against `riccati_sweep_reference` at the solo and torso widths,
    lam_extra 0 and 1e-3: both full float32, summed in other orders, held
    at 1e-4 of the largest gain."""
    from gym_kmanip_torch.ops import riccati_cuda as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    prob = [torch.as_tensor(a, device=cuda) for a in rc.random_problem(4, H, n, m)]
    for lam_extra in (0.0, 1e-3):
        lam = torch.tensor(lam_extra, device=cuda)
        before = rc.riccati_sweep.launches
        ks, Ks = rc.riccati_sweep(*prob, 1e-6, lam_extra=lam)
        wks, wKs = rc.riccati_sweep_reference(*prob, 1e-6, lam_extra=lam)
        torch.cuda.synchronize()
        assert rc.riccati_sweep.launches == before + 1
        for g, w in ((ks, wks), (Ks, wKs)):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0)
    bad = list(prob)
    bad[0] = prob[0].double()
    with pytest.raises(TypeError):
        rc.riccati_sweep(*bad, 1e-6)
    bad[0] = prob[0][:, :, :-1].contiguous()
    with pytest.raises(ValueError):
        rc.riccati_sweep(*bad, 1e-6)
    bad[0] = prob[0].transpose(1, 2)
    with pytest.raises(ValueError):
        rc.riccati_sweep(*bad, 1e-6)
    bad[0] = prob[0].cpu()
    with pytest.raises(ValueError):
        rc.riccati_sweep(*bad, 1e-6)
