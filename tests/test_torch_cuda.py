"""The CUDA kernels (substep K1, pick-cost rollout K2, feedback rollout K3,
Riccati sweep K4, FK + RNEA K5, contacts K6, SPD solve K7, the sweep-floor
experiment K8) and the staged substep route against their plain PyTorch
versions, on the card, and their wrappers' launch counts and input checks.

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


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_kernel_matches_plain_at_fd_probe_shape_on_cuda(cuda, name):
    """K1 at the iLQR FD probes' launch shape, K=1500 without contact (1,500
    teams of lanes), against its plain version at the substep tolerances;
    no touch flag is set."""
    m = get_model(name)
    inputs = [torch.as_tensor(a, device=cuda)
              for a in substep_cuda.random_inputs(m, 1500, seed=12)]
    before = substep_cuda.substep_batched.launches
    got = substep_cuda.substep_batched(m, 0.02, False, True, *inputs)
    want = substep_cuda.substep_batched_reference(m, 0.02, False, True, *inputs)
    torch.cuda.synchronize()
    assert substep_cuda.substep_batched.launches == before + 1
    assert not bool(got[3].any())
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


def test_rollout_pick_kernel_matches_plain_at_main_path_shape_on_cuda(cuda):
    """K2 at the fused MPPI solve's shape, K=256 and H=50 on the solo arm,
    against `rollout_pick_costs_reference` at 1e-4 of the largest total
    (chip_smoke.py's band: 50 steps with contact grow the float32 rounding
    of the two versions apart)."""
    from gym_kmanip_torch.ops import rollout_pick_cuda as rp

    m = get_model("solo_arm")
    s0 = _state(m, cuda)
    rng = np.random.RandomState(4)
    U = torch.as_tensor((m.home_qpos[: m.nu] + 0.1 * rng.randn(256, 50, m.nu)).astype(
        np.float32), device=cuda)
    before = rp.rollout_pick_costs.launches
    got = rp.rollout_pick_costs(m, U, s0)
    want = rp.rollout_pick_costs_reference(m, U, s0)
    torch.cuda.synchronize()
    assert rp.rollout_pick_costs.launches == before + 1
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4 * scale, rtol=0)


def float64_twin(m, device, monkeypatch):
    """A copy of model `m` whose constants, and the scene's, are float64 on
    `device`, so that a plain version given float64 inputs runs in float64
    throughout (the constants are the float32 ones, widened). The scene's
    are swapped in through `monkeypatch` for as long as it lasts. Also used
    by the host build's test in tests/test_torch_dynamics.py."""
    import dataclasses

    from gym_kmanip_torch import models

    twin = dataclasses.replace(m)
    t = models.model_tensors(m, device)
    twin.cache[("tensors", str(models.canonical_device(device)))] = type(t)(
        *(x.double() if x.is_floating_point() else x for x in t))
    s = models.scene_tensors(device)
    scene = type(s)(*(x.double() for x in s))
    monkeypatch.setattr(models, "_scene_tensors", lambda _device: scene)
    return twin


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_rollout_feedback_kernel_matches_plain_on_cuda(cuda, name):
    """K3 against `rollout_feedback_reference` at B=6, H=8: us 2e-5 / 1e-4,
    xs 5e-4 / 1e-3 (tests/test_pallas.py:377-380); also at B=1 with zero
    gains and a zero nominal state, the launch shape of the iLQR solve's
    nominal rollout.

    Random feedback gains make this rollout ill-conditioned (one ulp of x0
    moves the plain version's us past the band; the host build's test in
    tests/test_torch_dynamics.py prints by how much). So both are also held
    to the plain rollout in float64: the kernel's controls may be no farther
    from it than twice the plain float32 version's."""
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
    with pytest.MonkeyPatch.context() as mp:
        _, us64 = rf.rollout_feedback_reference(float64_twin(m, cuda, mp),
                                                *(a.double() for a in args))
    torch.cuda.synchronize()
    assert rf.rollout_feedback.launches == before + 1
    assert us64.dtype == torch.float64
    kernel64, plain64 = (float((u.double() - us64).abs().max()) for u in (us, wus))
    print(f"{name}: us from float64: kernel {kernel64:.3e}, plain {plain64:.3e}; "
          f"kernel vs plain {float((us - wus).abs().max()):.3e}")
    assert kernel64 <= 2 * plain64
    np.testing.assert_allclose(us.cpu().numpy(), wus.cpu().numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(xs.cpu().numpy(), wxs.cpu().numpy(), atol=5e-4, rtol=1e-3)
    z = x0.new_zeros
    nominal = [x0, cube0, z((H, n)), args[3], z((H, nu)), z((H, nu, n)), x0.new_ones(1)]
    xs1, us1 = rf.rollout_feedback(m, *nominal)
    wxs1, wus1 = rf.rollout_feedback_reference(m, *nominal)
    torch.cuda.synchronize()
    assert rf.rollout_feedback.launches == before + 2 and xs1.shape == (1, H, n)
    np.testing.assert_allclose(us1.cpu().numpy(), wus1.cpu().numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(xs1.cpu().numpy(), wxs1.cpu().numpy(), atol=5e-4, rtol=1e-3)
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


@pytest.mark.parametrize("H,n,m,indefinite", [(50, 20, 10, False), (100, 40, 20, False),
                                              (6, 7, 3, True)])
def test_riccati_kernel_matches_plain_on_cuda(cuda, H, n, m, indefinite):
    """K4 against `riccati_sweep_reference` at the solo and torso widths
    (the kernel's two instantiations) and on the indefinite seeded problem
    whose lift and pivot drops the one-warp factor must reproduce (its
    runtime-width code), lam_extra 0 and 1e-3: both full float32, summed in
    other orders, held at 1e-4 of the largest gain."""
    from gym_kmanip_torch.ops import riccati_cuda as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    prob = [torch.as_tensor(a, device=cuda) for a in rc.random_problem(4, H, n, m, indefinite)]
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


def _staged_inputs(m, cuda, K=256, seed=11):
    """Seeded (q, v, ctrl, cube13) and the FK + RNEA kernel's contact inputs."""
    from gym_kmanip_torch.dynamics import engine
    from gym_kmanip_torch.ops import kinematics as kin

    q, v, c, cube = (torch.as_tensor(a, device=cuda)
                     for a in substep_cuda.random_inputs(m, K, seed=seed))
    xp, xq, ax, _ = kin.rnea_terms(m, q, v)
    tips, tip_vel, _, _ = engine._tip_state(m, xp, xq, ax, v)
    contact_args = tuple(a.contiguous() for a in (tips, tip_vel, cube[:, :3], cube[:, 3:7],
                                                   cube[:, 7:10], cube[:, 10:]))
    return (q, v, c, cube), contact_args


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_rnea_and_contact_kernels_match_plain_on_cuda(cuda, name):
    """K5 and K6 against their plain versions at K=256: frames 1e-5, bias
    and forces 1e-4, flags equal (tests/test_pallas.py:85-88, 135-141)."""
    from gym_kmanip_torch.ops import contacts_cuda, rnea_cuda

    m = get_model(name)
    (q, v, _, _), args = _staged_inputs(m, cuda)
    before = rnea_cuda.rnea_terms_batched.launches
    got = rnea_cuda.rnea_terms_batched(m, q, v)
    want = rnea_cuda.rnea_terms_batched_reference(m, q, v)
    torch.cuda.synchronize()
    assert rnea_cuda.rnea_terms_batched.launches == before + 1
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=tol, rtol=0)
    before = contacts_cuda.contact_forces_batched.launches
    got = contacts_cuda.contact_forces_batched(m, *args)
    want = contacts_cuda.contact_forces_batched_reference(m, *args)
    torch.cuda.synchronize()
    assert contacts_cuda.contact_forces_batched.launches == before + 1
    assert bool(want.touch_tip.any()) and bool(want.touch_table.any())
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=1e-4, rtol=0)
    with pytest.raises(TypeError):
        rnea_cuda.rnea_terms_batched(m, q.double(), v)
    with pytest.raises(ValueError):
        rnea_cuda.rnea_terms_batched(m, q[:, :-1].contiguous(), v)
    with pytest.raises(ValueError):
        contacts_cuda.contact_forces_batched(m, args[0].cpu(), *args[1:])
    with pytest.raises(ValueError):
        contacts_cuda.contact_forces_batched(m, args[0].transpose(1, 2), *args[1:])


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
@pytest.mark.parametrize("K", [1, 37])
def test_rnea_kernel_ragged_batch_on_cuda(cuda, name, K):
    """K5 on batches that do not fill the last block (four rollouts per
    block at solo width): every row against the plain version at the bands
    above."""
    from gym_kmanip_torch.ops import rnea_cuda

    m = get_model(name)
    (q, v, _, _), _ = _staged_inputs(m, cuda, K=K, seed=K)
    got = rnea_cuda.rnea_terms_batched(m, q, v)
    want = rnea_cuda.rnea_terms_batched_reference(m, q, v)
    torch.cuda.synchronize()
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
@pytest.mark.parametrize("K", [1, 255, 256, 257])
def test_contact_kernel_ragged_batch_on_cuda(cuda, name, K):
    """K6 on batches that do and do not fill the last block (several
    rollouts per block): every row against the plain version, forces 1e-4,
    flags equal, one launch."""
    from gym_kmanip_torch.ops import contacts_cuda

    m = get_model(name)
    _, args = _staged_inputs(m, cuda, K=K, seed=K)
    before = contacts_cuda.contact_forces_batched.launches
    got = contacts_cuda.contact_forces_batched(m, *args)
    want = contacts_cuda.contact_forces_batched_reference(m, *args)
    torch.cuda.synchronize()
    assert contacts_cuda.contact_forces_batched.launches == before + 1
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [6, 10, 20, 24])
@pytest.mark.parametrize("K", [1, 37, 300])
def test_spd_solve_kernel_ragged_batch_on_cuda(cuda, n, K):
    """K7 on batches that do not fill the last block (several items per
    block), from a 16-byte aligned M and from one that is not (the 4-byte
    copies): against the plain version and float64 at 1e-4 of the largest
    entry."""
    from gym_kmanip_torch.ops import chol_solve_cuda as cs

    rng = np.random.RandomState(K + n)
    A = rng.randn(K, n, n)
    M = torch.as_tensor(A @ A.transpose(0, 2, 1) / n + np.eye(n), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(rng.randn(K, n), dtype=torch.float32, device=cuda)
    shifted = torch.empty(K * n * n + 1, device=cuda)[1:].view(K, n, n)
    shifted.copy_(M)
    assert shifted.data_ptr() % 16 != 0
    want = cs.cholesky_solve_batched_reference(M, b)
    want64 = torch.linalg.solve(M.double(), b.double())
    scale = float(want64.abs().max())
    for MM in (M, shifted):
        x = cs.cholesky_solve_batched(MM, b)
        torch.cuda.synchronize()
        np.testing.assert_allclose(x.cpu().numpy(), want.cpu().numpy(), atol=1e-4 * scale,
                                   rtol=0)
        np.testing.assert_allclose(x.double().cpu().numpy(), want64.cpu().numpy(),
                                   atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("n", [1, 6, 10, 20, 24])
def test_spd_solve_kernel_matches_plain_on_cuda(cuda, n):
    """K7 against its plain version and float64 at 1e-4 of the largest
    entry; NaN for a matrix that is not positive definite; n above 24 is
    refused."""
    from gym_kmanip_torch.ops import chol_solve_cuda as cs
    from gym_kmanip_torch.ops import linalg

    rng = np.random.RandomState(n)
    A = rng.randn(300, n, n)
    M = torch.as_tensor(A @ A.transpose(0, 2, 1) / n + np.eye(n), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(rng.randn(300, n), dtype=torch.float32, device=cuda)
    before = cs.cholesky_solve_batched.launches
    x = cs.cholesky_solve_batched(M, b)
    want = cs.cholesky_solve_batched_reference(M, b)
    want64 = torch.linalg.solve(M.double(), b.double())
    torch.cuda.synchronize()
    assert cs.cholesky_solve_batched.launches == before + 1
    scale = float(want64.abs().max())
    np.testing.assert_allclose(x.cpu().numpy(), want.cpu().numpy(), atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(x.double().cpu().numpy(), want64.cpu().numpy(), atol=1e-4 * scale,
                               rtol=0)
    # the batch-aware solve: leading dimensions flatten into one launch
    y = linalg.batch_aware_cholesky_solve(M.reshape(3, 100, n, n), b.reshape(3, 100, n))
    assert cs.cholesky_solve_batched.launches == before + 2
    assert torch.equal(y.reshape(300, n), x)
    bad = -torch.eye(n, device=cuda)[None].contiguous()
    assert bool(torch.isnan(cs.cholesky_solve_batched(bad, b[:1])).all())
    with pytest.raises(ValueError):
        cs.cholesky_solve_batched(torch.eye(25, device=cuda)[None].contiguous(),
                                  torch.ones(1, 25, device=cuda))
    with pytest.raises(TypeError):
        cs.cholesky_solve_batched(M.double(), b)


def test_sweep_floor_kernel_matches_plain_on_cuda(cuda):
    """K8, every variant at the experiment's widths (H=100, n=40, m=20) and
    at runtime widths (H=30, n=12, m=6), against its plain version at 1e-4
    of the largest gain; m above 32 is refused."""
    from gym_kmanip_torch.ops import sweep_floor_cuda as sf

    torch.backends.cuda.matmul.allow_tf32 = False
    for H, n, m in ((100, 40, 20), (30, 12, 6)):
        inputs = [torch.as_tensor(a, device=cuda) for a in sf.random_inputs(H, n, m)]
        for v in sf.VARIANTS:
            before = sf.sweep.launches
            ks, Ks = sf.sweep(v, *inputs)
            wks, wKs = sf.sweep_reference(v, *inputs)
            torch.cuda.synchronize()
            assert sf.sweep.launches == before + 1
            scale = max(float(wks.abs().max()), float(wKs.abs().max()))
            for g, w in ((ks, wks), (Ks, wKs)):
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=1e-4 * scale,
                                           rtol=0, err_msg=f"{v} at {(H, n, m)}")
    with pytest.raises(ValueError):
        sf.sweep("unroll", *inputs)
    with pytest.raises(ValueError):
        sf.sweep("gersh", inputs[0].transpose(1, 2).contiguous(), *inputs[1:])
    with pytest.raises(ValueError):
        sf.sweep("gersh", *(torch.as_tensor(a, device=cuda) for a in sf.random_inputs(2, 40, 33)))


@pytest.mark.parametrize("dt,implicit", MODES)
def test_staged_substep_matches_plain_on_cuda(cuda, dt, implicit):
    """The staged route (K5, K6, K7 and torch glue) against the plain
    substep at the substep tolerances, one launch of K5 and K6 and four of
    K7 per substep, none of K1; the plain substep launches none of them."""
    from gym_kmanip_torch.dynamics import engine
    from gym_kmanip_torch.dynamics.state import SimState
    from gym_kmanip_torch.ops import chol_solve_cuda, contacts_cuda, rnea_cuda

    m = get_model("solo_arm")
    (q, v, c, cube), _ = _staged_inputs(m, cuda)
    s = SimState(q, v, c, cube[:, :3], cube[:, 3:7], cube[:, 7:10], cube[:, 10:],
                 torch.zeros(q.shape[0], device=cuda))
    wrappers = (rnea_cuda.rnea_terms_batched, contacts_cuda.contact_forces_batched,
                chol_solve_cuda.cholesky_solve_batched, substep_cuda.substep_batched)
    before = [w.launches for w in wrappers]
    got, (touch, xp, xq) = engine.substep_staged(m, s, dt, True, implicit)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 4, 0]
    want, (wtouch, wxp, wxq) = engine._substep_torch(m, s, dt, True, implicit)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 4, 0]
    assert torch.equal(touch, wtouch)
    for g, w, tol in ((got.qpos, want.qpos, 1e-5), (got.qvel, want.qvel, 1e-4),
                      (got.cube_pos, want.cube_pos, 1e-4), (got.cube_quat, want.cube_quat, 1e-4),
                      (got.cube_linvel, want.cube_linvel, 1e-4),
                      (got.cube_angvel, want.cube_angvel, 1e-4), (xp, wxp, 1e-5),
                      (xq, wxq, 1e-5)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=tol, rtol=0)
