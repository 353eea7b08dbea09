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


def test_rollout_pick_half_warp_teams_equal_warp_teams_at_fill_on_cuda(cuda, monkeypatch):
    """K2 at the fill point, K=4,096 solo sequences at H=50 with contact (the
    cube at the first fingertip, so the contact lanes run), takes two
    rollouts a warp, and its trace name shows the half-warp team; scored
    again in chunks of 256, which take the warp team, the totals are equal
    bit for bit, and so are those of K=4,095 (the last warp's second half
    runs a copy). `rollout_pick_costs.pair_launches` counts exactly the
    launches the wrapper sent to half-warp teams. The torso at K=4,096
    keeps the warp team."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from gym_kmanip_torch.dynamics import engine
    from gym_kmanip_torch.dynamics.state import init_state
    from gym_kmanip_torch.ops import kinematics as kin
    from gym_kmanip_torch.ops import rollout_pick_cuda as rp

    picked = []
    team_lanes = rp.team_lanes

    def spy(*args):
        picked.append(team_lanes(*args))
        return picked[-1]

    monkeypatch.setattr(rp, "team_lanes", spy)

    def score(m, U, s0):
        wrapper, n = rp.rollout_pick_costs, len(picked)
        launches, pairs = wrapper.launches, wrapper.pair_launches
        out = wrapper(m, U, s0, rp.PickCostSpec(use_left=len(m.fingertips) > 2))
        torch.cuda.synchronize()
        assert wrapper.launches == launches + 1
        assert wrapper.pair_launches == pairs + picked[n:].count(16)
        return out, picked[-1]

    m = get_model("solo_arm")
    home = torch.as_tensor(m.home_qpos, dtype=torch.float32)
    tip0 = engine._tips_from_frames(m, *kin.fk(m, home)[:2])[0].numpy()
    s0 = init_state(m, cube_pos=tip0, device=cuda)
    rng = np.random.RandomState(17)
    U = torch.as_tensor((m.home_qpos[: m.nu] + 0.1 * rng.randn(4096, 50, m.nu)).astype(
        np.float32), device=cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        full, lanes = score(m, U, s0)
    assert lanes == 16
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel" and "rollout_pick_kernel" in e.get("name", "")]
    finally:
        os.remove(path)
    assert len(names) == 1 and "kmanip::HalfWarpTeam" in names[0], names
    chunks = [score(m, U[i:i + 256], s0) for i in range(0, 4096, 256)]
    assert [lanes for _, lanes in chunks] == [32] * 16
    chunked = torch.cat([out for out, _ in chunks])
    assert bool(torch.isfinite(full).all())
    np.testing.assert_array_equal(full.cpu().numpy().view(np.uint32),
                                  chunked.cpu().numpy().view(np.uint32))
    ragged, lanes = score(m, U[:4095], s0)
    assert lanes == 16
    np.testing.assert_array_equal(ragged.cpu().numpy().view(np.uint32),
                                  full[:4095].cpu().numpy().view(np.uint32))

    torso = get_model("torso")
    U = torch.as_tensor((torso.home_qpos[: torso.nu] + 0.1 * rng.randn(4096, 50, torso.nu))
                        .astype(np.float32), device=cuda)
    _, lanes = score(torso, U, _state(torso, cuda))
    assert lanes == 32


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


def _golden_env(device):
    """(data, task on `device`, start state) of the solo golden env trace."""
    import os

    from gym_kmanip_torch.env.config import CONFIGS
    from gym_kmanip_torch.env.task import make_task

    data = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                "solo_arm_env_trace.npz"))
    cfg = CONFIGS["KManipSoloArm"]
    reset_fn, step_fn, m = make_task(cfg, device=device)
    state = reset_fn(np.asarray(data["cube_spawn"], np.float32)).state
    qh = torch.as_tensor(np.asarray(cfg.q_pos_home, np.float32), device=device)
    return data, step_fn, m, state._replace(qpos=qh, ctrl=qh[: m.nu])


def _golden_action(data, t, device):
    return {"eer_pos": torch.as_tensor(data["actions"][t], dtype=torch.float32, device=device),
            "eer_orn": torch.zeros(3, device=device), "grip_r": torch.zeros(1, device=device)}


def test_env_step_on_card_matches_cpu(cuda):
    """The solo golden env trace on the card: every step from the CPU
    trace's own pre-step state against that CPU step (ten K1 launches per
    step, no plain substep) at the plant's band (tests/test_torch_plant.py:
    qpos 1e-5, qvel and cube 1e-4; the reward 1e-4, so no touch flag flips);
    and the whole trace on the card against the MuJoCo golden at
    tests/test_env_parity.py's bands."""
    from gym_kmanip_torch.dynamics.state import SimState

    data, step_cpu, _, s_cpu = _golden_env("cpu")
    _, step_gpu, m, s_gpu = _golden_env(cuda)
    arm = list(range(7))
    q_dev = []
    for t in range(data["actions"].shape[0]):
        before = substep_cuda.substep_batched.launches
        out_g = step_gpu(SimState(*(x.to(cuda) for x in s_cpu)), _golden_action(data, t, cuda))
        torch.cuda.synchronize()
        assert substep_cuda.substep_batched.launches == before + 10
        out_c = step_cpu(s_cpu, _golden_action(data, t, "cpu"))
        for f, tol in (("qpos", 1e-5), ("qvel", 1e-4), ("cube_pos", 1e-4),
                       ("cube_linvel", 1e-4), ("cube_angvel", 1e-4)):
            np.testing.assert_allclose(getattr(out_g.state, f).cpu().numpy(),
                                       getattr(out_c.state, f).numpy(), atol=tol, rtol=0,
                                       err_msg=f"step {t}: {f}")
        assert abs(float(out_g.reward) - float(out_c.reward)) < 1e-4, t
        s_cpu = out_c.state
        out = step_gpu(s_gpu, _golden_action(data, t, cuda))
        s_gpu = out.state
        q_dev.append(np.abs(out.obs["q_pos"].cpu().numpy() - data["q_pos"][t]))
        if t == data["actions"].shape[0] - 1:
            cube = np.abs(out.obs["cube_pos"].cpu().numpy() - data["cube_pos"][t])
    q_dev = np.stack(q_dev)
    assert q_dev[:, arm].max() < 0.002 and q_dev.max() < 0.06
    assert cube.max() < 0.002


def test_native_ik_on_gpu_host(cuda):
    """The GPU host builds the native host IK (g++), and it agrees with the
    numpy twin to 1e-9 (tests/test_native_ik.py)."""
    from gym_kmanip_torch import native
    from gym_kmanip_torch.solvers.ik_host import _solve_np, fk_np, site_pose_np

    assert native.available(), native.load_error()
    m = get_model("solo_arm")
    q = np.asarray(m.home_qpos, np.float64)
    xp, xq, _ = fk_np(m, q)
    p, o = site_pose_np(m, xp, xq, "eer_site")
    args = (q, p + np.array([0.01, -0.02, 0.01]), o, m.home_qpos, q)
    kw = dict(model=m, q_mask=tuple(range(7)), site_name="eer_site")
    for a, b in zip(native.solve_ik_native(*args, **kw), _solve_np(*args, **kw)):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_control_step_qpos_force_matches_cpu_on_cuda(cuda, name):
    """control_step(qpos_force=...) on the card (ten K1 launches) against
    the CPU's plain substeps, at tests/test_torch_plant.py's tolerances:
    qpos 1e-5, qvel and cube 1e-4, sites 1e-5, flags exact."""
    from gym_kmanip_torch.dynamics import engine
    from gym_kmanip_torch.dynamics.state import SimState, init_state

    m = get_model(name)
    rng = np.random.RandomState(5)
    s = init_state(m, cube_pos=np.array([0.15, 0.58, 0.62]), device="cpu")
    ctrl = torch.as_tensor((m.home_qpos[: m.nu] + rng.randn(m.nu) * 0.1).astype(np.float32))
    q_force = s.qpos + torch.as_tensor(rng.randn(m.nq).astype(np.float32)) * 0.01
    want, want_aux = engine.control_step(m, s, ctrl, qpos_force=q_force)
    before = substep_cuda.substep_batched.launches
    got, aux = engine.control_step(m, SimState(*(x.to(cuda) for x in s)), ctrl.to(cuda),
                                   qpos_force=q_force.to(cuda))
    torch.cuda.synchronize()
    assert substep_cuda.substep_batched.launches == before + 10
    for f, tol in (("qpos", 1e-5), ("qvel", 1e-4), ("cube_pos", 1e-4), ("cube_quat", 1e-4),
                   ("cube_linvel", 1e-4), ("cube_angvel", 1e-4)):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(), getattr(want, f).numpy(),
                                   atol=tol, rtol=0, err_msg=f)
    np.testing.assert_allclose(aux.site_pos.cpu().numpy(), want_aux.site_pos.numpy(),
                               atol=1e-5, rtol=0)
    for f in ("touch_r", "touch_l", "touch_table"):
        assert bool(getattr(aux, f)) == bool(getattr(want_aux, f)), f


def test_vec_step_on_k1_matches_plain_on_cuda(cuda):
    """One vec step of KManipSoloArm at N = 64 on the card: ten K1 launches
    at K = 64 and no plain substep; each launch's inputs through the plain
    substep match the kernel at the substep tolerances, touch flags exact."""
    from gym_kmanip_torch.dynamics import engine
    from gym_kmanip_torch.env.vec_env import KManipVecEnv

    env = KManipVecEnv("KManipSoloArm", 64, seed=0, device=cuda)
    env.reset()
    rng = np.random.default_rng(1)
    sizes = {"eer_pos": 3, "eer_orn": 3, "grip_r": 1}
    action = {a: torch.as_tensor(rng.uniform(-1, 1, (64, d)).astype(np.float32), device=cuda)
              for a, d in sizes.items()}
    env.step(action)
    real, plain = substep_cuda.substep_batched, engine._substep_torch
    launches, plain_calls = [], []

    def recording(*args):
        launches.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    # the wrapper counts its launches on its module's name, this stand-in
    recording.launches = real.launches
    substep_cuda.substep_batched = recording
    engine._substep_torch = lambda *a, **kw: plain_calls.append(1) or plain(*a, **kw)
    try:
        env.step(action)
    finally:
        substep_cuda.substep_batched, engine._substep_torch = real, plain
    assert len(launches) == 10 and not plain_calls
    for args in launches:
        assert args[4].shape == (64, 10)
        got = real(*args)
        want = substep_cuda.substep_batched_reference(*args)
        torch.cuda.synchronize()
        for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-4, None, 1e-5, 1e-5)):
            if tol is None:
                assert torch.equal(g, w)
            else:
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=tol, rtol=0)


def test_device_trf_matches_host_float64_on_cuda(cuda):
    """The float32 TRF on the card (ik_trf) against the float64 host solver
    on 64 solo problems from the home pose: within 1e-3 rad
    (tests/test_ik.py:200). One item alone against its row of the batch:
    the CPU holds them equal (tests/test_torch_trf.py); on the card the
    batched and the single SVD and reductions round apart (measured 1.0e-7
    rad), held at 1e-5."""
    from gym_kmanip_torch import constants as k
    from gym_kmanip_torch.solvers import ik, ik_host

    m = get_model("solo_arm")
    mask = tuple(int(i) for i in k.Q_ID_R_MASK_SOLO)
    home = np.asarray(m.home_qpos, np.float64)
    xpos, xquat, _ = ik_host.fk_np(m, home)
    p0, quat0 = ik_host.site_pose_np(m, xpos, xquat, "eer_site")
    rng = np.random.default_rng(3)
    qpos = np.repeat(home[None], 64, 0)
    qpos[:, list(mask)] += rng.uniform(-0.2, 0.2, (64, len(mask)))
    goals = p0 + rng.uniform(-1, 1, (64, 3)) * k.EE_POS_DELTA
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    args = (f32(qpos), f32(goals), f32(quat0).expand(64, 4), f32(home), f32(qpos))
    q_sol, q_scrib = ik.ik_trf(m, *args, q_mask=mask, site_name="eer_site")
    q_sol = q_sol.cpu().numpy()
    for b in range(64):
        q32 = np.asarray(qpos[b], np.float32).astype(np.float64)
        want, _ = ik_host.solve_host(q32, np.asarray(goals[b], np.float32).astype(np.float64),
                                     np.asarray(quat0, np.float32).astype(np.float64),
                                     np.asarray(home, np.float32).astype(np.float64), q32,
                                     model=m, q_mask=mask, site_name="eer_site")
        np.testing.assert_allclose(q_sol[b], want, atol=1e-3, rtol=0, err_msg=str(b))
    alone = ik.ik_trf(m, *(a[5] if a.dim() > 1 else a for a in args), q_mask=mask,
                      site_name="eer_site")
    np.testing.assert_allclose(alone[0].cpu().numpy(), q_sol[5], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["solo_arm", "dual_arm", "torso"])
def test_render_on_card_matches_cpu(cuda, name):
    """Every camera of a robot at its Cam spec size, on a batch of two
    seeded states, on the card against the CPU: within one level on at
    least 99.5% of the pixels (tests/test_torch_render.py's band against
    JAX), a real frame (std > 0)."""
    from gym_kmanip_torch import constants as k
    from gym_kmanip_torch.render.raycast import render_camera

    m = get_model(name)
    rng = np.random.default_rng(4)
    q = torch.as_tensor((m.home_qpos + rng.uniform(-0.2, 0.2, (2, m.nq))).astype(np.float32))
    cube = torch.as_tensor(rng.uniform([0.1, 0.5, 0.6], [0.3, 0.7, 0.7], (2, 3)).astype(np.float32))
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2)
    for cam in m.cameras:
        spec = k.CAMERAS[cam.name]
        want = render_camera(m, cam.name, q, cube, quat, spec.h, spec.w).numpy()
        got = render_camera(m, cam.name, q.to(cuda), cube.to(cuda), quat.to(cuda), spec.h,
                            spec.w).cpu().numpy()
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
        assert (diff <= 1).mean() >= 0.995, (cam.name, (diff <= 1).mean())
        assert got.std() > 0


def test_vision_serving_on_card_launches_k1(cuda):
    """A KManipSoloArmVision step through the backend launches K1 ten times
    and renders its cameras on the card; a vision MPPI solve at H = 3
    launches K1 three times; the zoo's pixels policy on the card matches
    the CPU's at 1e-3 of the ctrl range."""
    import types

    from gym_kmanip_torch import constants as k
    from gym_kmanip_torch import zoo
    from gym_kmanip_torch.dynamics.state import SimState, init_state
    from gym_kmanip_torch.env.config import CONFIGS
    from gym_kmanip_torch.env.env_sim import KManipEnvSim
    from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver
    from gym_kmanip_torch.mpc.vision_cost import init_cost_params, make_vision_cost

    cfg = CONFIGS["KManipSoloArmVision"]
    shell = types.SimpleNamespace(cfg=cfg, obs_list=list(cfg.obs_list),
                                  cameras=[k.CAMERAS["head"], k.CAMERAS["grip_r"]],
                                  np_random=np.random.default_rng(0))
    sim = KManipEnvSim(shell, device=cuda)
    sim.k_reset()
    before = substep_cuda.substep_batched.launches
    _, _, _, obs, _ = sim.k_step({"eer_pos": np.ones(3), "eer_orn": np.zeros(3),
                                  "grip_r": np.zeros(1)})
    assert substep_cuda.substep_batched.launches == before + 10
    assert obs["camera/head"].shape == (480, 640, 3) and obs["camera/head"].std() > 0
    m = get_model("solo_arm")
    cost = make_vision_cost(m, init_cost_params(0, 12, 15, device=cuda), "top", 12, 15)
    mcfg = MPPIConfig(horizon=3, n_samples=16)
    s0 = init_state(m, device=cuda)
    before = substep_cuda.substep_batched.launches
    _, u0, J = make_mppi_solver(m, mcfg, cost)(init_mppi(m, mcfg, device=cuda), s0)
    torch.cuda.synchronize()
    assert substep_cuda.substep_batched.launches == before + 3 and bool(torch.isfinite(J))
    # the zoo's pixels policy: its frame on the card within one level of the
    # CPU's, and on the CPU's frame its control equals the CPU policy's. A
    # one-level pixel moves this network's slider control by up to ~1.5e-3
    # of the range (the home state), so end to end chip_smoke.py holds it at
    # 1e-3 on an episode's states.
    policy, meta = zoo.load_policy("bc_pixels_solo", device=cuda)
    policy_cpu, _ = zoo.load_policy("bc_pixels_solo", device="cpu")
    s_cpu = SimState(*(x.cpu() for x in s0))
    h, w = meta["img_h"], meta["img_w"]
    frame = zoo.render_camera(m, "top", s_cpu.qpos, s_cpu.cube_pos, s_cpu.cube_quat, h, w)
    on_card = zoo.render_camera(m, "top", s0.qpos, s0.cube_pos, s0.cube_quat, h, w).cpu()
    diff = (on_card.int() - frame.int()).abs().amax(dim=-1)
    assert float((diff <= 1).float().mean()) >= 0.995
    saved_render, saved_tf32 = zoo.render_camera, torch.backends.cudnn.allow_tf32
    zoo.render_camera = lambda *a, **kw: frame.to(cuda)
    torch.backends.cudnn.allow_tf32 = False  # full float32 convolutions
    try:
        u = policy(s0).cpu().numpy()
    finally:
        zoo.render_camera, torch.backends.cudnn.allow_tf32 = saved_render, saved_tf32
    span = m.ctrl_range[:, 1] - m.ctrl_range[:, 0]
    gap = np.abs(u - policy_cpu(s_cpu).numpy())
    assert np.all(gap <= 1e-5 * span), gap / span


def test_training_steps_on_card_match_cpu(cuda):
    """One Adam step of each network the learning path trains (CostCNN and
    CubePosCNN in the fits, example 13's BC-MLP, example 15's BCPixelsCNN)
    on the card equals the CPU's step at 1e-5, TF32 off, from one carried
    optimizer state (drawn moments, count 3): Adam's update from zero
    moments is ~lr * sign(g), which rounding can flip where g is near 0."""
    import copy

    from gym_kmanip_torch import zoo
    from gym_kmanip_torch.mpc import vision_cost as vc
    from gym_kmanip_torch.utils import flax_layers, optim
    from torch_optim_carry import adam_state, draw_moments, flax_tree, load_adam_state

    rng = np.random.default_rng(21)
    gen = torch.Generator().manual_seed(21)
    f32 = lambda *shape: torch.as_tensor(rng.uniform(0, 1, shape).astype(np.float32))  # noqa: E731
    idx = torch.as_tensor(rng.integers(0, 16, 8))
    frames = torch.as_tensor(rng.integers(0, 256, (16, 32, 48, 3)).astype(np.uint8))
    # (network, (target, *inputs)) as the fits' and examples 13 and 15's loops pass them
    cases = {
        "cost": (vc.CostCNN(24, 32), (f32(16), f32(16, 24, 32, 3))),
        "cube_pos": (vc.CubePosCNN(32, 48), (f32(16, 3)[idx], f32(16, 32, 48, 3)[idx])),
        "bc_mlp": (zoo.bc_mlp(10, 64, 2, in_dim=27, device="cpu"),
                   (f32(16, 10)[idx], f32(16, 27)[idx])),
        "bc_pixels": (zoo.bc_pixels_cnn(10, 64, img_hw=(32, 48), proprio_dim=20, device="cpu"),
                      (f32(16, 10)[idx], frames[idx].float() / 255.0, f32(16, 20)[idx])),
    }
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, (net, args) in cases.items():
            flax_layers.flax_init_(net, gen)
            mu, nu = draw_moments(flax_tree(net), rng)
            out = {}
            for dev in ("cpu", cuda):
                n = copy.deepcopy(net).to(dev)
                opt, sched = optim.adam(n.parameters(), optim.exponential_decay(3e-3, 2, 0.5))
                load_adam_state(opt, sched, n, 3, mu, nu)
                loss = optim.mse_step(n, opt, sched, *(a.to(dev) for a in args))
                out[str(dev)] = (float(loss), adam_state(opt, n))
            (l_cpu, (_, _, _, p_cpu)), (l_gpu, (_, _, _, p_gpu)) = out["cpu"], out[str(cuda)]
            np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5, err_msg=name)
            for layer, leaves in p_cpu.items():
                for leaf, w in leaves.items():
                    np.testing.assert_allclose(p_gpu[layer][leaf], w, rtol=0, atol=1e-5,
                                               err_msg=f"{name} {layer}/{leaf}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_sharded_mppi_on_card_matches_single_device(cuda):
    """The sharded MPPI on a mesh of one rank (no process group) on the
    card, at example 8's shape with the horizon cut to 4 (K = 256, 2
    iterations, 10 substeps of 2 ms, contact): on the same injected noise,
    the single-device solve's u0 (1e-5), J (1e-4) and nominal (1e-5), with
    n_iters x H x n_substeps K1 launches."""
    import importlib

    from gym_kmanip_torch.dynamics.state import init_state
    from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver
    from gym_kmanip_torch.parallel import mesh as pm

    ex8 = importlib.import_module("gym_kmanip_torch.examples.8_mpc_mppi")
    m = get_model("solo_arm")
    cost = ex8.make_cost(m)
    cfg = MPPIConfig(horizon=4, n_samples=256, n_iters=2, sigma=0.15, n_substeps=10, dt=0.002,
                     noise_beta=0.9)
    s = init_state(m, cube_pos=ex8.CUBE_SPAWN, device=cuda)
    eps = torch.randn((2, 256, 4, m.nu), generator=torch.Generator(cuda).manual_seed(0),
                      device=cuda) * 0.1
    before = substep_cuda.substep_batched.launches
    ms, u0, J = pm.make_sharded_mppi_solver(m, cfg, cost, pm.make_mesh())(
        init_mppi(m, cfg, device=cuda), s, eps=eps)
    torch.cuda.synchronize()
    assert substep_cuda.substep_batched.launches - before == 2 * 4 * 10
    ms1, u01, J1 = make_mppi_solver(m, cfg, cost)(init_mppi(m, cfg, device=cuda), s, eps=eps)
    for got, want, tol in ((u0, u01, 1e-5), (J, J1, 1e-4), (ms.nominal, ms1.nominal, 1e-5)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=tol, rtol=0)


def test_k2_wrapper_span_is_on_the_clock_of_a_cuda_trace(cuda):
    """The spans of `utils.profiling` on the axis of a trace of CUDA activity
    alone (as the benchmark profiles): `trace_base_ns()` is the trace's
    origin, the n-th K2 kernel starts after the n-th `k2.wrapper` span
    starts, and the runtime call that launched it lies inside that span
    (within 20 us), over 20 fused solves at K=256, H=50. Prints the
    readings."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from gym_kmanip_torch.dynamics.state import init_state
    from gym_kmanip_torch.mpc import mppi
    from gym_kmanip_torch.utils import profiling

    m = get_model("solo_arm")
    cfg = mppi.MPPIConfig(n_samples=256)
    solve = mppi.make_fused_pick_solver(m, cfg)
    st, s0 = mppi.init_mppi(m, cfg, device=cuda), init_state(m, device=cuda)
    for _ in range(3):  # the build and the warm-up
        st, u0, _ = solve(st, s0)
    torch.cuda.synchronize()
    base = profiling.trace_base_ns()
    profiling.clear_spans()
    n = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            st, u0, _ = solve(st, s0)
            u0.cpu()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = trace["traceEvents"]
    assert trace.get("baseTimeNanoseconds", 0) == base
    spans = [s for s in profiling.spans() if s.name == "k2.wrapper"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and "rollout_pick_kernel" in e.get("name", "")), key=lambda e: e["ts"])
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    assert len([s for s in profiling.spans() if s.name == "mppi.solve"]) == n
    assert len(spans) == len(kernels) == n
    readings = []
    for s, k in zip(spans, kernels):
        a, b = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
        call = runtime[k["args"]["correlation"]]
        readings.append((call["ts"] - a, b - (call["ts"] + call["dur"]), k["ts"] - a, b - a))
        assert k["ts"] >= a
        assert a - 20.0 <= call["ts"] and call["ts"] + call["dur"] <= b + 20.0
    print("k2.wrapper against K2's launch, us (launch start - span start, span end - launch "
          "end, kernel start - span start, span length), min / median / max:")
    for name, col in zip(("launch_after_start", "end_after_launch", "kernel_after_start",
                          "span"), zip(*readings)):
        col = sorted(col)
        print(f"  {name}: {col[0]:.2f} / {col[len(col) // 2]:.2f} / {col[-1]:.2f}")
