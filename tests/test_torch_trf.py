"""The port's batched TRF driver and IK solvers (solvers/trf.py,
solvers/ik.py) against the float64 host solver and scipy. No JAX.

The problems are the env's regime on the solo arm: receding goals of one
EE_POS_DELTA step from the previous solution, warm-started there, with the
previous qpos as the regularization's q_prev (tests/test_ik.py:158-200).
Seeded sequences replayed through `ik_host.trf_np` (scipy's TRF, float64)
give gtol exits, plain xtol exits and xtol exits under trust-radius
collapse, where the last evaluated point is a rejected trial. Bands:
- the float64 driver on the port's own numpy residual and Jacobian against
  `trf_np`: x and x_last_eval to 1e-10, equal status (measured <= 3e-11);
- a batch against each problem solved alone: equal;
- float32 `ik_trf` against the float64 host solve: 1e-3 rad
  (tests/test_ik.py:200);
- float32 `ik` (the fixed-budget LM) against scipy's least_squares on the
  same residual: 2e-3 (tests/test_ik.py:96).
"""

from functools import partial

import numpy as np
import pytest
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.solvers import ik, ik_host, trf

torch.set_num_threads(1)

MASK = [int(i) for i in k.Q_ID_R_MASK_SOLO]
SITE = "eer_site"
# (sequence seed, step): gtol exits, plain xtol exits and the two xtol exits
# under trust-radius collapse of the first 20 steps of seeds 0 and 1
PICKS = ((0, 0), (0, 4), (0, 9), (0, 14), (0, 15), (1, 9), (1, 13), (1, 19))


@pytest.fixture(scope="module")
def solo():
    m = get_model("solo_arm")
    home = np.asarray(m.home_qpos, np.float64)
    xpos, xquat, _ = ik_host.fk_np(m, home)
    p0, quat0 = ik_host.site_pose_np(m, xpos, xquat, SITE)
    return m, home, p0, quat0


def _np_fns(m, qpos, goal, goal_orn, q_home, q_prev):
    res = partial(ik_host._residual_np, m, qpos_full=qpos, goal_pos=goal, goal_orn=goal_orn,
                  q_home=q_home[MASK], q_prev=q_prev[MASK], mask=MASK, site_name=SITE)
    jac = partial(ik_host._jacobian_np, m, qpos_full=qpos, goal_orn=goal_orn, mask=MASK,
                  site_name=SITE)
    return (lambda q: res(q_masked=q)), (lambda q: jac(q_masked=q))


@pytest.fixture(scope="module")
def problems(solo):
    """The PICKS problems as (qpos, goal, q_prev), each with trf_np's
    (x, x_last, status); then one warm start outside the joint range."""
    m, home, p0, quat0 = solo
    lo, hi = m.jnt_range[MASK, 0], m.jnt_range[MASK, 1]
    out = []
    for seed in sorted({s for s, _ in PICKS}):
        rng = np.random.RandomState(seed)
        q, prev, goal = home.copy(), home.copy(), p0.copy()
        for t in range(max(t for s, t in PICKS if s == seed) + 1):
            goal = goal + rng.uniform(-1, 1, 3) * k.EE_POS_DELTA
            res, jac = _np_fns(m, q, goal, quat0, home, prev)
            x, x_last, status = ik_host.trf_np(res, jac, q[MASK], lo, hi)
            if (seed, t) in PICKS:
                out.append((q.copy(), goal.copy(), prev.copy(), (x, x_last, status)))
            prev, q = q, q.copy()
            q[MASK] = x
    q = home.copy()
    q[MASK[1]] = lo[1] - 0.05  # the shoulder past its lower stop
    goal = p0 + np.array([0.01, -0.01, 0.01])
    res, jac = _np_fns(m, q, goal, quat0, home, q)
    out.append((q, goal, q.copy(), ik_host.trf_np(res, jac, q[MASK], lo, hi)))
    return out


def _torch_fns(m, quat0, home, batch):
    """res_fn and jac_fn over a (B, n) batch, each row through the numpy
    residual and Jacobian of its own problem, as float64 tensors."""
    fns = [_np_fns(m, q, g, quat0, home, prev) for q, g, prev, _ in batch]

    def res_fn(x):
        return torch.as_tensor(np.stack([f(xi) for (f, _), xi in zip(fns, x.numpy())]))

    def jac_fn(x):
        return torch.as_tensor(np.stack([j(xi) for (_, j), xi in zip(fns, x.numpy())]))

    return res_fn, jac_fn


def _driver(solo, batch):
    m, home, _, quat0 = solo
    lo, hi = (torch.as_tensor(m.jnt_range[MASK, i]) for i in (0, 1))
    x0 = torch.as_tensor(np.stack([q[MASK] for q, _, _, _ in batch]))
    return trf.least_squares_trf(*_torch_fns(m, quat0, home, batch), x0, lo, hi)


def test_problems_cover_the_exits(problems):
    statuses = [status for *_, (x, x_last, status) in problems]
    collapses = [np.abs(x - x_last).max() > 0 for *_, (x, x_last, _) in problems]
    assert 1 in statuses and 3 in statuses
    assert sum(collapses) >= 2, collapses


def test_driver_float64_matches_trf_np(solo, problems):
    out = _driver(solo, problems)
    assert out.x.dtype == torch.float64
    for i, (*_, (x, x_last, status)) in enumerate(problems):
        assert int(out.status[i]) == status, i
        np.testing.assert_allclose(out.x[i].numpy(), x, atol=1e-10, rtol=0, err_msg=str(i))
        np.testing.assert_allclose(out.x_last_eval[i].numpy(), x_last, atol=1e-10, rtol=0,
                                   err_msg=str(i))
        f = _torch_fns(solo[0], solo[3], solo[1], problems[i:i + 1])[0](out.x[i:i + 1])
        np.testing.assert_allclose(float(out.cost[i]), 0.5 * float((f * f).sum()), rtol=1e-12)


def test_driver_batch_equals_each_alone(solo, problems):
    batch = _driver(solo, problems)
    for i in range(len(problems)):
        alone = _driver(solo, problems[i:i + 1])
        for name in trf.TRFResult._fields:
            assert torch.equal(getattr(alone, name)[0], getattr(batch, name)[i]), (i, name)


def test_driver_counts_trials_and_syncs(solo, problems):
    before = dict(trf.counts)
    out = _driver(solo, problems[:3])
    solves, trials, syncs = (trf.counts[key] - before[key] for key in ("solves", "trials", "syncs"))
    # an item takes one trial per residual evaluation after the first, and
    # one more for a gtol exit (found at the top of a trial that then
    # evaluates nothing); the loop runs until the slowest item stops, and
    # reads once more than it takes trials
    per_item = out.nfev - 1 + (out.status == 1).int()
    assert solves == 1 and trials == int(per_item.max()) and syncs == trials + 1


def _ik_inputs(problems, dtype):
    qpos = torch.as_tensor(np.stack([q for q, _, _, _ in problems]), dtype=dtype)
    goal = torch.as_tensor(np.stack([g for _, g, _, _ in problems]), dtype=dtype)
    prev = torch.as_tensor(np.stack([p for _, _, p, _ in problems]), dtype=dtype)
    return qpos, goal, prev


def test_ik_trf_float32_matches_host_float64(solo, problems):
    m, home, _, quat0 = solo
    qpos, goal, prev = _ik_inputs(problems, torch.float32)
    orn = torch.as_tensor(quat0, dtype=torch.float32).expand(len(problems), 4)
    home32 = torch.as_tensor(home, dtype=torch.float32)
    q_sol, q_scrib = ik.ik_trf(m, qpos, goal, orn, home32, prev, q_mask=tuple(MASK),
                               site_name=SITE)
    assert q_sol.dtype == torch.float32 and q_sol.shape == (len(problems), len(MASK))
    for i, (q, g, p, _) in enumerate(problems):
        want_sol, want_scrib = ik_host.solve_host(
            qpos[i].double().numpy(), goal[i].double().numpy(), quat0, home, prev[i].double().numpy(),
            model=m, q_mask=tuple(MASK), site_name=SITE)
        np.testing.assert_allclose(q_sol[i].numpy(), want_sol, atol=1e-3, rtol=0, err_msg=str(i))
        np.testing.assert_allclose(q_scrib[i].numpy(), want_scrib, atol=1e-3, rtol=0,
                                   err_msg=str(i))
    # the out-of-range warm start: kept (then clipped) with no scribble
    q0 = qpos[-1, MASK]
    assert torch.equal(q_scrib[-1], q0)
    assert torch.equal(q_sol[-1], torch.clamp(q0, torch.as_tensor(m.jnt_range[MASK, 0]).float(),
                                              torch.as_tensor(m.jnt_range[MASK, 1]).float()))
    # one problem alone equals its row of the batch
    alone = ik.ik_trf(m, qpos[4], goal[4], orn[4], home32, prev[4], q_mask=tuple(MASK),
                      site_name=SITE)
    assert torch.equal(alone[0], q_sol[4]) and torch.equal(alone[1], q_scrib[4])


def test_subquat_jac_b_matches_finite_differences():
    """The closed-form Db against central differences of subQuat(qa, qb *
    _quat_from_tangent(e)) in float64, off and near the identity."""
    from gym_kmanip_torch.utils import rotations as rot

    rng = np.random.default_rng(0)
    qa = torch.as_tensor(rng.normal(size=(4, 4)))
    qa = qa / qa.norm(dim=-1, keepdim=True)
    qb = qa.clone()
    qb[:2] = torch.as_tensor(rng.normal(size=(2, 4)))
    qb = qb / qb.norm(dim=-1, keepdim=True)
    qb[3] = rot.quat_mul(qa[3], torch.tensor([1.0, 1e-3, -2e-3, 5e-4], dtype=torch.float64))
    got = ik._subquat_jac_b(qa, qb)
    h = 1e-6
    for j in range(3):
        e = torch.zeros(4, 3, dtype=torch.float64)
        e[:, j] = h
        fd = (rot.quat_sub(qa, rot.quat_mul(qb, ik._quat_from_tangent(e)))
              - rot.quat_sub(qa, rot.quat_mul(qb, ik._quat_from_tangent(-e)))) / (2 * h)
        np.testing.assert_allclose(got[..., j].numpy(), fd.numpy(), atol=1e-8, rtol=0)


def test_ik_matches_scipy_least_squares(solo):
    """tests/test_ik.py:61-96 on the port: three goals within 2 cm of the
    home EE; scipy's least_squares on the port's float32 residual and its
    exact Jacobian (which `ik` uses), cast to float64, against `ik`."""
    from scipy.optimize import least_squares

    m, home, p0, quat0 = solo
    lo, hi = m.jnt_range[MASK, 0], m.jnt_range[MASK, 1]
    rng = np.random.RandomState(1)
    goals = np.stack([p0 + rng.uniform(-1, 1, 3) * 0.02 for _ in range(3)])
    h32 = torch.as_tensor(home, dtype=torch.float32)
    orn = torch.as_tensor(quat0, dtype=torch.float32)
    got = ik.ik(m, h32, torch.as_tensor(goals, dtype=torch.float32), orn, h32, h32,
                q_mask=tuple(MASK), site_name=SITE)
    assert got.shape == (3, len(MASK))
    for i, goal in enumerate(goals):
        def res_jac(q):
            r, J = ik._exact_jacobian(m, torch.as_tensor(q, dtype=torch.float32)[None], h32[None],
                                      torch.as_tensor(goal, dtype=torch.float32)[None],
                                      orn[None], h32[MASK], h32[MASK], tuple(MASK), SITE)
            return r[0].double().numpy(), J[0].double().numpy()

        ref = least_squares(lambda q: res_jac(q)[0], home[MASK], jac=lambda q: res_jac(q)[1],
                            bounds=(lo, hi))
        np.testing.assert_allclose(got[i].numpy(), ref.x, atol=2e-3, rtol=0, err_msg=str(i))
        # the exact Jacobian is the residual's: float32 central differences
        # at h = 1e-2 (truncation and rounding each ~1e-5) agree
        J = res_jac(ref.x)[1]
        fd = np.stack([(res_jac(ref.x + d)[0] - res_jac(ref.x - d)[0]) / 2e-2
                       for d in 1e-2 * np.eye(len(MASK))], axis=-1)
        np.testing.assert_allclose(J, fd, atol=2e-4, rtol=0)
