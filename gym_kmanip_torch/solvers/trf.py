"""Bounded least-squares Trust-Region-Reflective solver over a batch.

Port of `gym_kmanip_tpu/solvers/trf.py`: the Branch-Coleman-Li STIR
algorithm with the semantics of scipy's dense path
(`least_squares(method='trf', tr_solver='exact', x_scale=1)`): Coleman-Li
scaling, the SVD trust-region subproblem with a Newton iteration on the
damping, reflected / truncated / gradient step selection, scipy's radius
update and termination rules, and scipy's defaults (ftol = xtol = gtol =
1e-8, max_nfev = 100 n).

Every tensor carries the batch as its leading dimension: x is (B, n), the
residual (B, m), the Jacobian (B, m, n). The JAX version's
`vmap(while_loop)` is kept exactly: one loop trial is one trust-region
trial (one residual evaluation) for every item, the loop runs while any
item is still running with nfev < max_nfev, and an item that has stopped
is frozen by `torch.where`, so its extra trials change nothing. The
Jacobian at the trial point is evaluated on every trial and selected where
the trial is accepted (the JAX version's `lax.cond` under vmap). So an item
solved inside a batch equals the same item solved alone.

The loop is Python: before each trial it reads whether any item still runs
(a host synchronization; the SVD synchronizes as well). `counts` holds,
over all calls, the solves, the trials and the termination reads.
"""

from typing import Callable, NamedTuple, Optional

import torch

_RUNNING = -1  # internal "no termination yet" status
# the cuSOLVER driver of torch.linalg.svd on CUDA tensors (None: torch's
# choice); the CPU ignores it
SVD_DRIVER = "gesvdj"
counts = {"solves": 0, "trials": 0, "syncs": 0}


class TRFResult(NamedTuple):
    x: torch.Tensor  # (B, n) solution
    cost: torch.Tensor  # (B,) 0.5 * |f|^2 at x
    status: torch.Tensor  # (B,) int: 0 max_nfev, 1 gtol, 2 ftol, 3 xtol, 4 both
    nfev: torch.Tensor  # (B,) int residual evaluations
    # (B, n) the LAST point the residual was evaluated at: x after a normal
    # exit, the rejected trial point after an xtol exit under trust-radius
    # collapse (the reference's IK scribbles this point into its qpos)
    x_last_eval: torch.Tensor


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(x):
    return torch.sqrt(_dot(x, x))


def _mv(A, x):
    """A (..., r, c) times x (..., c)."""
    return torch.sum(A * x[..., None, :], dim=-1)


def _cl_scaling(x, g, lb, ub):
    """Coleman-Li scaling vector v and its derivative dv."""
    m1 = g < 0
    m2 = g > 0
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    v = torch.where(m1, ub - x, torch.where(m2, x - lb, one))
    dv = torch.where(m1, -one, torch.where(m2, one, zero))
    return v, dv


def _strictly_feasible(x, lb, ub, rstep: float):
    """scipy's make_strictly_feasible: points on or past a bound moved just
    inside it (by one ulp with rstep = 0)."""
    if rstep == 0:
        lower = x <= lb
        upper = x >= ub
        x_new = torch.where(lower, torch.nextafter(lb, ub),
                            torch.where(upper, torch.nextafter(ub, lb), x))
    else:
        lower_thr = rstep * torch.clamp(torch.abs(lb), min=1.0)
        upper_thr = rstep * torch.clamp(torch.abs(ub), min=1.0)
        lower_dist, upper_dist = x - lb, ub - x
        lower = lower_dist <= torch.minimum(upper_dist, lower_thr)
        upper = upper_dist <= torch.minimum(lower_dist, upper_thr)
        x_new = torch.where(lower, lb + lower_thr, torch.where(upper, ub - upper_thr, x))
    tight = (x_new < lb) | (x_new > ub)
    return torch.where(tight, 0.5 * (lb + ub), x_new)


def _step_size_to_bound(x, s, lb, ub):
    """Largest stride t >= 0 with x + t s in bounds (B,), and the hit mask."""
    nz = s != 0
    s_safe = torch.where(nz, s, torch.ones_like(s))
    steps = torch.where(nz, torch.maximum((lb - x) / s_safe, (ub - x) / s_safe),
                        torch.full_like(s, torch.inf))
    min_step = torch.amin(steps, dim=-1)
    return min_step, (steps == min_step[..., None]) & nz


def _intersect_trust_region(x, s, Delta):
    """Both roots t of |x + t s| = Delta (t1 <= t2)."""
    a = _dot(s, s)
    b = _dot(x, s)
    c = _dot(x, x) - Delta * Delta
    a_safe = torch.where(a > 0, a, torch.ones_like(a))
    d = torch.sqrt(torch.clamp(b * b - a * c, min=0.0))
    q = -(b + torch.sign(b) * d + torch.where(b == 0, d, torch.zeros_like(d)))
    q_safe = torch.where(q != 0, q, torch.ones_like(q))
    t1 = q / a_safe
    t2 = torch.where(q != 0, c / q_safe, torch.zeros_like(q))
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def _build_quadratic_1d(J, g, s, diag, s0=None):
    """psi(t) = 0.5 |J (s0 + t s)|^2 + g.(s0 + t s) + 0.5 diag term, as
    coefficients (a, b[, c])."""
    v = _mv(J, s)
    a = 0.5 * (_dot(v, v) + _dot(s * diag, s))
    b = _dot(g, s)
    if s0 is None:
        return a, b
    u = _mv(J, s0)
    b = b + _dot(u, v) + _dot(s0 * diag, s)
    c = 0.5 * _dot(u, u) + _dot(g, s0) + 0.5 * _dot(s0 * diag, s0)
    return a, b, c


def _minimize_quadratic_1d(a, b, lb, ub, c=0.0):
    a_safe = torch.where(a != 0, a, torch.ones_like(a))
    ext = -0.5 * b / a_safe
    use_ext = (a != 0) & (lb < ext) & (ext < ub)
    ts = torch.stack([lb, ub, torch.where(use_ext, ext, lb)], dim=-1)
    ys = ts * (a[..., None] * ts + b[..., None]) + (c[..., None] if torch.is_tensor(c) else c)
    i = torch.argmin(ys, dim=-1, keepdim=True)  # the first minimum, as jnp.argmin
    return ts.gather(-1, i)[..., 0], ys.gather(-1, i)[..., 0]


def _evaluate_quadratic(J, g, s, diag):
    Js = _mv(J, s)
    return 0.5 * (_dot(Js, Js) + _dot(s * diag, s)) + _dot(s, g)


def _update_tr_radius(Delta, actual, predicted, step_norm, bound_hit):
    one, zero = torch.ones_like(actual), torch.zeros_like(actual)
    ratio = torch.where(
        predicted > 0, actual / torch.where(predicted > 0, predicted, one),
        torch.where((predicted == 0) & (actual == 0), one, zero))
    Delta_new = torch.where(ratio < 0.25, 0.25 * step_norm,
                            torch.where((ratio > 0.75) & bound_hit, Delta * 2.0, Delta))
    return Delta_new, ratio


def _check_termination(dF, F, dx_norm, x_norm, ratio, ftol, xtol):
    ftol_ok = (dF < ftol * F) & (ratio > 0.25)
    xtol_ok = dx_norm < xtol * (xtol + x_norm)
    status = torch.full(dF.shape, _RUNNING, dtype=torch.int32, device=dF.device)
    status = torch.where(xtol_ok, 3, status)
    status = torch.where(ftol_ok, 2, status)
    return torch.where(ftol_ok & xtol_ok, 4, status).to(torch.int32)


def _solve_lsq_trust_region(m: int, n: int, uf, s, V, Delta, initial_alpha, eps: float,
                            rtol: float = 0.01, max_iter: int = 10):
    """min |J_aug p + f_aug| subject to |p| <= Delta from the SVD (s, V,
    U^T f), with a fixed max_iter-step Newton iteration on the damping
    alpha under a `done` mask (scipy's 'exact' solver). m and n are the
    ORIGINAL residual and parameter counts, which scipy's full-rank
    threshold uses."""
    suf = s * uf
    tiny = torch.finfo(s.dtype).tiny
    one = torch.ones_like(Delta)

    def phi_and_derivative(alpha):
        denom = s * s + alpha[..., None]
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        q = suf / denom
        p_norm = _norm(q)
        p_norm_safe = torch.where(p_norm > 0, p_norm, one)
        phi = p_norm - Delta
        phi_prime = -torch.sum(suf * suf / (denom * denom * denom), dim=-1) / p_norm_safe
        phi_prime = torch.where(phi_prime < 0, phi_prime, torch.full_like(phi_prime, -tiny))
        return phi, phi_prime

    if m >= n:
        full_rank = s[..., -1] > eps * m * s[..., 0]
    else:
        full_rank = torch.zeros_like(Delta, dtype=torch.bool)

    s_safe = torch.where(s > 0, s, torch.ones_like(s))
    p_newton = -_mv(V, uf / s_safe)
    interior = full_rank & (_norm(p_newton) <= Delta)

    alpha_upper = _norm(suf) / Delta
    phi0, phip0 = phi_and_derivative(torch.zeros_like(Delta))
    alpha_lower = torch.where(full_rank, -phi0 / phip0, torch.zeros_like(Delta))
    alpha = torch.where(
        (~full_rank) & (initial_alpha == 0),
        torch.maximum(0.001 * alpha_upper, torch.sqrt(alpha_lower * alpha_upper)),
        initial_alpha)

    al, au = alpha_lower, alpha_upper
    done = torch.zeros_like(full_rank)
    for _ in range(max_iter):
        alpha_adj = torch.where((alpha < al) | (alpha > au),
                                torch.maximum(0.001 * au, torch.sqrt(al * au)), alpha)
        phi, phip = phi_and_derivative(alpha_adj)
        au_new = torch.where(phi < 0, alpha_adj, au)
        ratio = phi / phip
        al_new = torch.maximum(al, alpha_adj - ratio)
        alpha_new = alpha_adj - (phi + Delta) * ratio / Delta
        done_new = done | (torch.abs(phi) < rtol * Delta)
        alpha = torch.where(done, alpha, alpha_new)
        al = torch.where(done, al, al_new)
        au = torch.where(done, au, au_new)
        done = done_new

    denom = s * s + alpha[..., None]
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    p_raw = -_mv(V, suf / denom)
    pn = _norm(p_raw)
    p_damped = p_raw * (Delta / torch.where(pn > 0, pn, one))[..., None]
    p = torch.where(interior[..., None], p_newton, p_damped)
    return p, torch.where(interior, torch.zeros_like(alpha), alpha)


def _select_step(x, J_h, diag_h, g_h, p, p_h, d, Delta, lb, ub, theta):
    """STIR step selection: the full trust-region step if it stays in
    bounds, else the best of the truncated step, its reflection off the
    bound and the projected scaled gradient. Returns (step, step_h,
    predicted reduction)."""
    inb = torch.all((x + p >= lb) & (x + p <= ub), dim=-1)
    p_value_full = _evaluate_quadratic(J_h, g_h, p_h, diag_h)

    p_stride, hits = _step_size_to_bound(x, p, lb, ub)
    r_h = torch.where(hits, -p_h, p_h)
    r = d * r_h
    p_tr = p * p_stride[..., None]
    p_h_tr = p_h * p_stride[..., None]
    x_on_bound = x + p_tr

    _, to_tr = _intersect_trust_region(p_h_tr, r_h, Delta)
    to_bound, _ = _step_size_to_bound(x_on_bound, r, lb, ub)
    r_stride = torch.minimum(to_bound, to_tr)
    pos = r_stride > 0
    r_stride_safe = torch.where(pos, r_stride, torch.ones_like(r_stride))
    r_stride_l = torch.where(pos, (1 - theta) * p_stride / r_stride_safe,
                             torch.zeros_like(r_stride))
    r_stride_u = torch.where(pos, torch.where(r_stride == to_bound, theta * to_bound, to_tr),
                             -torch.ones_like(r_stride))
    valid_r = r_stride_l <= r_stride_u

    a, b, c = _build_quadratic_1d(J_h, g_h, r_h, diag_h, s0=p_h_tr)
    r_stride_min, r_value = _minimize_quadratic_1d(
        a, b, r_stride_l, torch.where(valid_r, r_stride_u, r_stride_l), c)
    r_h_final = r_h * r_stride_min[..., None] + p_h_tr
    r_final = r_h_final * d
    r_value = torch.where(valid_r, r_value, torch.full_like(r_value, torch.inf))

    p_theta = p * theta[..., None]
    p_h_theta = p_h * theta[..., None]
    p_value = _evaluate_quadratic(J_h, g_h, p_h_theta, diag_h)

    ag_h = -g_h
    ag = d * ag_h
    ag_h_norm = _norm(ag_h)
    to_tr_g = Delta / torch.where(ag_h_norm > 0, ag_h_norm, torch.ones_like(ag_h_norm))
    to_bound_g, _ = _step_size_to_bound(x, ag, lb, ub)
    ag_stride_max = torch.where(to_bound_g < to_tr_g, theta * to_bound_g, to_tr_g)
    a2, b2 = _build_quadratic_1d(J_h, g_h, ag_h, diag_h)
    ag_stride, ag_value = _minimize_quadratic_1d(a2, b2, torch.zeros_like(a2), ag_stride_max)
    ag_h_final = ag_h * ag_stride[..., None]
    ag_final = ag * ag_stride[..., None]

    use_p = (p_value < r_value) & (p_value < ag_value)
    use_r = (r_value < p_value) & (r_value < ag_value)

    def pick(cp, cr, cag):
        up, ur = use_p, use_r
        if cp.dim() > up.dim():
            up, ur = up[..., None], ur[..., None]
        return torch.where(up, cp, torch.where(ur, cr, cag))

    step = torch.where(inb[..., None], p, pick(p_theta, r_final, ag_final))
    step_h = torch.where(inb[..., None], p_h, pick(p_h_theta, r_h_final, ag_h_final))
    value = torch.where(inb, p_value_full, pick(p_value, r_value, ag_value))
    return step, step_h, -value


class _State(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    cost: torch.Tensor
    J: torch.Tensor
    g: torch.Tensor
    Delta: torch.Tensor
    alpha: torch.Tensor
    nfev: torch.Tensor
    status: torch.Tensor
    x_last: torch.Tensor


def _select(mask, new: _State, old: _State) -> _State:
    return _State(*(torch.where(mask.view(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)
                    for a, b in zip(new, old)))


def least_squares_trf(
    res_fn: Optional[Callable[[torch.Tensor], torch.Tensor]],
    jac_fn: Optional[Callable[[torch.Tensor], torch.Tensor]],
    x0: torch.Tensor,
    lb: torch.Tensor,
    ub: torch.Tensor,
    *,
    res_jac_fn: Optional[Callable] = None,
    ftol: float = 1e-8,
    xtol: float = 1e-8,
    gtol: float = 1e-8,
    max_nfev: Optional[int] = None,
    active: Optional[torch.Tensor] = None,
) -> TRFResult:
    """scipy.optimize.least_squares(method='trf') on every item of a batch:
    x0 (B, n), bounds (n,) or (B, n), res_fn (B, n) -> (B, m), jac_fn
    (B, n) -> (B, m, n). `res_jac_fn(x) -> (f, J)` may stand in for both,
    when one evaluation computes the two more cheaply. The working dtype is
    x0's (float32 on the device, float64 in the tests). Items where the
    (B,) mask `active` is False are not solved: they keep their strictly
    feasible start, with nfev 1 and status 0, and take no trial (a caller
    that discards their result saves the trials a stalled item costs the
    whole batch)."""
    if res_jac_fn is None:
        def res_jac_fn(x):
            return res_fn(x), jac_fn(x)

    dtype, device = x0.dtype, x0.device
    n = x0.shape[-1]
    eps = torch.finfo(dtype).eps
    if max_nfev is None:
        max_nfev = 100 * n
    lb = torch.as_tensor(lb, dtype=dtype, device=device).expand_as(x0)
    ub = torch.as_tensor(ub, dtype=dtype, device=device).expand_as(x0)

    x_init = _strictly_feasible(x0.to(dtype), lb, ub, 1e-10)
    f_init, J_init = res_jac_fn(x_init)
    m = f_init.shape[-1]
    g_init = torch.sum(J_init * f_init[..., None], dim=-2)
    v0, _ = _cl_scaling(x_init, g_init, lb, ub)
    Delta_init = _norm(x_init / torch.sqrt(v0))
    Delta_init = torch.where(Delta_init == 0, torch.ones_like(Delta_init), Delta_init)
    batch = x0.shape[:-1]
    state = _State(
        x=x_init, f=f_init, cost=0.5 * _dot(f_init, f_init), J=J_init, g=g_init,
        Delta=Delta_init, alpha=torch.zeros(batch, dtype=dtype, device=device),
        nfev=torch.ones(batch, dtype=torch.int32, device=device),
        status=torch.full(batch, _RUNNING, dtype=torch.int32, device=device),
        x_last=x_init,
    )
    if active is not None:
        state = state._replace(status=torch.where(active, state.status, 0).to(torch.int32))

    def trial(s: _State) -> _State:
        v, dv = _cl_scaling(s.x, s.g, lb, ub)
        g_norm = torch.amax(torch.abs(s.g * v), dim=-1)
        d = torch.sqrt(v)
        diag_h = s.g * dv
        g_h = d * s.g
        J_h = s.J * d[..., None, :]
        J_aug = torch.cat([J_h, torch.diag_embed(torch.sqrt(diag_h))], dim=-2)
        U, sv, Vh = torch.linalg.svd(J_aug, full_matrices=False,
                                     driver=SVD_DRIVER if J_aug.is_cuda else None)
        uf = torch.sum(U[..., :m, :] * s.f[..., None], dim=-2)
        theta = torch.clamp(1 - g_norm, min=0.995)

        p_h, alpha_new = _solve_lsq_trust_region(m, n, uf, sv, Vh.mT, s.Delta, s.alpha, eps)
        p = d * p_h
        step, step_h, pred_red = _select_step(s.x, J_h, diag_h, g_h, p, p_h, d, s.Delta,
                                              lb, ub, theta)
        x_new = _strictly_feasible(s.x + step, lb, ub, 0)
        # the Jacobian at every trial point, selected where it is accepted
        f_new, J_new = res_jac_fn(x_new)
        step_h_norm = _norm(step_h)
        finite = torch.all(torch.isfinite(f_new), dim=-1)
        cost_new = 0.5 * _dot(f_new, f_new)
        actual_red = s.cost - cost_new
        Delta_upd, ratio = _update_tr_radius(s.Delta, actual_red, pred_red, step_h_norm,
                                             step_h_norm > 0.95 * s.Delta)
        term = _check_termination(actual_red, s.cost, _norm(step), _norm(s.x), ratio,
                                  ftol, xtol)
        term = torch.where(finite, term, _RUNNING)
        # gtol fires at the top of scipy's outer loop, before this trial: it
        # wins over a same-trial termination and discards the trial's eval
        gtol_hit = g_norm < gtol
        status = torch.where(gtol_hit, 1, term).to(torch.int32)
        terminated = status != _RUNNING
        accept = (~gtol_hit) & finite & (actual_red > 0)

        Delta_next = torch.where(finite & ~terminated, Delta_upd,
                                 torch.where(finite, s.Delta, 0.25 * step_h_norm))
        alpha_next = torch.where(
            finite & ~terminated,
            alpha_new * (s.Delta / torch.where(Delta_upd > 0, Delta_upd,
                                               torch.ones_like(Delta_upd))),
            alpha_new)
        alpha_next = torch.where(gtol_hit, s.alpha, alpha_next)
        nfev = torch.where(gtol_hit, s.nfev, s.nfev + 1)
        # scipy stops BEFORE this trial on gtol: its residual was never
        # evaluated there, so the previous scribble point stays
        x_last = torch.where(gtol_hit[..., None], s.x_last, x_new)

        acc = accept[..., None]
        f_acc = torch.where(acc, f_new, s.f)
        J_acc = torch.where(acc[..., None], J_new, s.J)
        return _State(
            x=torch.where(acc, x_new, s.x), f=f_acc,
            cost=torch.where(accept, cost_new, s.cost), J=J_acc,
            g=torch.sum(J_acc * f_acc[..., None], dim=-2), Delta=Delta_next,
            alpha=alpha_next, nfev=nfev, status=status, x_last=x_last)

    trials = syncs = 0
    while True:
        running = (state.status == _RUNNING) & (state.nfev < max_nfev)
        syncs += 1
        if not bool(running.any()):
            break
        state = _select(running, trial(state), state)
        trials += 1

    counts["solves"] += 1
    counts["trials"] += trials
    counts["syncs"] += syncs
    status = torch.where(state.status == _RUNNING, 0, state.status)
    return TRFResult(x=state.x, cost=state.cost, status=status, nfev=state.nfev,
                     x_last_eval=state.x_last)
