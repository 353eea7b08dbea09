"""iLQR trajectory optimization over the manipulation state.

Port of `gym_kmanip_tpu/solvers/ilqr.py:50-622`. One solve is a nominal
rollout and `n_iters` iterations of

  * linearization: branch-consistent finite differences, all H x (n + m)
    probes (one-sided; centered with fd_order=2) as ONE batched substep
    call, so one substep-kernel launch per iteration on the card; or,
    with fd_linearize=False, the exact oracle `vmap(jacfwd)` through the
    plain substep;
  * cost quadratization: a user `quad_xu` (e.g. the Gauss-Newton model of
    `mpc.cost.make_ee_tracking_cost_ilqr`), else `torch.func` grad and
    hessian of `cost_xu`;
  * backward pass: the Riccati sweep kernel (ops/riccati_cuda) with the
    Gershgorin-adaptive lift and the adaptive `lam_extra`
    (`pallas_backward`), the O(log H) associative scan of
    solvers/parallel_lqr (`parallel_backward`), else a serial sweep with
    `torch.linalg.solve`;
  * forward pass: a line search over the fixed alpha schedule, all step
    sizes at once, through the whole-horizon feedback-rollout kernel
    (ops/rollout_feedback_cuda) on the reduced state of small robots, else
    through B-batched substep launches; best by `argmin`, accepted only if
    it lowers the cost.

Each kernel wrapper launches its kernel for a CUDA tensor and runs its
plain PyTorch version for a CPU tensor, so the solve runs on the device of
the state it is given. The iteration loop makes no host sync: the
accept/reject, the lam schedule and the cost trace stay on the device.

State layout x = [qpos, qvel, cube_pos, cube_quat, cube_linvel,
cube_angvel] (2 nq + 13), or [qpos, qvel] with `reduced_state`. Costs
`cost_xu(x, u)` take batched x (..., n) and u (..., nu) and return (...).
"""

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import func as tfunc

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics import engine
from gym_kmanip_torch.dynamics.state import SimState
from gym_kmanip_torch.models import model_tensors
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import riccati_cuda, rollout_feedback_cuda
from gym_kmanip_torch.solvers.parallel_lqr import LQRProblem, backward_associative


class ILQRConfig(NamedTuple):
    """The JAX package's ILQRConfig, field for field, so a config carries
    across. `fused_solve` (one XLA dispatch per solve there) changes
    nothing here: the port's solve is one Python loop either way."""

    horizon: int = 50
    n_iters: int = 10
    reg: float = 1e-6
    alphas: Tuple[float, ...] = (1.0, 0.6, 0.3, 0.1, 0.03, 0.01)
    n_substeps: int = 1
    dt: float = k.CONTROL_TIMESTEP
    # False for the smooth reach/track regime iLQR is built for (contact
    # at the 20 ms control rate is impact-dominated)
    contact: bool = True
    # the O(log H) associative-scan backward (solvers/parallel_lqr)
    parallel_backward: bool = False
    # the Riccati sweep kernel; False = serial sweep with linalg.solve
    pallas_backward: bool = True
    # finite-difference linearization; False = the jacfwd oracle
    fd_linearize: bool = True
    fd_eps: float = 1e-3
    # 1: one-sided probes (H x (n+m)); 2: centered (H x 2(n+m))
    fd_order: int = 1
    # forward passes through the fused routes (feedback kernel when on)
    fast_rollouts: bool = True
    fused_solve: bool = True
    # feedback-rollout kernel for the nominal rollout and line search;
    # None = on for nq <= 12. Needs reduced_state.
    fb_kernel: Optional[bool] = None
    # x = [qpos, qvel]: the cube is pinned at the state0 template (exact
    # only with contact=False, where nothing couples it to the robot)
    reduced_state: bool = False


class ILQRResult(NamedTuple):
    us: torch.Tensor  # (H, nu) optimized controls
    xs: torch.Tensor  # (H+1, n) optimized trajectory
    cost: torch.Tensor  # () final total cost
    cost_trace: torch.Tensor  # (n_iters,) cost after each iteration


class ILQROps(NamedTuple):
    """The three kernels a solve calls, as (kernel wrapper or plain
    version): the substep (`engine.substep` signature), the feedback
    rollout and the Riccati sweep."""

    substep: Callable
    rollout_feedback: Callable
    riccati_sweep: Callable


KERNEL_OPS = ILQROps(engine.substep, rollout_feedback_cuda.rollout_feedback,
                     riccati_cuda.riccati_sweep)
# the plain PyTorch versions on any device (the card's plain route)
PLAIN_OPS = ILQROps(engine._substep_torch, rollout_feedback_cuda.rollout_feedback_reference,
                    riccati_cuda.riccati_sweep_reference)


def flatten_state(s: SimState, reduced: bool = False) -> torch.Tensor:
    """(..., n) flat state of a (batched) SimState."""
    parts = [s.qpos, s.qvel]
    if not reduced:
        parts += [s.cube_pos, s.cube_quat, s.cube_linvel, s.cube_angvel]
    return torch.cat(parts, dim=-1)


def unflatten_state(model: RobotModel, x: torch.Tensor, template: SimState) -> SimState:
    """Inverse of flatten_state for x (..., n), layout by x's width: 2 nq
    + 13 is the full state; 2 nq the reduced one, whose cube comes from the
    unbatched `template`. ctrl and time come from the template; template
    fields are broadcast to x's batch."""
    nq = model.nq
    batch = x.shape[:-1]

    def bcast(a):
        return a.expand(batch + a.shape)

    if x.shape[-1] == 2 * nq:
        cube = tuple(bcast(a) for a in (template.cube_pos, template.cube_quat,
                                        template.cube_linvel, template.cube_angvel))
    else:
        cube = (x[..., 2 * nq: 2 * nq + 3], x[..., 2 * nq + 3: 2 * nq + 7],
                x[..., 2 * nq + 7: 2 * nq + 10], x[..., 2 * nq + 10: 2 * nq + 13])
    return SimState(qpos=x[..., :nq], qvel=x[..., nq: 2 * nq], ctrl=bcast(template.ctrl),
                    cube_pos=cube[0], cube_quat=cube[1], cube_linvel=cube[2],
                    cube_angvel=cube[3], time=bcast(template.time))


def _zero_final(x):
    return x.new_zeros(x.shape[:-1])


def _clip_u(model: RobotModel, u_init: torch.Tensor) -> torch.Tensor:
    """The warm start clipped to ctrl_range, once at solve entry (the
    feedback kernel's nominal rollout clips; the substep route does not)."""
    t = model_tensors(model, u_init.device)
    return torch.clamp(u_init, t.ctrl_lo, t.ctrl_hi)


def _fd_steps(V, v_lo, v_hi, eps: float):
    """Forward and backward probe sizes (JAX ilqr.py:266-277): centered in
    the interior, shrunk so no probe crosses a bound, one-sided away from a
    bound the point already sits outside."""
    sp = torch.clamp(v_hi - V, 0.0, eps)
    sm = torch.clamp(V - v_lo, 0.0, eps)
    above, below = V > v_hi, V < v_lo
    zero = torch.zeros_like(sp)
    sp = torch.where(above, eps, torch.where(below, zero, sp))
    sm = torch.where(above, zero, torch.where(below, eps, sm))
    return sp, sm


def _zero_quad_final(x):
    n = x.shape[-1]
    return x.new_zeros(n), x.new_zeros((n, n))


def _build_pieces(model: RobotModel, cfg: ILQRConfig, cost_xu, cost_final=None,
                  quad_xu=None, quad_final=None, ops: Optional[ILQROps] = None):
    """The solve's pieces: (rollout0, derivs, backward, linesearch,
    iteration), each taking the solve's state0 as `template`. `ops` None
    is `KERNEL_OPS` as it stands when the pieces are built."""
    ops = KERNEL_OPS if ops is None else ops
    if cost_final is None:
        cost_final = _zero_final
        quad_final = quad_final if quad_final is not None else _zero_quad_final
    if cfg.reduced_state and cfg.contact:
        raise ValueError(
            "reduced_state drops the cube from the solver state, which is "
            "only exact when contact=False (no robot<->cube coupling)"
        )
    if cfg.fd_order not in (1, 2):
        raise ValueError(f"fd_order is 1 or 2, not {cfg.fd_order}")
    nq, nu = model.nq, model.nu
    n = 2 * nq + (0 if cfg.reduced_state else 13)
    fb_wanted = cfg.fb_kernel if cfg.fb_kernel is not None else nq <= 12
    use_fb = fb_wanted and cfg.fast_rollouts and cfg.reduced_state
    consts = {}

    def const(device):
        """Per-device constants: state bounds, identities, alphas."""
        c = consts.get(device)
        if c is None:
            t = model_tensors(model, device)
            free = torch.full((n - nq,), float("inf"), device=device)
            c = consts[device] = dict(
                x_lo=torch.cat([t.jnt_lo, -free]), x_hi=torch.cat([t.jnt_hi, free]),
                u_lo=t.ctrl_lo, u_hi=t.ctrl_hi,
                Ex=torch.eye(n, device=device), Eu=torch.eye(nu, device=device),
                alphas=torch.tensor(cfg.alphas, dtype=torch.float32, device=device),
            )
        return c

    def f(x, u, template):
        """Batched dynamics (K, n), (K, nu) -> (K, n)."""
        s = unflatten_state(model, x, template)._replace(ctrl=u)
        for _ in range(cfg.n_substeps):
            s, _ = ops.substep(model, s, cfg.dt, cfg.contact, True)
        return flatten_state(s, reduced=cfg.reduced_state)

    def f_oracle(x, u, template):
        """Dynamics of one state (n,), (nu,) -> (n,) through the plain
        substep, for the jacfwd oracle (JAX ilqr.py:171-179, the lapack-path
        graph). The CUDA kernels have no derivative, so this runs the plain
        version on whatever device the state is on: the one place where a
        plain version runs on the card, by design, as the JAX oracle
        differentiates its jnp graph and not the Pallas kernel. The state
        carries a batch of one, since torch.func's forward mode promotes
        the tangent of a 0-dim tensor times a Python float to float64."""
        s = unflatten_state(model, x[None], template)._replace(ctrl=u[None])
        for _ in range(cfg.n_substeps):
            s, _ = engine._substep_torch(model, s, cfg.dt, cfg.contact, True)
        return flatten_state(s, reduced=cfg.reduced_state)[0]

    # the costs of one state, evaluated on a batch of one: torch.func's
    # forward mode promotes the tangent of a 0-dim tensor times a Python
    # float to float64, and an FK-bearing cost makes such products
    def cost1(x, u):
        return cost_xu(x[None], u[None])[0]

    def final1(x):
        return cost_final(x[None])[0]

    def total_cost(xs, us):
        return (cost_xu(xs[..., :-1, :], us).sum(-1) + cost_final(xs[..., -1, :]))

    def cube0(template):
        return torch.cat([template.cube_pos, template.cube_quat, template.cube_linvel,
                          template.cube_angvel])

    def rollout0(x0, us, template):
        H = us.shape[0]
        if use_fb:
            z = x0.new_zeros
            xs_t, us_c = ops.rollout_feedback(
                model, x0, cube0(template), z((H, n)), us, z((H, nu)), z((H, nu, n)),
                x0.new_ones(1), n_substeps=cfg.n_substeps, dt=cfg.dt,
            )
            xs = torch.cat([x0[None], xs_t[0]], dim=0)
            return xs, total_cost(xs, us_c[0])
        xs = [x0]
        for h in range(H):
            xs.append(f(xs[-1][None], us[h][None], template)[0])
        xs = torch.stack(xs)
        return xs, total_cost(xs, us)

    def fd_slopes(xs, us, template):
        """A and B by branch-consistent finite differences: all probes
        as one batched substep call."""
        c = const(xs.device)
        X, U = xs[:-1], us
        Hh = X.shape[0]
        eps = float(cfg.fd_eps)
        sxp, sxm = _fd_steps(X, c["x_lo"], c["x_hi"], eps)
        sup, sum_ = _fd_steps(U, c["u_lo"], c["u_hi"], eps)
        Ex, Eu = c["Ex"], c["Eu"]
        if cfg.fd_order == 1:
            # one probe per dim toward the roomier side; the nominal f(x, u)
            # is xs[t+1], already rolled out
            sx = torch.where(sxp >= sxm, sxp, -sxm)
            su = torch.where(sup >= sum_, sup, -sum_)
            sx = torch.where(torch.abs(sx) < 1e-12, eps, sx)
            su = torch.where(torch.abs(su) < 1e-12, eps, su)
            Xp = torch.cat([X[:, None, :] + sx[:, :, None] * Ex[None],
                            X[:, None, :].expand(Hh, nu, n)], dim=1)
            Up = torch.cat([U[:, None, :].expand(Hh, n, nu),
                            U[:, None, :] + su[:, :, None] * Eu[None]], dim=1)
            Y = f(Xp.reshape(-1, n), Up.reshape(-1, nu), template).reshape(Hh, n + nu, n)
            Y0 = xs[1:][:, None, :]
            A = ((Y[:, :n] - Y0) / sx[:, :, None]).transpose(1, 2)
            B = ((Y[:, n:] - Y0) / su[:, :, None]).transpose(1, 2)
        else:
            Xp = torch.cat([X[:, None, :] + sxp[:, :, None] * Ex[None],
                            X[:, None, :] - sxm[:, :, None] * Ex[None],
                            X[:, None, :].expand(Hh, 2 * nu, n)], dim=1)
            Up = torch.cat([U[:, None, :].expand(Hh, 2 * n, nu),
                            U[:, None, :] + sup[:, :, None] * Eu[None],
                            U[:, None, :] - sum_[:, :, None] * Eu[None]], dim=1)
            Y = f(Xp.reshape(-1, n), Up.reshape(-1, nu), template).reshape(
                Hh, 2 * (n + nu), n)
            A = ((Y[:, :n] - Y[:, n: 2 * n]) / (sxp + sxm)[:, :, None]).transpose(1, 2)
            B = ((Y[:, 2 * n: 2 * n + nu] - Y[:, 2 * n + nu:])
                 / (sup + sum_)[:, :, None]).transpose(1, 2)
        return A, B

    def derivs(xs, us, template):
        X, U = xs[:-1], us
        if cfg.fd_linearize:
            A, B = fd_slopes(xs, us, template)
        else:
            A, B = tfunc.vmap(tfunc.jacfwd(partial(f_oracle, template=template),
                                           argnums=(0, 1)))(X, U)
        if quad_xu is not None:
            cx, cu, cxx, cuu, cux = quad_xu(X, U)
        else:
            cx = tfunc.vmap(tfunc.grad(cost1, argnums=0))(X, U)
            cu = tfunc.vmap(tfunc.grad(cost1, argnums=1))(X, U)
            cxx = tfunc.vmap(tfunc.hessian(cost1, argnums=0))(X, U)
            cuu = tfunc.vmap(tfunc.hessian(cost1, argnums=1))(X, U)
            cux = tfunc.vmap(tfunc.jacfwd(tfunc.grad(cost1, argnums=1), argnums=0))(X, U)
        if quad_final is not None:
            Vx_T, Vxx_T = quad_final(xs[-1])
        else:
            Vx_T = tfunc.grad(final1)(xs[-1])
            Vxx_T = tfunc.hessian(final1)(xs[-1])
        return A, B, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T

    def backward(A, B, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T, lam_extra):
        """Regularized backward sweep; `lam_extra` is the adaptive
        Levenberg multiplier (a 0-d tensor), threaded by `iteration`."""
        if cfg.parallel_backward:
            # the associative form has no per-step B'VxxB before the scan, so
            # the adaptive lift scales with |cuu| only: identical to the
            # serial path whenever lam_extra == 0
            eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
            amax_c = torch.amax(torch.abs(cuu), dim=(1, 2))[:, None, None] + 1.0
            prob = LQRProblem(A=A, B=B, d=A.new_zeros(A.shape[:2]), Q=cxx, q=cx,
                              R=cuu + (cfg.reg + lam_extra * amax_c) * eye_u, r=cu, L=cux,
                              Qf=Vxx_T, qf=Vx_T)
            Ks, ks = backward_associative(prob)
            return ks, Ks
        if cfg.pallas_backward:
            return ops.riccati_sweep(
                *(a.contiguous() for a in (A, B, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T)),
                cfg.reg, lam_extra=lam_extra,
            )
        eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
        Vx, Vxx = Vx_T, Vxx_T
        ks, Ks = [], []
        for t in range(A.shape[0] - 1, -1, -1):
            At, Bt = A[t], B[t]
            Qx = cx[t] + At.T @ Vx
            Qu = cu[t] + Bt.T @ Vx
            Qxx = cxx[t] + At.T @ Vxx @ At
            Quu = cuu[t] + Bt.T @ Vxx @ Bt + cfg.reg * eye_u
            Qux = cux[t] + Bt.T @ Vxx @ At
            Quu = 0.5 * (Quu + Quu.T)
            Quu = Quu + (lam_extra * torch.max(torch.abs(Quu))) * eye_u
            # solve_ex: no host sync to check for a singular matrix
            Kk = -torch.linalg.solve_ex(Quu, torch.cat([Qu[:, None], Qux], dim=1))[0]
            kff, K = Kk[:, 0], Kk[:, 1:]
            Vx = Qx + K.T @ Quu @ kff + K.T @ Qu + Qux.T @ kff
            Vxx = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            Vxx = 0.5 * (Vxx + Vxx.T)
            ks.append(kff)
            Ks.append(K)
        return torch.stack(ks[::-1]), torch.stack(Ks[::-1])

    def linesearch(x0, xs, us, ks, Ks, template):
        c = const(x0.device)
        alphas = c["alphas"]
        nA = alphas.shape[0]
        if use_fb:
            xs_t, us_c = ops.rollout_feedback(
                model, x0, cube0(template), xs[:-1].contiguous(), us.contiguous(),
                ks.contiguous(), Ks.contiguous(), alphas, n_substeps=cfg.n_substeps,
                dt=cfg.dt,
            )
            xs_c = torch.cat([x0.expand(nA, 1, n), xs_t], dim=1)
        else:
            x = x0.expand(nA, n)
            xs_l, us_l = [x], []
            for h in range(us.shape[0]):
                u = us[h] + alphas[:, None] * ks[h] + (x - xs[h]) @ Ks[h].T
                u = torch.clamp(u, c["u_lo"], c["u_hi"])
                x = f(x, u, template)
                xs_l.append(x)
                us_l.append(u)
            xs_c, us_c = torch.stack(xs_l, dim=1), torch.stack(us_l, dim=1)
        costs_c = total_cost(xs_c, us_c)
        best = torch.argmin(costs_c).view(1)  # first minimum, as jnp.argmin
        return (xs_c.index_select(0, best)[0], us_c.index_select(0, best)[0],
                costs_c.index_select(0, best)[0])

    def iteration(x0, xs, us, cost, lam, template):
        """derivs -> backward -> line search -> monotone accept. `lam` rises
        (x32 from 1e-3) after a failed line search and decays (x0.25) after
        a success."""
        ks, Ks = backward(*derivs(xs, us, template), lam)
        xs_c, us_c, cost_c = linesearch(x0, xs, us, ks, Ks, template)
        better = cost_c < cost
        xs_n = torch.where(better, xs_c, xs)
        us_n = torch.where(better, us_c, us)
        lam_n = torch.where(better, lam * 0.25, torch.clamp(lam * 32.0, min=1e-3))
        return xs_n, us_n, torch.minimum(cost_c, cost), lam_n

    return rollout0, derivs, backward, linesearch, iteration


def make_ilqr_solver(model: RobotModel, cfg: ILQRConfig, cost_xu: Callable,
                     cost_final: Optional[Callable] = None,
                     quad_xu: Optional[Callable] = None,
                     quad_final: Optional[Callable] = None,
                     ops: Optional[ILQROps] = None):
    """Solver handle: (state0, u_init (H, nu)) -> ILQRResult, on the device
    of state0.

    `quad_xu(x, u) -> (cx, cu, cxx, cuu, cux)` and `quad_final(x) -> (Vx,
    Vxx)` optionally replace the autodiff quadratization with an analytic
    or Gauss-Newton model; `cost_xu` still scores rollouts and the line
    search. `ops` picks the kernels (None: `KERNEL_OPS`) or their plain
    versions (`PLAIN_OPS`). Unlike the JAX handle, which keeps the state0
    of its first call as the template, each call uses its own state0."""
    rollout0, _, _, _, iteration = _build_pieces(model, cfg, cost_xu, cost_final, quad_xu,
                                                 quad_final, ops)

    def solve(state0: SimState, u_init: torch.Tensor) -> ILQRResult:
        x0 = flatten_state(state0, reduced=cfg.reduced_state)
        us = _clip_u(model, u_init)
        xs, cost = rollout0(x0, us, state0)
        lam = x0.new_zeros(())
        trace = []
        for _ in range(cfg.n_iters):
            xs, us, cost, lam = iteration(x0, xs, us, cost, lam, state0)
            trace.append(cost)
        cost_trace = torch.stack(trace) if trace else x0.new_zeros(0)
        return ILQRResult(us=us, xs=xs, cost=cost, cost_trace=cost_trace)

    return solve


def ilqr_solve(model: RobotModel, cfg: ILQRConfig, state0: SimState, u_init: torch.Tensor,
               cost_xu: Callable, cost_final: Optional[Callable] = None) -> ILQRResult:
    """One solve with the autodiff quadratization (convenience entry)."""
    return make_ilqr_solver(model, cfg, cost_xu, cost_final)(state0, u_init)
