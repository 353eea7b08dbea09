"""MPPI (model-predictive path integral) sampling MPC.

Port of `gym_kmanip_tpu/mpc/mppi.py:29-209`. K perturbed control sequences
roll out as one batch, then

    w_k = softmax(-(S_k - min S) / (temperature * (std S + 1e-6)))

with elite acceptance: slot 0 is the old nominal (zero noise), slot 1 the
previous iteration's weighted average, and the next nominal is the best
evaluated sequence. Controls are clamped to the actuator ctrlrange.
`make_mppi_solver` scores the candidates with `rollout` (one substep
launch per horizon step on the card); `make_fused_pick_solver` scores
them with the whole-horizon pick-cost kernel (one launch per iteration).

The solve path makes no host sync (no `.item()`, no host-side branch on a
device value, no host-to-device copy after the first call), so a later
change can capture it in a CUDA graph.
"""

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.engine import substep
from gym_kmanip_torch.dynamics.state import SimState
from gym_kmanip_torch.models import canonical_device, model_tensors
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.mpc.rollout import rollout
from gym_kmanip_torch.ops.rollout_pick_cuda import PickCostSpec, rollout_pick_costs
from gym_kmanip_torch.utils.profiling import span


class MPPIConfig(NamedTuple):
    horizon: int = 50
    n_samples: int = 256
    temperature: float = 0.1
    sigma: float = 0.05  # exploration std-dev (rad) on position targets
    n_iters: int = 1  # optimization iterations per solve
    n_substeps: int = 1
    dt: float = k.CONTROL_TIMESTEP
    contact: bool = True  # False = free-space rollouts (reach-only tasks)
    # AR(1) time correlation of the exploration noise ("smooth MPPI"):
    # eps_t = beta eps_{t-1} + sqrt(1-beta^2) xi_t
    noise_beta: float = 0.85


class MPPIState(NamedTuple):
    nominal: torch.Tensor  # (H, nu) current nominal control-target sequence
    generator: torch.Generator  # draws the exploration noise; advances in place


def _ar1_filter(horizon: int, beta: float) -> np.ndarray:
    """(H, H) lower-triangular AR(1) filter: eps = L @ xi, with
    L[t,0] = beta^t and L[t,s] = g*beta^(t-s) for 1 <= s <= t."""
    g = float(np.sqrt(1.0 - beta * beta))
    t = np.arange(horizon)
    powers = beta ** np.maximum(t[:, None] - t[None, :], 0)
    L = np.tril(g * powers)
    L[:, 0] = beta ** t
    return L.astype(np.float32)


def sigma_per_actuator(model: RobotModel, sigma: float) -> np.ndarray:
    """Exploration std per actuator (host float32): `sigma`, capped at a
    quarter of each actuator's ctrlrange span (the gripper sliders' range
    is only 0.034 m)."""
    span = (model.ctrl_range[:, 1] - model.ctrl_range[:, 0]).astype(np.float32)
    return np.minimum(np.float32(sigma), 0.25 * span)


def correlate(xi: torch.Tensor, beta: float) -> torch.Tensor:
    """Apply the AR(1) filter along the horizon of xi (K, H, nu).

    A broadcast multiply and sum rather than a matmul, so the filter runs
    in full FP32 whatever the TF32 setting (the JAX package asks for
    HIGHEST precision here)."""
    horizon = xi.shape[1]
    if beta <= 0.0 or horizon == 1:
        return xi
    L = _ar1_tensor(horizon, float(beta), canonical_device(xi.device))
    return torch.sum(L[None, :, :, None] * xi[:, None, :, :], dim=2)


@functools.lru_cache(maxsize=16)
def _ar1_tensor(horizon: int, beta: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_ar1_filter(horizon, beta), device=device)


def sample_noise(generator: torch.Generator, n_samples: int, horizon: int, nu: int,
                 sigma: torch.Tensor, beta: float) -> torch.Tensor:
    """(K, H, nu) exploration noise, AR(1)-correlated along the horizon with
    stationary std `sigma` (per actuator), drawn from `generator` (which
    advances) on the generator's device."""
    xi = torch.randn((n_samples, horizon, nu), generator=generator,
                     device=generator.device) * sigma
    return correlate(xi, beta)


def init_mppi(model: RobotModel, cfg: MPPIConfig, seed: int = 0,
              device="cuda") -> MPPIState:
    """The home-pose nominal and a seeded noise generator, on the card
    unless `device` says otherwise."""
    device = canonical_device(device)
    home = torch.as_tensor(model.home_qpos[: model.nu], dtype=torch.float32,
                           device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return MPPIState(nominal=home.repeat(cfg.horizon, 1), generator=gen)


def rewinder(mppi_state: MPPIState) -> Callable[[], MPPIState]:
    """() -> `mppi_state` with its generator set back to the state it has
    now. The JAX package starts every episode from one immutable MPPIState,
    so every episode sees the same nominal and the same noise stream; the
    generator here advances in place, and each call of the returned function
    rewinds it."""
    saved = mppi_state.generator.get_state()

    def start() -> MPPIState:
        mppi_state.generator.set_state(saved)
        return mppi_state

    return start


def sigma_tensor(model: RobotModel, cfg: MPPIConfig, device: torch.device) -> torch.Tensor:
    """`sigma_per_actuator` on `device`, built once per (model, sigma,
    device)."""
    key = ("mppi_sigma", float(cfg.sigma), str(device))
    sigma = model.cache.get(key)
    if sigma is None:
        sigma = torch.as_tensor(sigma_per_actuator(model, cfg.sigma), device=device)
        model.cache[key] = sigma
    return sigma


def injected_noise(model: RobotModel, cfg: MPPIConfig,
                   eps: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Injected noise as (n_iters, K, H, nu); (K, H, nu) is one iteration's.
    Raises on any other shape."""
    if eps is None:
        return None
    shape = (cfg.n_iters, cfg.n_samples, cfg.horizon, model.nu)
    if eps.dim() == 3:
        eps = eps[None]
    if tuple(eps.shape) != shape:
        raise ValueError(
            f"eps of shape {tuple(eps.shape)} with n_iters={cfg.n_iters}: injected noise "
            f"is {shape}, or {shape[1:]} for one iteration")
    return eps


def mppi_solve(model: RobotModel, cfg: MPPIConfig, mppi_state: MPPIState,
               sim_state: SimState, cost_fn: Callable,
               eps: Optional[torch.Tensor] = None, substep_fn: Callable = substep,
               score_all: Optional[Callable] = None,
               on_costs: Optional[Callable] = None,
               ) -> Tuple[MPPIState, torch.Tensor, torch.Tensor]:
    """One MPC solve. Returns (new MPPIState, first control, expected cost).

    `cost_fn(state, aux, ctrl) -> (K,)` is the running cost. With no `eps`
    the noise is drawn from `mppi_state.generator`, which advances in
    place; `eps` injects the noise instead: (n_iters, K, H, nu), one draw
    per iteration, or (K, H, nu) for a one-iteration solve (slot 0 is
    zeroed either way). `substep_fn` is the physics
    substep the rollouts call (default: `engine.substep`). `score_all`
    optionally replaces the rollout scoring pass with a fused
    `(cand (K, H, nu), sim_state) -> (K,)` that computes the same totals
    as `rollout(cost_fn)` to float32 rounding. `on_costs(iteration, costs)`,
    if given, is handed each iteration's (K,) totals as scored (the
    solver's own tensor: no copy, no sync).

    Under a `torch.profiler` session the solve records the spans
    `mppi.solve` and, each iteration, `mppi.noise`, `mppi.candidates` and
    `mppi.update` (`utils.profiling.span`)."""
    with span("mppi.solve", solve=True):
        device = canonical_device(mppi_state.nominal.device)
        t = model_tensors(model, device)
        lo, hi = t.ctrl_lo, t.ctrl_hi
        K, H, nu = cfg.n_samples, cfg.horizon, model.nu
        sigma = sigma_tensor(model, cfg, device)
        eps = injected_noise(model, cfg, eps)

        nominal = proposal = mppi_state.nominal
        best_cost = None
        for it in range(cfg.n_iters):
            with span("mppi.noise"):
                e = (sample_noise(mppi_state.generator, K, H, nu, sigma, cfg.noise_beta)
                     if eps is None else eps[it])
            with span("mppi.candidates"):
                e = torch.cat([torch.zeros_like(e[:1]), e[1:]])  # the nominal competes
                cand = torch.clamp(nominal[None] + e, lo, hi)  # (K, H, nu)
                # slot 1 scores the previous iteration's weighted average
                cand = torch.cat([cand[:1], proposal[None], cand[2:]])
            if score_all is not None:
                costs = score_all(cand, sim_state)
            else:
                costs, _ = rollout(
                    model, sim_state, cand, cost_fn, n_substeps=cfg.n_substeps,
                    dt=cfg.dt, contact=cfg.contact, substep_fn=substep_fn,
                )
            if on_costs is not None:
                on_costs(it, costs)
            with span("mppi.update"):
                # scale-invariant temperature; population std, as jnp.std
                lam = cfg.temperature * (torch.std(costs, correction=0) + 1e-6)
                w = torch.softmax(-(costs - torch.min(costs)) / lam, dim=0)
                proposal = torch.clamp(torch.sum(w[:, None, None] * cand, dim=0), lo, hi)
                best = torch.argmin(costs).view(1)  # first minimum, as jnp.argmin
                nominal = cand.index_select(0, best)[0]
                best_cost = costs.index_select(0, best)[0]

        u0 = nominal[0]
        shifted = torch.cat([nominal[1:], nominal[-1:]], dim=0)
    return MPPIState(nominal=shifted, generator=mppi_state.generator), u0, best_cost


def make_mppi_solver(model: RobotModel, cfg: MPPIConfig, cost_fn: Callable,
                     substep_fn: Callable = substep):
    """Single-device solver: (MPPIState, SimState, eps=None) -> (MPPIState,
    u0, J)."""

    def solve(mppi_state: MPPIState, sim_state: SimState,
              eps: Optional[torch.Tensor] = None):
        return mppi_solve(model, cfg, mppi_state, sim_state, cost_fn, eps=eps,
                          substep_fn=substep_fn)

    return solve


def make_fused_pick_solver(model: RobotModel, cfg: MPPIConfig, spec=None,
                           on_costs: Optional[Callable] = None):
    """Single-device MPPI solver for the cube-pick cost whose whole (K, H)
    rollout and cost is ONE kernel launch per iteration
    (ops/rollout_pick_cuda.rollout_pick_costs) instead of H substep
    launches and their torch glue. The totals match `rollout` with
    `cube_pick_cost` to float32 rounding, so it is the same solve:
    (MPPIState, SimState, eps=None) -> (MPPIState, u0, J). `on_costs` is
    `mppi_solve`'s: it is handed each iteration's totals."""
    spec = spec if spec is not None else PickCostSpec()

    def score_all(cand, sim_state):
        return rollout_pick_costs(model, cand, sim_state, spec, n_substeps=cfg.n_substeps,
                                  dt=cfg.dt, contact=cfg.contact)

    def solve(mppi_state: MPPIState, sim_state: SimState,
              eps: Optional[torch.Tensor] = None):
        return mppi_solve(model, cfg, mppi_state, sim_state, None, eps=eps,
                          score_all=score_all, on_costs=on_costs)

    return solve
