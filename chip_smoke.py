"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. build:       compile the eight CUDA libraries from gym_kmanip_torch/csrc,
                  K1 and K2 with the solo-width team shapes they were not
                  built with, K5 and K7 with their other items per block,
                  and K6 with its other team width (ALTERNATES), one nvcc
                  each, all at once; ptxas's registers, stack and spills of
                  every kernel.
  2. K1 substep:  at K=256, random solo-arm states from a seed, in MPC mode
                  (dt=0.02, implicit actuation) and env mode (dt=0.002,
                  explicit): the kernel against its plain PyTorch version
                  (qpos and xpos 1e-5, qvel and cube 1e-4, touch equal), and
                  the time of each.
  3. MPPI:        the solo-arm MPPI pick solve at H=50, K=256 through K1: 20
                  solves with the launch count checked, the kernel route
                  against the plain route on one injected noise draw at
                  H=4, then solves/s of both routes (the plain route's over
                  3 x 2 solves).
  4. closed loop: the receding-horizon recipe of bench.py (H=20, K=256,
                  2 iterations, 10 substeps of 2 ms) against the plant
                  `control_step` for 30 steps.
  5. K2 pick:     the whole-horizon pick-cost kernel against its plain
                  version at K=256 (H=1 1e-5, H=3 1e-3, H=50 1e-4 of the
                  largest total) and against the K1 route's totals at H=50;
                  its time; the alternate team shapes at H=50, checked and
                  timed.
  6. fused MPPI:  the fused solve against the K1-route solve on one draw at
                  H=4 (u0 1e-5, J 1e-4, nominal 1e-5); 20 solves at H=50,
                  K=256 with n_iters K2 launches and no K1 launch per solve;
                  solves/s beside the K1 route.
  7. iLQR:        the production solve of bench.py:315-319 on the solo arm
                  (H=50, 10 iterations, reduced state, Gauss-Newton EE cost,
                  one-sided FD): launches per solve (K1 10, K3 11, K4 10), a
                  monotone cost trace, the plan replayed on the plain route,
                  solves/s, a torch.profiler breakdown of 3 solves (device
                  busy, launches, K1, K3 and K4 device time per solve and per
                  launch, the largest kernels), one solve on the plain
                  route, and the EE
                  tracking error after executing the plan on `control_step`.
                  K1 (on the FD probe batch, K=1500 without contact, and the
                  A and B slopes it gives), K3 and K4 against their plain
                  versions on the first iteration's real inputs, K4 also on
                  seeded problems at solo and torso widths; their times.
                  The torso at H=100, once.
  7b. device times: after every host-bound rate above (the profiles come
                  after them, as the iLQR phase's does): K1's device time
                  per launch (torch.profiler) at K=256 with contact and at
                  K=1500 without, its alternate team shapes checked as in
                  phase 2 and timed the same way, and a breakdown of 10
                  fused MPPI solves (device busy, K2's device time per
                  launch beside its CUDA-event time).
  8. staged MPPI: the staged substep route (engine.substep_staged: K5 FK +
                  RNEA, K6 contacts, K7 SPD solve, torch glue between) at
                  H=50, K=256 through make_mppi_solver: K5, K6 and K7 against
                  their plain versions on the inputs of the first staged
                  substep of a solve (frames 1e-5, bias and forces 1e-4, flags
                  equal; the solve 1e-4 relative, also against float64) and
                  on seeded torso inputs (K7: a seeded n=20 problem), their
                  times beside the plain versions' (K7 also beside
                  torch.linalg.solve); 5 solves with the launch counts per
                  solve checked (K5 50, K6 50, K7 200, K1 0), the staged route
                  against the plain route on one injected draw at H=4 (u0
                  1e-5, J 1e-4, nominal 1e-5), solves/s (5 x 5 solves) beside
                  the K1 and fused routes, and a torch.profiler breakdown of 2 solves
                  (device busy, kernel launches, the largest kernels). Then
                  K5's, K6's and K7's device time per launch
                  (torch.profiler) on the inputs above (K5 and K6 solo and
                  torso), and their alternate builds, each checked as the
                  kernel is (K5 and K6 solo, K7 at n=10 and n=20) and timed
                  the same way.
  9. K8 floor:    the Riccati step's floor experiment
                  (gym_kmanip_torch.tools.exp_sweep_floor) at H=100, n=40,
                  m=20: each of its seven variants against its plain version
                  (1e-4 of the largest gain), then ms per sweep of each beside
                  K4's at the same widths, as a share of K4's, and K4's less
                  gersh's (what K4's factor and substitutions cost).
Only the staged route moves the K5, K6 and K7 counters: every other phase,
and every plain-version call, leaves them as they were.
The kernels line, then the card's name and power limit (nvidia-smi), then
{"ok": true, "device": {...}}. Exits non-zero without a GPU.
"""

import ctypes
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

from gym_kmanip_torch import constants  # noqa: E402
from gym_kmanip_torch.dynamics import contacts, engine  # noqa: E402
from gym_kmanip_torch.dynamics.state import init_state  # noqa: E402
from gym_kmanip_torch.models import get_model, model_tensors  # noqa: E402
from gym_kmanip_torch.mpc.cost import (  # noqa: E402
    CostParams, cube_pick_cost, make_ee_tracking_cost_ilqr)
from gym_kmanip_torch.mpc.mppi import (  # noqa: E402
    MPPIConfig, init_mppi, make_fused_pick_solver, make_mppi_solver)
from gym_kmanip_torch.mpc.rollout import rollout  # noqa: E402
from gym_kmanip_torch.ops import _build, riccati_cuda, rollout_feedback_cuda  # noqa: E402
from gym_kmanip_torch.ops import chol_solve_cuda, contacts_cuda, rnea_cuda  # noqa: E402
from gym_kmanip_torch.ops import kinematics as kin  # noqa: E402
from gym_kmanip_torch.ops import linalg, sweep_floor_cuda  # noqa: E402
from gym_kmanip_torch.ops import rollout_pick_cuda, substep_cuda  # noqa: E402
from gym_kmanip_torch.solvers import ilqr  # noqa: E402
from gym_kmanip_torch.tools import exp_sweep_floor  # noqa: E402
from gym_kmanip_torch.utils import rotations as rot  # noqa: E402

DEV = torch.device("cuda", 0)
K, H = 256, 50
TORSO_H = 100
TOL = {"qpos": 1e-5, "qvel": 1e-4, "cube13": 1e-4, "xpos": 1e-5, "xquat": 1e-5}
OUTS = ("qpos", "qvel", "cube13", "touch", "xpos", "xquat")
# H100 SXM datasheet peaks: HBM bytes/s, FP32 outside the
# tensor cores (every kernel here is scalar FP32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
WRAPPERS = {
    "K1": substep_cuda.substep_batched,
    "K2": rollout_pick_cuda.rollout_pick_costs,
    "K3": rollout_feedback_cuda.rollout_feedback,
    "K4": riccati_cuda.riccati_sweep,
    "K5": rnea_cuda.rnea_terms_batched,
    "K6": contacts_cuda.contact_forces_batched,
    "K7": chol_solve_cuda.cholesky_solve_batched,
    "K8": sweep_floor_cuda.sweep,
}
STAGED = ("K5", "K6", "K7")  # launched by the staged substep route only
# The team widths and warps per block that K1 and K2 were not built with at
# solo width (csrc/substep.cu, csrc/rollout_pick.cu), the warps per block
# that K5 (csrc/rnea.cu, solo width) and K7 (csrc/chol_solve.cu) were not
# built with, and the team width that K6 (csrc/contacts.cu) was not built
# with: built with -D beside the kernels, checked against the plain
# versions and timed beside them. KMANIP_SOLO_ONLY leaves out the torso
# kernels, which these flags do not change.
ALTERNATES = {
    "K1": (substep_cuda, {
        "16 lanes, 4 warps per block": ("-DKMANIP_SOLO_LANES=16", "-DKMANIP_SOLO_ONLY"),
        "32 lanes, 1 warp per block": ("-DKMANIP_TEAM_WARPS=1", "-DKMANIP_SOLO_ONLY")}),
    "K2": (rollout_pick_cuda, {
        "16 lanes, 1 warp per block": ("-DKMANIP_SOLO_LANES=16", "-DKMANIP_SOLO_ONLY"),
        "32 lanes, 4 warps per block": ("-DKMANIP_TEAM_WARPS=4", "-DKMANIP_SOLO_ONLY")}),
    "K5": (rnea_cuda, {
        "1 warp per block": ("-DKMANIP_RNEA_WARPS=1", "-DKMANIP_SOLO_ONLY")}),
    "K6": (contacts_cuda, {
        "16 lanes, 4 warps per block": ("-DKMANIP_CONTACT_LANES=16",)}),
    "K7": (chol_solve_cuda, {
        "1 warp per block": ("-DKMANIP_CHOL_WARPS=1",),
        "4 warps per block": ("-DKMANIP_CHOL_WARPS=4",)}),
}


def alternate_libraries():
    """(name, sources, headers, flags) of every alternate build."""
    return [(f"{mod.LIBRARY[0]}_alt{i}", *mod.LIBRARY[1:], flags)
            for mod, variants in ALTERNATES.values()
            for i, flags in enumerate(variants.values())]


class built_with:
    """Routes the launches of kernel `kernel` (a key of ALTERNATES) to its
    alternate build `i` for as long as it lasts."""

    def __init__(self, kernel, i):
        mod, variants = ALTERNATES[kernel]
        name, sources, headers = mod.LIBRARY
        path = _build.library_path(f"{name}_alt{i}", list(sources), list(headers),
                                   list(variants.values())[i])
        self.mod, self.lib = mod, mod._bind(ctypes.CDLL(path))

    def __enter__(self):
        self.saved = self.mod._library
        self.mod._library = lambda: self.lib
        return self

    def __exit__(self, *exc):
        self.mod._library = self.saved


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, n):
    """Mean milliseconds per call of `fn` over n calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def counts():
    return {name: w.launches for name, w in WRAPPERS.items()}


def only(**nonzero):
    """Launch counts with `nonzero` and every other kernel at 0."""
    return {name: nonzero.get(name, 0) for name in WRAPPERS}


def staged_counts():
    return {name: WRAPPERS[name].launches for name in STAGED}


def plain(fn, *args, **kwargs):
    """A plain-version call that must launch none of the staged route's
    kernels (the plain versions are built on `engine._substep_torch`)."""
    before = staged_counts()
    out = fn(*args, **kwargs)
    if staged_counts() != before:
        raise AssertionError(f"{fn.__name__} launched a staged kernel: {before} -> "
                             f"{staged_counts()}")
    return out


def check(phase, what, err, tol):
    log(phase, f"{what}: max abs err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{phase}: {what} differs by {err:.3e} > {tol:.3e}")


def max_err(a, b):
    return float((a - b).abs().max())


# ---- the least time the card could take for each kernel's work ----
# Operations are counted by hand from the device code, per rollout (or per
# sweep step), each float add, multiply, divide, square root, sine or
# cosine as one; comparisons and selects are not counted, a clamp is two.
# Bytes: each input read once and each output written once.

def rnea_flops(model):
    """csrc/substep.cuh::rnea_rows for one rollout."""
    nq = model.nq
    hinge = np.asarray(model.jnt_type) == 0
    f = int(np.sum(np.where(hinge, 188, 172)))  # FK + velocity recursion
    f += 183 * nq  # COM loads: offsets, accelerations, world inertia
    f += 17 * nq + 21 * (nq - 1)  # backward pass over the tree
    return f


def contact_flops(model):
    """csrc/substep.cuh::contact_rows for one rollout."""
    return 39 + 185 * len(model.fingertips) + 12 + 8 * 110  # tips vs cube, 8 corners vs table


def chol_flops(n, n_solves=1):
    """csrc/substep.cuh::chol_factor, then `n_solves` chol_solve."""
    factor = sum(2 * j + 2 + (n - 1 - j) * (2 * j + 1) for j in range(n))
    return factor + n_solves * 2 * n * n


def substep_flops(model, contact):
    """csrc/substep.cuh::substep_core for one rollout."""
    nq, T, nu = model.nq, len(model.fingertips), model.nu
    anc = np.asarray(model.ancestors, bool)
    f = rnea_flops(model)
    f += 48 * T  # fingertip positions and velocities
    if contact:
        f += contact_flops(model)
    f += 8 * nq  # servo, damping, bias, implicit terms
    f += sum(18 * int(anc[t.parent].sum()) for t in model.fingertips)  # contact reactions
    for i in range(nq):  # mass matrix by COM Jacobians
        a = int(anc[i].sum())
        f += 33 + 45 * a + 13 * a * (a + 1) // 2
    f += 3 * nq  # diagonal terms
    f += chol_flops(nq, n_solves=4)  # Cholesky, one solve + 3 constraint solves
    f += 3 * 25 * nq + 6 * nq + 120  # constraint sweeps, integration, cube
    return f


def pick_cost_flops(model):
    """csrc/rollout.cuh::pick_cost_step for one rollout and step."""
    return 2 * model.nq + 3 * model.nu + 16 + 44 + 250


def riccati_step_flops(n, m):
    """csrc/riccati.cuh: one step of the sweep."""
    Z, N1 = n + m, n + 1
    f = Z * N1 * 2 * n  # GW
    f += (n * n + m * n + m * m) * (2 * n + 1) + Z  # Q blocks, qv
    f += 2 * m * m + 3 * m * m + 6 * m  # symmetrize, row stats, lift
    f += 3 * m + 2 * m * m  # equilibration
    f += sum(2 + (m - 1 - j) + (m - 1 - j) * (m - j) for j in range(m))  # factor
    f += N1 * (2 * m * m + 4 * m)  # substitutions
    f += m * N1 * (2 * m + 3) + n * N1 * (4 * m + 2) + 2 * n * N1  # value update
    return f


def bound(flops, nbytes):
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- phases ----

def tip_penetration(model, xpos, xquat, cube13):
    """Fingertip-cube penetration (K, T) at the pre-step frames."""
    t = model_tensors(model, xpos.device)
    tips = engine._tips_from_frames(model, xpos, xquat)
    R = rot.quat_to_mat(cube13[:, 3:7])[:, None]
    local = ((tips - cube13[:, None, :3])[..., None, :] @ R)[..., 0, :]
    pen, _ = contacts.sphere_box(local, t.tip_radius, 0.02)
    return pen


def compare_substep(tag, model, dt, contact, implicit, inputs):
    """K1 against its plain version on `inputs` (qpos, qvel, ctrl, cube13):
    raises past TOL or on a touch flip; returns the largest error."""
    got = substep_cuda.substep_batched(model, dt, contact, implicit, *inputs)
    want = substep_cuda.substep_batched_reference(model, dt, contact, implicit, *inputs)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(OUTS, got, want):
        if name == "touch":
            continue
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag}: kernel {name} is not finite")
        errs[name] = float((g - w).abs().max())
    flips = (got[3] != want[3]).nonzero().tolist()
    if flips:
        pen = tip_penetration(model, want[4], want[5], inputs[3])
        for k, t in flips:
            log("K1", f"touch flip at rollout {k} tip {t}: penetration {float(pen[k, t]):.3e}")
        raise AssertionError(f"{tag}: {len(flips)} touch flags differ")
    bad = {n: e for n, e in errs.items() if e > TOL[n]}
    log("K1", f"{tag}: max_abs_err {json.dumps(errs)} "
              f"touching {float(want[3].float().mean()):.3f}")
    if bad:
        raise AssertionError(f"{tag}: kernel disagrees with the plain version: {bad}")
    return max(errs.values())


def time_substep(tag, model, contact, inputs):
    """Kernel and plain times of K1 at dt=0.02 with implicit actuation, and
    its bound, on `inputs`."""
    k_ = inputs[0].shape[0]
    args = (model, 0.02, contact, True, *inputs)
    ms = cuda_ms(lambda: substep_cuda.substep_batched(*args), 200)
    plain_ms = cuda_ms(lambda: substep_cuda.substep_batched_reference(*args), 20)
    T, nq, nu = len(model.fingertips), model.nq, model.nu
    nbytes = k_ * (4 * (2 * nq + nu + 13) + 4 * (2 * nq + 13 + 7 * nq) + T)
    b = bound(k_ * substep_flops(model, contact), nbytes)
    log("K1", f"{tag}: kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call "
              f"({1e6 * ms / k_:.1f} ns per rollout-substep); bound {b[0]:.6f} ms ({b[1]}): "
              f"{substep_flops(model, contact)} operations per rollout-substep, {nbytes} bytes")
    return ms, plain_ms, b


def kernel_device_ms(fn, tag, n=20, tries=3):
    """Device ms per launch of the kernel whose name holds `tag`, launched
    once by each of n calls of fn (torch.profiler): without the wrapper's
    host time, which bounds back-to-back calls of a kernel of a few tens of
    microseconds. The mean over the launches the trace holds: the profiler
    may drop some of a short trace's device records, or all of them
    (PERF.md §7), and then the trace is taken again, up to `tries` traces
    in all."""
    for _ in range(tries):
        rows = [v for key, v in profile_kernels(fn, n).items() if tag in key]
        t, launches = map(sum, zip(*rows)) if rows else (0.0, 0.0)
        if round(launches * n) != n:
            log("device", f"the profiler's trace of {n} calls held {launches * n:.0f} launches of "
                          f"{tag}")
        if launches > 0:
            return t / launches
    raise AssertionError(f"the profiler recorded no launch of {tag} in {tries} traces")


def phase_substep(model):
    inputs = [torch.as_tensor(a, device=DEV)
              for a in substep_cuda.random_inputs(model, K, seed=0)]
    worst = max(compare_substep(f"K={K} dt={dt} implicit={implicit}", model, dt, True,
                                implicit, inputs)
                for dt, implicit in ((0.02, True), (0.002, False)))
    ms, plain_ms, b = time_substep(f"K={K} contact substep", model, True, inputs)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound=b)


def solves_per_sec(solver, ms, sim_state, n_solves=20, repeats=5):
    rates = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_solves):
            ms, _u0, _J = solver(ms, sim_state)
        torch.cuda.synchronize()
        rates.append(n_solves / (time.perf_counter() - t0))
    return rates, ms


def rate_line(r):
    return (f"{statistics.median(r):.2f} solves/s median over {len(r)} repeats "
            f"(min {min(r):.2f}, max {max(r):.2f})")


def pick_cost(model):
    params = CostParams()
    return lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)  # noqa: E731


def phase_mppi(model):
    cost = pick_cost(model)
    cfg = MPPIConfig(horizon=H, n_samples=K)
    solver = make_mppi_solver(model, cfg, cost)
    sim_state = init_state(model, device=DEV)
    ms = init_mppi(model, cfg, seed=0, device=DEV)
    ms, u0, J = solver(ms, sim_state)  # first call builds the cached tensors
    torch.cuda.synchronize()

    reset_counts()
    n_solves, Js = 20, []
    for _ in range(n_solves):
        ms, u0, J = solver(ms, sim_state)
        Js.append(J)
    torch.cuda.synchronize()
    launches = counts()
    expected = n_solves * H * cfg.n_substeps * cfg.n_iters
    Js = torch.stack(Js)
    if launches != only(K1=expected):
        raise AssertionError(f"MPPI launches {launches}, expected {expected} of K1 only")
    if not bool(torch.isfinite(Js).all()) or u0.shape != (model.nu,):
        raise AssertionError("MPPI solve gave a non-finite cost or a wrong-shaped control")
    log("mppi", f"H={H} K={K}: {n_solves} solves, launches {launches} "
                f"({launches['K1'] // n_solves} K1 per solve), J first {float(Js[0]):.4f} "
                f"last {float(Js[-1]):.4f}")

    # the kernel route and the plain route make the same solve on one draw
    small = cfg._replace(horizon=4)
    eps = torch.randn((K, 4, model.nu), generator=torch.Generator(DEV).manual_seed(1),
                      device=DEV) * 0.05
    ms_small = init_mppi(model, small, seed=0, device=DEV)
    ms_k, u0_k, J_k = make_mppi_solver(model, small, cost)(ms_small, sim_state, eps=eps)
    ms_p, u0_p, J_p = make_mppi_solver(model, small, cost, substep_fn=engine._substep_torch)(
        ms_small, sim_state, eps=eps)
    check("mppi", "K1 route vs plain route at H=4: u0", max_err(u0_k, u0_p), 1e-5)
    check("mppi", "K1 route vs plain route at H=4: J", max_err(J_k, J_p), 1e-4)
    check("mppi", "K1 route vs plain route at H=4: nominal", max_err(ms_k.nominal, ms_p.nominal),
          1e-5)

    rates, ms = solves_per_sec(solver, ms, sim_state)
    plain = make_mppi_solver(model, cfg, cost, substep_fn=engine._substep_torch)
    plain_rates, _ = solves_per_sec(plain, ms, sim_state, n_solves=2, repeats=3)
    log("mppi", f"K1 route: {rate_line(rates)} x 20 solves")
    log("mppi", f"plain route: {rate_line(plain_rates)} x 2 solves")
    return launches["K1"], rates


def phase_closed_loop(model):
    def cost(s, aux, u):
        d2 = torch.sum((aux.tip_pos - s.cube_pos[..., None, :]) ** 2, dim=-1)
        touched = aux.touch_r | aux.touch_l
        return (50.0 * d2.mean(-1) + 0.01 * torch.sum(s.qvel ** 2, dim=-1)
                - torch.where(touched, 5.0, 0.0)
                - torch.where(touched & ~aux.touch_table, 10.0, 0.0))

    cfg = MPPIConfig(horizon=20, n_samples=K, n_iters=2, sigma=0.15, n_substeps=10,
                     dt=0.002, noise_beta=0.9)
    solver = make_mppi_solver(model, cfg, cost)
    ms = init_mppi(model, cfg, seed=0, device=DEV)
    sim = init_state(model, cube_pos=np.array([0.15, 0.58, 0.62]), device=DEV)
    ms, u0, _ = solver(ms, sim)
    engine.control_step(model, sim, u0)
    torch.cuda.synchronize()
    n = 30
    t0 = time.perf_counter()
    for _ in range(n):
        ms, u0, _ = solver(ms, sim)
        sim, aux = engine.control_step(model, sim, u0)
    torch.cuda.synchronize()
    hz = n / (time.perf_counter() - t0)
    dist = torch.linalg.vector_norm(aux.tip_pos - sim.cube_pos, dim=-1)
    if not bool(torch.isfinite(sim.qpos).all()) or not bool(torch.isfinite(dist).all()):
        raise AssertionError("closed loop diverged")
    log("closed", f"{n} steps at {hz:.2f} Hz; final tip-cube distance mean "
                  f"{float(dist.mean()):.4f} m (min {float(dist.min()):.4f} m)")


def phase_pick_kernel(model):
    s0 = init_state(model, device=DEV)
    rng = np.random.RandomState(0)
    worst = 0.0
    for h, tol in ((1, 1e-5), (3, 1e-3)):
        U = torch.as_tensor((model.home_qpos[: model.nu] + 0.1 * rng.randn(K, h, model.nu))
                            .astype(np.float32), device=DEV)
        got = rollout_pick_cuda.rollout_pick_costs(model, U, s0)
        want = rollout_pick_cuda.rollout_pick_costs_reference(model, U, s0)
        err = max_err(got, want)
        check("K2", f"kernel vs plain, K={K} H={h}", err, tol)
        worst = max(worst, err)
    U = torch.as_tensor((model.home_qpos[: model.nu] + 0.1 * rng.randn(K, H, model.nu))
                        .astype(np.float32), device=DEV)
    got = rollout_pick_cuda.rollout_pick_costs(model, U, s0)
    want = rollout_pick_cuda.rollout_pick_costs_reference(model, U, s0)
    # 50 steps with contact grow the float32 rounding of the two versions
    # apart: their totals differed by 1.8e-4 at totals up to 12 (measured on
    # an H100), held at 1e-4 of the largest total
    scale = float(want.abs().max())
    err = max_err(got, want)
    check("K2", f"kernel vs plain, K={K} H={H} (totals up to {scale:.2f})", err, 1e-4 * scale)
    worst = max(worst, err)
    # the K1 route shares the substep's device code: the same tolerance
    k1_route, _ = rollout(model, s0, U, pick_cost(model))
    check("K2", f"kernel vs K1-route totals, K={K} H={H}", max_err(got, k1_route),
          1e-4 * scale)
    ms = cuda_ms(lambda: rollout_pick_cuda.rollout_pick_costs(model, U, s0), 20)
    plain_ms = cuda_ms(lambda: rollout_pick_cuda.rollout_pick_costs_reference(model, U, s0), 2)
    flops = K * H * (substep_flops(model, True) + pick_cost_flops(model))
    b = bound(flops, 4 * (K * H * model.nu + 2 * model.nq + 13 + K))
    log("K2", f"K={K} H={H}: kernel {ms:.4f} ms (32 lanes, 1 warp per block), plain "
              f"{plain_ms:.2f} ms, max_abs_err {worst:.3e}, bound {b[0]:.6f} ms ({b[1]})")
    teams = {}
    for i, label in enumerate(ALTERNATES["K2"][1]):
        with built_with("K2", i):
            alt_err = max_err(rollout_pick_cuda.rollout_pick_costs(model, U, s0), want)
            check("K2", f"{label}: kernel vs plain, K={K} H={H}", alt_err, 1e-4 * scale)
            alt_ms = cuda_ms(lambda: rollout_pick_cuda.rollout_pick_costs(model, U, s0), 20)
        teams[label] = dict(max_abs_err=alt_err, ms=alt_ms)
        log("K2", f"{label}: {alt_ms:.4f} ms at K={K} H={H}")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound=b, teams=teams)


def phase_fused_mppi(model, k1_rates):
    cost = pick_cost(model)
    sim_state = init_state(model, device=DEV)
    small = MPPIConfig(horizon=4, n_samples=K)
    eps = torch.randn((K, 4, model.nu), generator=torch.Generator(DEV).manual_seed(1),
                      device=DEV) * 0.05
    ms_small = init_mppi(model, small, seed=0, device=DEV)
    ms_f, u0_f, J_f = make_fused_pick_solver(model, small)(ms_small, sim_state, eps=eps)
    ms_k, u0_k, J_k = make_mppi_solver(model, small, cost)(ms_small, sim_state, eps=eps)
    check("fused", "fused vs K1-route solve at H=4: u0", max_err(u0_f, u0_k), 1e-5)
    check("fused", "fused vs K1-route solve at H=4: J", max_err(J_f, J_k), 1e-4)
    check("fused", "fused vs K1-route solve at H=4: nominal", max_err(ms_f.nominal, ms_k.nominal),
          1e-5)

    cfg = MPPIConfig(horizon=H, n_samples=K)
    solver = make_fused_pick_solver(model, cfg)
    ms = init_mppi(model, cfg, seed=0, device=DEV)
    ms, u0, J = solver(ms, sim_state)
    torch.cuda.synchronize()
    reset_counts()
    n_solves, Js = 20, []
    for _ in range(n_solves):
        ms, u0, J = solver(ms, sim_state)
        Js.append(J)
    torch.cuda.synchronize()
    launches = counts()
    if launches != only(K2=n_solves * cfg.n_iters):
        raise AssertionError(f"fused MPPI launches {launches}, expected "
                             f"{n_solves * cfg.n_iters} of K2 only")
    if not bool(torch.isfinite(torch.stack(Js)).all()):
        raise AssertionError("fused MPPI gave a non-finite cost")
    log("fused", f"H={H} K={K}: {n_solves} solves, launches {launches} "
                 f"({launches['K2'] // n_solves} K2 and 0 K1 per solve)")
    rates, _ = solves_per_sec(solver, ms, sim_state)
    log("fused", f"fused route: {rate_line(rates)} x 20 solves; K1 route "
                 f"{statistics.median(k1_rates):.2f} (same run)")
    return launches["K2"], rates


def ee_goal(model, s0):
    xp, xq, _ = kin.fk(model, s0.qpos)
    p, _ = kin.site_pose(model, xp, xq, "eer_site")
    return p.cpu().numpy() + np.array([0.0, 0.05, -0.05], np.float32)


def ee_error_mm(model, s0, us, goal):
    """EE distance to the goal (mm) after each control of the plan, executed
    open loop on the plant (examples/9_mpc_ilqr.py). The last entry is the
    state after all H controls, which the cost does not score (no final
    cost), so the last control only minimizes w_ctrl |u|^2; the one before
    it is the last scored state."""
    s, errs = s0, []
    goal = torch.as_tensor(goal, device=DEV)
    i = model.site_index("eer_site")
    for t in range(us.shape[0]):
        s, aux = engine.control_step(model, s, us[t])
        errs.append(torch.linalg.vector_norm(aux.site_pos[i] - goal))
    return 1e3 * torch.stack(errs).cpu().numpy()


def ee_line(errs):
    if not np.all(np.isfinite(errs)):
        raise AssertionError("EE tracking error is not finite")
    return (f"EE tracking error on control_step: {errs[-1]:.2f} mm after all "
            f"{len(errs)} controls, {errs[-2]:.2f} mm at the last scored state, mean "
            f"{errs.mean():.2f} mm over the plan")


def ilqr_setup(model, horizon):
    s0 = init_state(model, device=DEV)
    goal = ee_goal(model, s0)
    cost_xu, quad_xu = make_ee_tracking_cost_ilqr(model, goal, w_pos=50.0, w_vel=0.01,
                                                  w_ctrl=0.001)
    cfg = ilqr.ILQRConfig(horizon=horizon, n_iters=10, contact=False, reduced_state=True)
    us = torch.as_tensor(model.home_qpos[: model.nu], dtype=torch.float32,
                         device=DEV).repeat(horizon, 1)
    return s0, goal, cost_xu, quad_xu, cfg, us


def solve_checked(phase, model, cfg, cost_xu, quad_xu, solve, s0, us, expected):
    """One solve with its launches counted, then its plan replayed open loop
    on the plain route: the solve's trajectory and cost came from the
    forward-pass kernel (K3, or K1 in batches), so a wrong forward pass
    shows as a replay that disagrees."""
    reset_counts()
    t0 = time.perf_counter()
    r = solve(s0, us)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    trace = r.cost_trace.cpu().numpy()
    log(phase, f"{seconds:.3f} s; launches per solve {launches}; cost trace "
               f"{np.array2string(trace, precision=5)}")
    if launches != expected:
        raise AssertionError(f"{phase}: launches {launches}, expected {expected}")
    # non-increasing by construction (the monotone accept); finite is not
    if not np.all(np.isfinite(trace)) or not np.all(np.diff(trace) <= 1e-5):
        raise AssertionError(f"{phase}: cost trace is not finite and non-increasing")
    replay = ilqr._build_pieces(model, cfg, cost_xu, quad_xu=quad_xu, ops=ilqr.PLAIN_OPS)[0]
    x0 = ilqr.flatten_state(s0, reduced=cfg.reduced_state)
    xs_re, cost_re = replay(x0, r.us, s0)
    _, cost_init = replay(x0, ilqr._clip_u(model, us), s0)
    cost = float(r.cost)
    check(phase, f"plan replayed on the plain route: cost (solve {cost:.6f})",
          abs(float(cost_re) - cost), 1e-3 * abs(cost))
    check(phase, "plan replayed on the plain route: xs", max_err(xs_re, r.xs),
          5e-3 + 1e-3 * float(r.xs.abs().max()))
    if not cost < float(cost_init):
        raise AssertionError(f"{phase}: the solve did not lower the cost of its warm start "
                             f"({cost:.6f} vs {float(cost_init):.6f})")
    log(phase, f"cost {float(cost_init):.6f} at the warm start, {cost:.6f} after the solve")
    return r, launches, seconds


def fd_probes(model, cfg, cost_xu, quad_xu, xs, us, s0):
    """The states of one FD linearization's probe batch (K = H (n + m)), as
    the substep sees them, recorded through the kernel route's derivs."""
    seen = []

    def substep(model_, s, dt, contact, implicit):
        seen.append(s)
        return engine.substep(model_, s, dt, contact, implicit)

    ops = ilqr.KERNEL_OPS._replace(substep=substep)
    ilqr._build_pieces(model, cfg, cost_xu, quad_xu=quad_xu, ops=ops)[1](xs, us, s0)
    s = seen[0]
    return [a.contiguous() for a in (s.qpos, s.qvel, s.ctrl, torch.cat(
        [s.cube_pos, s.cube_quat, s.cube_linvel, s.cube_angvel], dim=-1))]


def phase_ilqr(model):
    s0, goal, cost_xu, quad_xu, cfg, us = ilqr_setup(model, H)
    solve = ilqr.make_ilqr_solver(model, cfg, cost_xu, quad_xu=quad_xu)
    solve(s0, us)  # first call builds the cached tensors
    r, launches, _ = solve_checked("ilqr", model, cfg, cost_xu, quad_xu, solve, s0, us,
                                only(K1=10, K3=11, K4=10))
    rates = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            solve(s0, us)
        torch.cuda.synchronize()
        rates.append(5 / (time.perf_counter() - t0))
    log("ilqr", f"solo H={H} 10 iterations: {rate_line(rates)} x 5 solves")
    # where a solve's time goes: device busy against the unprofiled wall
    # time, and the device time of K1, K3 and K4 per solve and per launch
    wall = 1e3 / statistics.median(rates)
    busy, n_launch, by_kernel = device_profile(lambda: solve(s0, us), 3)
    profiled = {}
    for name, tag in (("K1", "substep_kernel"), ("K3", "rollout_feedback_kernel"),
                      ("K4", "riccati_kernel")):
        t, n = map(sum, zip(*(v for key, v in by_kernel.items() if tag in key)))
        profiled[name] = t / n
        log("ilqr", f"{name} ({tag}): {t:.3f} ms per solve over {n:.0f} launches, "
                    f"{1e3 * t / n:.2f} us per launch on the device")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    log("ilqr", f"profile of 3 solves: device busy {busy:.3f} ms per solve ({busy / wall:.1%} "
                f"of the unprofiled {wall:.1f} ms), {n_launch:.0f} kernel launches per solve; "
                f"largest kernels (ms per solve): "
                + ", ".join(f"{name[:40]} {t:.3f}" for name, (t, _) in top))

    plain = ilqr.make_ilqr_solver(model, cfg, cost_xu, quad_xu=quad_xu, ops=ilqr.PLAIN_OPS)
    t0 = time.perf_counter()
    rp = plain(s0, us)
    torch.cuda.synchronize()
    tp = time.perf_counter() - t0
    final_k, final_p = float(r.cost), float(rp.cost)
    trace_p = rp.cost_trace.cpu().numpy()
    log("ilqr", f"plain route solve {tp:.2f} s; trace {np.array2string(trace_p, precision=5)}; "
                f"final cost {final_p:.6f} vs kernel route {final_k:.6f}; max |us diff| "
                f"{max_err(rp.us, r.us):.3e}; first iteration {float(rp.cost_trace[0]):.5f} vs "
                f"{float(r.cost_trace[0]):.5f}")
    # a sanity check of the whole solve: separately computed solves flip
    # line-search choices on near-ties (tests/test_parallel.py:221-230), and
    # the plain route flips the first one here, so the iterates differ and
    # only the final costs are compared (they ended 5e-5 apart on an H100),
    # at 1%. The kernels' correctness is held by the per-kernel checks and
    # the replay above.
    if not (np.all(np.diff(trace_p) <= 1e-5) and abs(final_k - final_p) <= 0.01 * final_p):
        raise AssertionError("plain-route iLQR solve disagrees with the kernel route")
    log("ilqr", ee_line(ee_error_mm(model, s0, r.us, goal)))

    # K1, K3 and K4 on the first iteration's real inputs
    rollout0, derivs, _, _, _ = ilqr._build_pieces(model, cfg, cost_xu, quad_xu=quad_xu)
    x0 = ilqr.flatten_state(s0, reduced=True)
    xs, _ = rollout0(x0, us, s0)
    probes = fd_probes(model, cfg, cost_xu, quad_xu, xs, us, s0)
    n_probe = probes[0].shape[0]
    k1 = dict(K=n_probe, launches=launches["K1"], max_abs_err=compare_substep(
        f"iLQR FD probes K={n_probe} contact=False", model, cfg.dt, False, True, probes))
    k1["ms"], k1["plain_ms"], k1["bound"] = time_substep(
        f"K={n_probe} contact-free FD probes", model, False, probes)
    dv = [a.contiguous() for a in derivs(xs, us, s0)]
    dv_plain = ilqr._build_pieces(model, cfg, cost_xu, quad_xu=quad_xu,
                                  ops=ilqr.PLAIN_OPS)[1](xs, us, s0)
    # each slope divides a probe's next-state difference by its step, eps =
    # 1e-3 here (one-sided, toward the roomier side), so a slope may differ
    # by the substep's own tolerance over eps: 1e-2 in the qpos rows and
    # 1e-1 in the qvel rows (the qvel probes above differed by 1.5e-5, a
    # slope by 1.5e-2, measured on an H100)
    nq = model.nq
    for name, g, w in zip("AB", dv[:2], dv_plain[:2]):
        for rows, sl in (("qpos", slice(0, nq)), ("qvel", slice(nq, 2 * nq))):
            err = max_err(g[:, sl], w[:, sl])
            check("K1", f"FD {name}, {rows} rows, kernel vs plain route (slopes up to "
                        f"{float(w[:, sl].abs().max()):.3g})", err, TOL[rows] / cfg.fd_eps)
            k1[f"fd_{name}_{rows}_err"] = err
    lam = torch.zeros((), device=DEV)
    ks, Ks = riccati_cuda.riccati_sweep(*dv, cfg.reg, lam_extra=lam)
    wks, wKs = riccati_cuda.riccati_sweep_reference(*dv, cfg.reg, lam_extra=lam)
    k4_err = max(max_err(ks, wks), max_err(Ks, wKs))
    scale = max(float(wks.abs().max()), float(wKs.abs().max()))
    check("K4", f"kernel vs plain on the solo solve's first iteration (gains up to {scale:.3g})",
          k4_err, 1e-3 * scale)
    cube0 = torch.cat([s0.cube_pos, s0.cube_quat, s0.cube_linvel, s0.cube_angvel])
    alphas = torch.tensor(cfg.alphas, device=DEV)
    fb_args = (model, x0, cube0, xs[:-1].contiguous(), us, ks, Ks, alphas)
    gx, gu = rollout_feedback_cuda.rollout_feedback(*fb_args)
    wx, wu = rollout_feedback_cuda.rollout_feedback_reference(*fb_args)
    # 50 closed-loop steps grow the two versions' float32 rounding apart
    # (1.3e-3 in the states with random gains, measured on an H100)
    err_u, err_x = max_err(gu, wu), max_err(gx, wx)
    check("K3", f"kernel vs plain at B={len(cfg.alphas)} H={H}: us", err_u,
          1e-4 + 1e-3 * float(wu.abs().max()))
    check("K3", f"kernel vs plain at B={len(cfg.alphas)} H={H}: xs", err_x,
          5e-3 + 1e-3 * float(wx.abs().max()))
    k3 = dict(max_abs_err=max(err_u, err_x), profiled_ms=profiled["K3"],
              ms=cuda_ms(lambda: rollout_feedback_cuda.rollout_feedback(*fb_args), 10),
              plain_ms=cuda_ms(lambda: rollout_feedback_cuda.rollout_feedback_reference(*fb_args),
                               2))
    n, nu, B = 2 * model.nq, model.nu, len(cfg.alphas)
    k3["bound"] = bound(B * H * (substep_flops(model, False) + 2 * nu * n + 3 * nu),
                        4 * (n + 13 + H * (n + 2 * nu + nu * n) + B + B * H * (n + nu)))
    log("K3", f"B={B} H={H}: kernel {k3['ms']:.4f} ms, plain {k3['plain_ms']:.2f} ms, "
              f"bound {k3['bound'][0]:.6f} ms ({k3['bound'][1]})")

    k4 = dict(max_abs_err=k4_err, profiled_ms=profiled["K4"])
    for (h, n_, m_) in ((50, 20, 10), (100, 40, 20)):
        prob = [torch.as_tensor(a, device=DEV) for a in riccati_cuda.random_problem(3, h, n_, m_)]
        got = riccati_cuda.riccati_sweep(*prob, cfg.reg, lam_extra=lam)
        want = riccati_cuda.riccati_sweep_reference(*prob, cfg.reg, lam_extra=lam)
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
        check("K4", f"kernel vs plain, seeded ({h}, {n_}, {m_}) (gains up to {scale:.3g})", err,
              1e-4 * scale)
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        ms = cuda_ms(lambda: riccati_cuda.riccati_sweep(*prob, cfg.reg, lam_extra=lam), 20)
        plain_ms = cuda_ms(
            lambda: riccati_cuda.riccati_sweep_reference(*prob, cfg.reg, lam_extra=lam), 2)
        nbytes = 4 * (h * (2 * n_ * n_ + n_ * m_ + n_ + m_ + m_ * m_ + m_ * n_) + n_ + n_ * n_
                      + 1 + h * (m_ + m_ * n_))
        b = bound(h * riccati_step_flops(n_, m_), nbytes)
        log("K4", f"({h}, {n_}, {m_}): kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                  f"bound {b[0]:.6f} ms ({b[1]})")
        if (n_, m_) == (2 * model.nq, model.nu):  # the main path's widths
            k4.update(ms=ms, plain_ms=plain_ms, bound=b)
    return launches, k1, k3, k4


def phase_device_times(model, k1, k2, fused_rates):
    """Device time per launch (torch.profiler) of K1 and K2 on their main
    paths' shapes, read after every host-bound rate of the MPPI, closed-loop,
    fused and iLQR phases, as the rates were read before these profiles
    existed: K1 at K=256 with contact and at K=1500 without (and its
    alternate team shapes, each first checked against the plain version),
    and a breakdown of 10 fused MPPI solves with K2's device time per
    launch. Back-to-back CUDA events of K1 read the wrapper's host time."""
    inputs = [torch.as_tensor(a, device=DEV)
              for a in substep_cuda.random_inputs(model, K, seed=0)]
    probes = [torch.as_tensor(a, device=DEV)
              for a in substep_cuda.random_inputs(model, 1500, seed=1)]

    def device_ms():
        return (kernel_device_ms(lambda: substep_cuda.substep_batched(
                    model, 0.02, True, True, *inputs), "substep_kernel"),
                kernel_device_ms(lambda: substep_cuda.substep_batched(
                    model, 0.02, False, True, *probes), "substep_kernel"))

    k1["profiled_ms"], k1["profiled_ms_k1500"] = device_ms()
    log("K1", f"device time per launch (profiler): {1e3 * k1['profiled_ms']:.2f} us at K={K} "
              f"with contact, {1e3 * k1['profiled_ms_k1500']:.2f} us at K=1500 without (32 "
              f"lanes, 4 warps per block)")
    k1["teams"] = {}
    for i, label in enumerate(ALTERNATES["K1"][1]):
        with built_with("K1", i):
            err = max(compare_substep(f"{label}: K={K} dt={dt} implicit={implicit}", model, dt,
                                      True, implicit, inputs)
                      for dt, implicit in ((0.02, True), (0.002, False)))
            err = max(err, compare_substep(f"{label}: K=1500 contact=False", model, 0.02, False,
                                           True, probes))
            alt = device_ms()
        k1["teams"][label] = dict(max_abs_err=err, profiled_ms=alt[0], profiled_ms_k1500=alt[1])
        log("K1", f"{label}: device time per launch {1e3 * alt[0]:.2f} us at K={K}, "
                  f"{1e3 * alt[1]:.2f} us at K=1500")

    # where a fused solve's time goes: device busy against the unprofiled
    # wall time, and K2's device time per launch inside the solve
    cfg = MPPIConfig(horizon=H, n_samples=K)
    solver = make_fused_pick_solver(model, cfg)
    sim_state = init_state(model, device=DEV)
    ms = init_mppi(model, cfg, seed=0, device=DEV)
    ms, _, _ = solver(ms, sim_state)
    busy, n_launch, by_kernel = device_profile(lambda: solver(ms, sim_state), 10)
    t, n = map(sum, zip(*(v for key, v in by_kernel.items() if "rollout_pick_kernel" in key)))
    k2["profiled_ms"] = t / n
    wall = 1e3 / statistics.median(fused_rates)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:4]
    log("fused", f"profile of 10 solves: device busy {busy:.3f} ms per solve ({busy / wall:.1%} "
                 f"of the unprofiled {wall:.3f} ms), {n_launch:.0f} kernel launches per solve; "
                 f"K2 {1e3 * t / n:.2f} us per launch on the device (CUDA events: "
                 f"{k2['ms']:.4f} ms); largest kernels (ms per solve): "
                 + ", ".join(f"{name[:40]} {t_:.4f}" for name, (t_, _) in top))


def phase_ilqr_torso():
    model = get_model("torso")
    horizon = TORSO_H
    s0, goal, cost_xu, quad_xu, cfg, us = ilqr_setup(model, horizon)
    solve = ilqr.make_ilqr_solver(model, cfg, cost_xu, quad_xu=quad_xu)
    # nq = 20 > 12: the forward passes take B-batched K1 launches, not K3
    expected = only(K1=10 + horizon + 10 * horizon, K4=10)
    r, _, seconds = solve_checked("torso", model, cfg, cost_xu, quad_xu, solve, s0, us,
                                  expected)
    log("torso", f"H={horizon} 10 iterations: {seconds:.3f} s for the first solve")
    log("torso", ee_line(ee_error_mm(model, s0, r.us, goal)))


class Recorder:
    """Records the arguments of call number `at` (from 0) of a module
    function that the staged substep looks up at call time, and passes
    every call on."""

    def __init__(self, module, name, at):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.at, self.calls, self.args = at, 0, None

    def __enter__(self):
        def record(*args):
            if self.calls == self.at:
                self.args = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            self.calls += 1
            return self.fn(*args)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def time_pair(fn, ref, n_kernel=200, n_plain=5):
    ms = cuda_ms(fn, n_kernel)
    plain_ms = cuda_ms(lambda: plain(ref), n_plain)
    return ms, plain_ms


def k5_errors(tag, m, q, v):
    """K5 against its plain version: frames 1e-5, bias 1e-4
    (tests/test_pallas.py:85-88); the largest error."""
    got = rnea_cuda.rnea_terms_batched(m, q, v)
    want = plain(rnea_cuda.rnea_terms_batched_reference, m, q, v)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    for name, e, tol in zip(("xpos", "xquat", "axis", "bias"), errs, (1e-5, 1e-5, 1e-5, 1e-4)):
        check("K5", f"{tag}: {name}", e, tol)
    return max(errs)


def k6_errors(tag, m, args):
    """K6 against its plain version: forces 1e-4, flags equal
    (tests/test_pallas.py:135-141); the largest error."""
    got = contacts_cuda.contact_forces_batched(m, *args)
    want = plain(contacts_cuda.contact_forces_batched_reference, m, *args)
    errs = []
    for name in ("force_cube", "torque_cube", "tip_forces"):
        errs.append(max_err(getattr(got, name), getattr(want, name)))
        check("K6", f"{tag}: {name}", errs[-1], 1e-4)
    for name in ("touch_tip", "touch_table"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"K6 {tag}: {name} flags differ")
    return max(errs)


def k7_errors(tag, M, b):
    """K7 against its plain version and against float64, at 1e-4 of the
    largest solution entry; the error against the plain version."""
    got = chol_solve_cuda.cholesky_solve_batched(M, b)
    want = plain(chol_solve_cuda.cholesky_solve_batched_reference, M, b)
    want64 = torch.linalg.solve(M.double(), b.double())
    scale = float(want64.abs().max())
    err = max_err(got, want)
    check("K7", f"{tag}: kernel vs plain (solutions up to {scale:.3g})", err, 1e-4 * scale)
    check("K7", f"{tag}: kernel vs float64", max_err(got.double(), want64), 1e-4 * scale)
    return err


def phase_staged_kernels(model, cost):
    """K5, K6 and K7 against their plain versions on the inputs of a staged
    substep of an MPPI solve (solo, K=256), and on seeded torso inputs;
    their times and bounds. The solve starts with the cube between the
    fingertips, and the inputs are those of its third substep: from rest
    the first substep has no contact, the third has fingertip and table
    contacts. Returns the rows and the K5, K6 and K7 inputs."""
    cfg = MPPIConfig(horizon=H, n_samples=K)
    home = torch.as_tensor(model.home_qpos, dtype=torch.float32, device=DEV)
    tips = engine._tips_from_frames(model, *kin.fk(model, home)[:2])
    sim_state = init_state(model, cube_pos=tips.mean(0).cpu().numpy(), device=DEV)
    solver = make_mppi_solver(model, cfg, cost, substep_fn=engine.substep_staged)
    with Recorder(kin, "rnea_terms_fast", 2) as r5, \
            Recorder(contacts, "contact_forces_fast", 2) as r6, \
            Recorder(linalg, "batch_aware_cholesky_solve", 2 * (1 + constants.CONSTRAINT_ITERS)) \
            as r7:
        solver(init_mppi(model, cfg, seed=0, device=DEV), sim_state)
    torch.cuda.synchronize()
    rows = {}

    def k5_check(tag, m, q, v):
        err = k5_errors(tag, m, q, v)
        k_ = q.shape[0]
        ms, plain_ms = time_pair(lambda: rnea_cuda.rnea_terms_batched(m, q, v),
                                 lambda: rnea_cuda.rnea_terms_batched_reference(m, q, v))
        b = bound(k_ * rnea_flops(m), 4 * k_ * (2 * m.nq + 11 * m.nq))
        log("K5", f"{tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.6f} ms "
                  f"({b[1]}): {rnea_flops(m)} operations per rollout")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b)

    def k6_check(tag, m, args):
        err = k6_errors(tag, m, args)
        want = contacts_cuda.contact_forces_batched_reference(m, *args)
        log("K6", f"{tag}: touching tip {float(want.touch_tip.float().mean()):.3f}, table "
                  f"{float(want.touch_table.float().mean()):.3f}")
        k_, T = args[0].shape[0], len(m.fingertips)
        ms, plain_ms = time_pair(lambda: contacts_cuda.contact_forces_batched(m, *args),
                                 lambda: contacts_cuda.contact_forces_batched_reference(m, *args))
        b = bound(k_ * contact_flops(m), k_ * (4 * (6 * T + 13 + 6 + 3 * T) + T + 1))
        log("K6", f"{tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.6f} ms "
                  f"({b[1]}): {contact_flops(m)} operations per rollout")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b)

    def k7_check(tag, M, b):
        err = k7_errors(tag, M, b)
        k_, n = b.shape
        ms, plain_ms = time_pair(lambda: chol_solve_cuda.cholesky_solve_batched(M, b),
                                 lambda: chol_solve_cuda.cholesky_solve_batched_reference(M, b))
        library_ms = cuda_ms(lambda: torch.linalg.solve(M, b), 200)
        bnd = bound(k_ * chol_flops(n), 4 * k_ * (n * (n + 1) // 2 + 2 * n))
        log("K7", f"{tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg.solve "
                  f"{library_ms:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}): {chol_flops(n)} "
                  f"operations per item (the lower triangle read)")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound=bnd)

    # the third staged substep's real inputs (solo, K=256)
    q, v = (a.contiguous() for a in r5.args[1:3])
    rows["K5"] = k5_check(f"staged substep 3, K={q.shape[0]}", model, q, v)
    args6 = tuple(a.contiguous() for a in r6.args[1:])
    rows["K6"] = k6_check(f"staged substep 3, K={q.shape[0]}", model, args6)
    M, b = (a.contiguous() for a in r7.args)
    rows["K7"] = k7_check(f"staged substep 3 (M + h B, tau), K={b.shape[0]} n={b.shape[1]}",
                          M, b)

    # seeded torso inputs (nq = 20, 4 fingertips) and a seeded n = 20 SPD problem
    torso = get_model("torso")
    tq, tv, _, cube = (torch.as_tensor(a, device=DEV)
                       for a in substep_cuda.random_inputs(torso, K, seed=0))
    rows["K5"]["torso"] = k5_check(f"torso seeded K={K}", torso, tq, tv)
    xp, xq, ax, _ = kin.rnea_terms(torso, tq, tv)
    tips, tip_vel, _, _ = engine._tip_state(torso, xp, xq, ax, tv)
    targs6 = tuple(a.contiguous() for a in (tips, tip_vel, cube[:, :3], cube[:, 3:7],
                                             cube[:, 7:10], cube[:, 10:]))
    rows["K6"]["torso"] = k6_check(f"torso seeded K={K}", torso, targs6)
    rng = np.random.RandomState(0)
    A = rng.randn(K, 20, 20)
    M20 = torch.as_tensor(A @ A.transpose(0, 2, 1) / 20 + np.eye(20), dtype=torch.float32,
                          device=DEV)
    b20 = torch.as_tensor(rng.randn(K, 20), dtype=torch.float32, device=DEV)
    rows["K7"]["n20"] = k7_check(f"seeded SPD K={K} n=20", M20, b20)
    for name in STAGED:
        for key in ("", "torso", "n20"):
            r = rows[name].get(key) if key else rows[name]
            if r is not None:
                r["bound_ms"], r["bound_by"] = r["bound"]
    inputs = {"K5": (model, q, v), "K5 torso": (torso, tq, tv), "K6": (model, args6),
              "K6 torso": (torso, targs6), "K7": (M, b), "K7 n=20": (M20, b20)}
    return rows, inputs


def phase_staged_device_times(rows, inputs):
    """Device time per launch (torch.profiler) of K5, K6 and K7 on phase
    8's inputs, read after the staged route's rates; then each alternate
    build of K5, K6 and K7 (ALTERNATES), checked against the plain version
    as phase 8 checks the kernel (K5 and K6 on the solo inputs, K7 at n=10
    and n=20) and timed the same way."""
    def k5_device(m, q, v):
        return kernel_device_ms(lambda: rnea_cuda.rnea_terms_batched(m, q, v), "rnea_kernel")

    def k6_device(m, args):
        return kernel_device_ms(lambda: contacts_cuda.contact_forces_batched(m, *args),
                                "contacts_kernel")

    def k7_device(M, b):
        return kernel_device_ms(lambda: chol_solve_cuda.cholesky_solve_batched(M, b),
                                "chol_solve_kernel")

    rows["K5"]["device_ms"] = k5_device(*inputs["K5"])
    rows["K5"]["torso"]["device_ms"] = k5_device(*inputs["K5 torso"])
    rows["K6"]["device_ms"] = k6_device(*inputs["K6"])
    rows["K6"]["torso"]["device_ms"] = k6_device(*inputs["K6 torso"])
    rows["K7"]["device_ms"] = k7_device(*inputs["K7"])
    rows["K7"]["n20"]["device_ms"] = k7_device(*inputs["K7 n=20"])
    log("K5", f"device time per launch (profiler): {1e3 * rows['K5']['device_ms']:.2f} us solo "
              f"K={K} (32 lanes, 4 warps per block), {1e3 * rows['K5']['torso']['device_ms']:.2f} "
              f"us torso (32 lanes, 1 warp per block)")
    one = torch.zeros(1, device=DEV)
    floor_ms = kernel_device_ms(lambda: one.fill_(1.0), "FillFunctor")
    log("device", f"a one-element torch fill: {1e3 * floor_ms:.2f} us per launch on the device "
                  f"(profiler), the least a launch reads there")
    log("K6", f"device time per launch (profiler): {1e3 * rows['K6']['device_ms']:.2f} us solo "
              f"K={K}, {1e3 * rows['K6']['torso']['device_ms']:.2f} us torso (32 lanes, 4 warps "
              f"per block)")
    log("K7", f"device time per launch (profiler): {1e3 * rows['K7']['device_ms']:.2f} us at "
              f"n=10 (16-lane teams), {1e3 * rows['K7']['n20']['device_ms']:.2f} us at n=20 "
              f"(32-lane teams); 2 warps per block")
    cases = {"K5": (k5_errors, k5_device, ("K5",)),
             "K6": (k6_errors, k6_device, ("K6",)),
             "K7": (k7_errors, k7_device, ("K7", "K7 n=20"))}
    for kernel, (errors, device, keys) in cases.items():
        rows[kernel]["alternates"] = {}
        for i, label in enumerate(ALTERNATES[kernel][1]):
            with built_with(kernel, i):
                err = max(errors(f"{label}, {key}", *inputs[key]) for key in keys)
                times = [device(*inputs[key]) for key in keys]
            rows[kernel]["alternates"][label] = dict(max_abs_err=err,
                                                     device_ms=dict(zip(keys, times)))
            log(kernel, f"{label}: device time per launch "
                        + ", ".join(f"{1e3 * t:.2f} us ({key})" for t, key in zip(times, keys)))


def phase_staged_mppi(model, cost, k1_rates, fused_rates):
    """The staged route through make_mppi_solver: launches per solve, the
    plain route on one injected draw, solves/s."""
    cfg = MPPIConfig(horizon=H, n_samples=K)
    sim_state = init_state(model, device=DEV)
    solver = make_mppi_solver(model, cfg, cost, substep_fn=engine.substep_staged)
    ms = init_mppi(model, cfg, seed=0, device=DEV)
    ms, u0, J = solver(ms, sim_state)
    torch.cuda.synchronize()
    reset_counts()
    n_solves, Js = 5, []
    for _ in range(n_solves):
        ms, u0, J = solver(ms, sim_state)
        Js.append(J)
    torch.cuda.synchronize()
    launches = counts()
    steps = n_solves * H * cfg.n_substeps * cfg.n_iters
    expected = only(K5=steps, K6=steps,
                    K7=steps * (1 + constants.CONSTRAINT_ITERS))
    if launches != expected:
        raise AssertionError(f"staged MPPI launches {launches}, expected {expected}")
    if not bool(torch.isfinite(torch.stack(Js)).all()) or u0.shape != (model.nu,):
        raise AssertionError("staged MPPI gave a non-finite cost or a wrong-shaped control")
    log("staged", f"H={H} K={K}: {n_solves} solves, launches {launches} "
                  f"(per solve K5 {launches['K5'] // n_solves}, K6 {launches['K6'] // n_solves}, "
                  f"K7 {launches['K7'] // n_solves}, K1 0)")

    small = cfg._replace(horizon=4)
    eps = torch.randn((K, 4, model.nu), generator=torch.Generator(DEV).manual_seed(1),
                      device=DEV) * 0.05
    ms_small = init_mppi(model, small, seed=0, device=DEV)
    ms_s, u0_s, J_s = make_mppi_solver(model, small, cost, substep_fn=engine.substep_staged)(
        ms_small, sim_state, eps=eps)
    ms_p, u0_p, J_p = plain(make_mppi_solver(model, small, cost, substep_fn=engine._substep_torch),
                            ms_small, sim_state, eps=eps)
    check("staged", "staged route vs plain route at H=4: u0", max_err(u0_s, u0_p), 1e-5)
    check("staged", "staged route vs plain route at H=4: J", max_err(J_s, J_p), 1e-4)
    check("staged", "staged route vs plain route at H=4: nominal",
          max_err(ms_s.nominal, ms_p.nominal), 1e-5)

    rates, ms = solves_per_sec(solver, ms, sim_state, n_solves=5)
    log("staged", f"staged route: {rate_line(rates)} x 5 solves; K1 route "
                  f"{statistics.median(k1_rates):.2f}, fused route "
                  f"{statistics.median(fused_rates):.2f} (same run)")
    busy, n_launch, by_kernel = device_profile(lambda: solver(ms, sim_state), 2)
    wall = 1e3 / statistics.median(rates)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:5]
    log("staged", f"profile of 2 solves: device busy {busy:.3f} ms per solve ({busy / wall:.1%} "
                  f"of the unprofiled {wall:.1f} ms), {n_launch:.0f} kernel launches per solve; "
                  f"largest kernels (ms per solve): "
                  + ", ".join(f"{name[:40]} {t:.3f}" for name, (t, _) in top))
    # device time per launch of the staged kernels, without the host's
    # launch gaps that bound the CUDA-event times of back-to-back calls
    profiled = {}
    for name, tag in (("K5", "rnea_kernel"), ("K6", "contacts_kernel"),
                      ("K7", "chol_solve_kernel")):
        t, n = map(sum, zip(*(v for key, v in by_kernel.items() if tag in key)))
        profiled[name] = t / n
        log("staged", f"{name} ({tag}): {t:.3f} ms per solve over {n:.0f} launches, "
                      f"{1e3 * t / n:.2f} us per launch on the device")
    return launches, profiled


def profile_kernels(fn, n):
    """torch.profiler over n calls of fn: {name: (device ms, launches) per
    call} of every kernel, copy and fill that ran on the device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / n, e.count / n) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def device_profile(fn, n):
    """torch.profiler over n calls of fn: device-busy ms per call, kernel
    launches per call, and {kernel name: (device ms, launches) per call}."""
    rows = profile_kernels(fn, n)
    busy = sum(t for t, _ in rows.values())
    kernels = {k: v for k, v in rows.items()
               if "memcpy" not in k.lower() and "memset" not in k.lower()}
    if busy <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    return busy, sum(c for _, c in kernels.values()), kernels


def floor_flops(variant, n, m):
    """csrc/sweep_floor.cuh: one step of `variant`."""
    Z, N1 = n + m, n + 1
    if variant in ("loop", "load1"):
        return n * N1 + 1
    if variant == "load1nostore":
        return n * N1 + 1 + m * N1
    if variant == "mem":
        return n * N1 + 6 + m * N1
    f = Z * N1 * 2 * n  # GW
    f += (n * n + m * n + m * m) * (2 * n + 1) + Z  # Q blocks, qv
    f += m + m * N1 + m * N1 * (2 * m + 2) + n * N1 * (4 * m + 2)  # gains, V, value update
    if variant in ("trans", "gersh"):
        f += 2 * m * m + 2 * n * n  # symmetrize Quu and Vxx
    if variant == "gersh":
        f += 3 * m * m + 6 * m  # row stats, lift
    return f


def floor_bytes(variant, h, n, m):
    """Each input the variant reads, once, and both outputs."""
    Z, N1 = n + m, n + 1
    f = n * N1 + h * m * N1  # WT, then ks and Ks
    if variant in ("load1", "load1nostore"):
        f += h
    elif variant == "mem":
        f += h * (4 + m + m * n)
    elif variant != "loop":
        f += h * (n * Z + n + m + n * n + m * m + m * n)
    return 4 * f


def phase_sweep_floor():
    """Each variant of the floor experiment against its plain version at
    the experiment's widths, then the tool's timings beside K4's."""
    h, n, m = 100, exp_sweep_floor.N, exp_sweep_floor.M
    inputs = [torch.as_tensor(a, device=DEV) for a in sweep_floor_cuda.random_inputs(h, n, m)]
    rows = {}
    for v in sweep_floor_cuda.VARIANTS:
        got = sweep_floor_cuda.sweep(v, *inputs)
        want = plain(sweep_floor_cuda.sweep_reference, v, *inputs)
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
        check("K8", f"{v}: kernel vs plain ({h}, {n}, {m}) (gains up to {scale:.3g})", err,
              1e-4 * scale)
        plain_ms = cuda_ms(lambda v=v: sweep_floor_cuda.sweep_reference(v, *inputs), 2)
        b = bound(h * floor_flops(v, n, m), floor_bytes(v, h, n, m))
        rows[v] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1])
    reset_counts()
    times, k4_ms = exp_sweep_floor.measure(sweep_floor_cuda.VARIANTS, h, DEV)
    launches = counts()["K8"]
    if launches < len(sweep_floor_cuda.VARIANTS):
        raise AssertionError(f"the floor tool launched K8 {launches} times")
    for v, ms in times.items():
        rows[v]["ms"] = ms
        log("K8", f"{v:13s} {ms:8.4f} ms/sweep ({ms / k4_ms:6.1%} of K4 {k4_ms:.4f} ms), plain "
                  f"{rows[v]['plain_ms']:.2f} ms, bound {rows[v]['bound_ms']:.6f} ms "
                  f"({rows[v]['bound_by']}), max_abs_err {rows[v]['max_abs_err']:.3e}")
    log("K8", f"K4 - gersh {k4_ms - times['gersh']:.4f} ms/sweep: K4's factor and "
              f"substitutions (its P3 and P4) at ({h}, {n}, {m})")
    row = dict(rows["gersh"], launches=launches, k4_ms=k4_ms,
               variants={v: r for v, r in rows.items() if v != "gersh"})
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return row


def strip(r):
    """A nested row for the kernels line: its bound as bound_ms and
    bound_by, nothing else that is not a number, a string or a row."""
    if not isinstance(r, dict):
        return r
    r = dict(r)
    if "bound" in r:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    return {k_: strip(v) for k_, v in r.items()}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    model = get_model("solo_arm")
    log("device", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}")

    mods = (substep_cuda, rollout_pick_cuda, rollout_feedback_cuda, riccati_cuda, rnea_cuda,
            contacts_cuda, chol_solve_cuda, sweep_floor_cuda)
    t0 = time.perf_counter()
    alternates = alternate_libraries()
    ready = _build.build_libraries([m.LIBRARY for m in mods] + alternates)
    for m in mods:
        m._library()
    log("build", f"{len(mods)} libraries and {len(alternates)} alternate builds of K1, K2, "
                 f"K5, K6 and K7 built in parallel and loaded in {time.perf_counter() - t0:.2f} s "
                 f"({', '.join(f'{k} {v[0]:.2f} s' for k, v in ready.items())})")
    # ptxas's registers, stack and spills of every kernel, the alternates'
    # too (their solo-width kernels: nq = 10, "ILi10")
    for name, (_, log_) in ready.items():
        alternate = name.rsplit("_", 1)[-1].startswith("alt")
        lines = log_.splitlines()
        for i, line in enumerate(lines):
            if "entry function" in line and (not alternate or "ILi10" in line):
                log("build", f"{name}: {line.strip()}")
                for more in lines[i + 1:i + 4]:
                    if "stack frame" in more or "Used" in more:
                        log("build", f"{name}: {more.strip()}")

    def no_staged_launch(phase):
        if any(staged_counts().values()):
            raise AssertionError(f"{phase} launched a staged kernel: {staged_counts()}")

    k1 = phase_substep(model)
    k1["launches"], k1_rates = phase_mppi(model)
    phase_closed_loop(model)
    k2 = phase_pick_kernel(model)
    k2["launches"], fused_rates = phase_fused_mppi(model, k1_rates)
    no_staged_launch("the K1, K2 and closed-loop phases")
    ilqr_launches, k1_ilqr, k3, k4 = phase_ilqr(model)
    k3["launches"], k4["launches"] = ilqr_launches["K3"], ilqr_launches["K4"]
    # K1 runs on two main paths: the MPPI solve (K=256, with contact; the
    # row's own numbers) and the iLQR FD probes (contact-free; under "ilqr")
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_ilqr["max_abs_err"])
    k1["ilqr"] = dict(k1_ilqr, bound_ms=k1_ilqr["bound"][0], bound_by=k1_ilqr["bound"][1])
    del k1["ilqr"]["bound"]
    phase_device_times(model, k1, k2, fused_rates)
    phase_ilqr_torso()
    no_staged_launch("the iLQR phases")
    staged, staged_inputs = phase_staged_kernels(model, pick_cost(model))
    launches, profiled = phase_staged_mppi(model, pick_cost(model), k1_rates, fused_rates)
    for name in STAGED:
        staged[name]["launches"] = launches[name]
        staged[name]["profiled_ms"] = profiled[name]
    phase_staged_device_times(staged, staged_inputs)
    reset_counts()
    k8 = phase_sweep_floor()
    no_staged_launch("the K8 phase")

    rows = [
        ("substep_batched", "substep.cu", "gym_kmanip_tpu/ops/pallas_substep.py:404", k1),
        ("rollout_pick_costs", "rollout_pick.cu", "gym_kmanip_tpu/ops/pallas_substep.py:779", k2),
        ("rollout_feedback", "rollout_feedback.cu", "gym_kmanip_tpu/ops/pallas_substep.py:581",
         k3),
        ("riccati_sweep", "riccati.cu", "gym_kmanip_tpu/ops/pallas_riccati.py:678", k4),
        ("rnea_terms_batched", "rnea.cu", "gym_kmanip_tpu/ops/pallas_dynamics.py:219",
         staged["K5"]),
        ("contact_forces_batched", "contacts.cu", "gym_kmanip_tpu/ops/pallas_contacts.py:215",
         staged["K6"]),
        ("cholesky_solve_batched", "chol_solve.cu", "gym_kmanip_tpu/ops/pallas_linalg.py:57",
         staged["K7"]),
        ("sweep_floor", "sweep_floor.cu", "tools/exp_sweep_floor.py:102", k8),
    ]
    for r in (k1, k2, k3, k4):
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    for name, _, _, r in rows:
        if r["launches"] < 1:
            raise AssertionError(f"{name} was not launched on its main path")
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    # the row's own numbers are the main path's; a second path or shape
    # (K1's iLQR probes, the torso, K7 at n = 20, K8's other variants, the
    # alternate builds) sits under a key of its own, as does the device time
    # per launch that the profiler read on the staged route and in the iLQR
    # solve (profiled_ms), and on phase 8's inputs (device_ms)
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    extra = ("ilqr", "torso", "n20", "variants", "k4_ms", "profiled_ms", "profiled_ms_k1500",
             "device_ms", "teams", "alternates")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"gym_kmanip_torch/csrc/{src}",
        "replaces": replaces,
        **{key: r[key] for key in keys},
        # torch.linalg.solve computes K7's function; no single PyTorch call
        # computes any of the others
        "library_ms": r.get("library_ms"),
        **{key: strip(r[key]) for key in extra if key in r},
    } for name, src, replaces, r in rows]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
