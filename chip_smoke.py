"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. build:      compile the substep CUDA kernel from gym_kmanip_torch/csrc.
  2. kernel:     at K=256, random solo-arm states from a seed, in MPC mode
                 (dt=0.02, implicit actuation) and env mode (dt=0.002,
                 explicit): the kernel against its plain PyTorch version on
                 the card (qpos and xpos 1e-5, qvel and cube 1e-4, touch
                 equal), and the time of each.
  3. main path:  the solo-arm MPPI pick solve at H=50, K=256 through the
                 kernel: 20 solves with the launch count checked, the
                 kernel path against the plain path on one injected noise
                 draw at H=4, then solves/s of both paths.
  4. closed loop: the receding-horizon recipe of bench.py (H=20, K=256,
                 2 iterations, 10 substeps of 2 ms) against the plant
                 `control_step` for 30 steps.
The last two lines are the card's name and power limit (nvidia-smi) and
{"ok": true, "device": {...}}. Exits non-zero without a GPU.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

from gym_kmanip_torch.dynamics import contacts, engine  # noqa: E402
from gym_kmanip_torch.dynamics.state import init_state  # noqa: E402
from gym_kmanip_torch.models import get_model, model_tensors  # noqa: E402
from gym_kmanip_torch.mpc.cost import CostParams, cube_pick_cost  # noqa: E402
from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver  # noqa: E402
from gym_kmanip_torch.ops import substep_cuda  # noqa: E402
from gym_kmanip_torch.utils import rotations as rot  # noqa: E402

DEV = torch.device("cuda", 0)
K, H = 256, 50
TOL = {"qpos": 1e-5, "qvel": 1e-4, "cube13": 1e-4, "xpos": 1e-5, "xquat": 1e-5}
OUTS = ("qpos", "qvel", "cube13", "touch", "xpos", "xquat")


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


def tip_penetration(model, xpos, xquat, cube13):
    """Fingertip-cube penetration (K, T) at the pre-step frames."""
    t = model_tensors(model, xpos.device)
    tips = engine._tips_from_frames(model, xpos, xquat)
    R = rot.quat_to_mat(cube13[:, 3:7])[:, None]
    local = ((tips - cube13[:, None, :3])[..., None, :] @ R)[..., 0, :]
    pen, _ = contacts.sphere_box(local, t.tip_radius, 0.02)
    return pen


def phase_kernel(model):
    inputs = [torch.as_tensor(a, device=DEV)
              for a in substep_cuda.random_inputs(model, K, seed=0)]
    worst = 0.0
    for dt, implicit in ((0.02, True), (0.002, False)):
        got = substep_cuda.substep_batched(model, dt, True, implicit, *inputs)
        want = substep_cuda.substep_batched_reference(model, dt, True, implicit, *inputs)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(OUTS, got, want):
            if name == "touch":
                continue
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"kernel {name} is not finite (dt={dt})")
            errs[name] = float((g - w).abs().max())
        flips = (got[3] != want[3]).nonzero().tolist()
        if flips:
            pen = tip_penetration(model, want[4], want[5], inputs[3])
            for k, t in flips:
                log("kernel", f"touch flip at rollout {k} tip {t}: penetration {float(pen[k, t]):.3e}")
            raise AssertionError(f"{len(flips)} touch flags differ (dt={dt})")
        bad = {n: e for n, e in errs.items() if e > TOL[n]}
        log("kernel", f"dt={dt} implicit={implicit} max_abs_err {json.dumps(errs)} "
                      f"touching {float(want[3].float().mean()):.3f}")
        if bad:
            raise AssertionError(f"kernel disagrees with the plain version: {bad}")
        worst = max(worst, max(errs.values()))

    args = (model, 0.02, True, True, *inputs)
    ms = cuda_ms(lambda: substep_cuda.substep_batched(*args), 200)
    plain_ms = cuda_ms(lambda: substep_cuda.substep_batched_reference(*args), 20)
    log("kernel", f"K={K} substep: kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call "
                  f"({1e6 * ms / K:.1f} ns per rollout-substep)")
    return worst, ms, plain_ms


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


def phase_main_path(model):
    params = CostParams()
    cost = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)  # noqa: E731
    cfg = MPPIConfig(horizon=H, n_samples=K)
    solver = make_mppi_solver(model, cfg, cost)
    sim_state = init_state(model, device=DEV)
    ms = init_mppi(model, cfg, seed=0, device=DEV)
    ms, u0, J = solver(ms, sim_state)  # first call builds the cached tensors
    torch.cuda.synchronize()

    substep_cuda.substep_batched.launches = 0
    n_solves, Js = 20, []
    for _ in range(n_solves):
        ms, u0, J = solver(ms, sim_state)
        Js.append(J)
    torch.cuda.synchronize()
    launches = substep_cuda.substep_batched.launches
    expected = n_solves * H * cfg.n_substeps * cfg.n_iters
    Js = torch.stack(Js)
    if launches != expected:
        raise AssertionError(f"substep kernel launched {launches} times, expected {expected}")
    if not bool(torch.isfinite(Js).all()) or u0.shape != (model.nu,):
        raise AssertionError("MPPI solve gave a non-finite cost or a wrong-shaped control")
    log("main", f"H={H} K={K}: {n_solves} solves, {launches} kernel launches "
                f"({launches // n_solves} per solve), J first {float(Js[0]):.4f} "
                f"last {float(Js[-1]):.4f}")

    # the kernel path and the plain path make the same solve on one noise draw
    small = cfg._replace(horizon=4)
    eps = torch.randn((K, 4, model.nu), generator=torch.Generator(DEV).manual_seed(1),
                      device=DEV) * 0.05
    ms_small = init_mppi(model, small, seed=0, device=DEV)
    ms_k, u0_k, J_k = make_mppi_solver(model, small, cost)(ms_small, sim_state, eps=eps)
    ms_p, u0_p, J_p = make_mppi_solver(model, small, cost, substep_fn=engine._substep_torch)(
        ms_small, sim_state, eps=eps)
    du0 = float((u0_k - u0_p).abs().max())
    dJ = float((J_k - J_p).abs())
    dnom = float((ms_k.nominal - ms_p.nominal).abs().max())
    log("main", f"kernel vs plain solve at H=4 K={K}: |du0| {du0:.2e} |dJ| {dJ:.2e} "
                f"|dnominal| {dnom:.2e}")
    if du0 > 1e-5 or dJ > 1e-4 or dnom > 1e-5:
        raise AssertionError("kernel-path solve differs from the plain-path solve")

    rates, ms = solves_per_sec(solver, ms, sim_state)
    plain = make_mppi_solver(model, cfg, cost, substep_fn=engine._substep_torch)
    plain_rates, _ = solves_per_sec(plain, ms, sim_state)
    for name, r in (("kernel", rates), ("plain", plain_rates)):
        log("main", f"{name} path: {statistics.median(r):.2f} solves/s median over "
                    f"{len(r)} x 20 solves (min {min(r):.2f}, max {max(r):.2f})")
    return launches


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


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = get_model("solo_arm")
    log("device", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}")

    log("build", f"substep kernel built and loaded in {substep_cuda.build():.2f} s")
    err, ms, plain_ms = phase_kernel(model)
    launches = phase_main_path(model)
    phase_closed_loop(model)

    print(json.dumps({"kernels": [{
        "name": "substep_batched",
        "route": "cuda",
        "source": "gym_kmanip_torch/csrc/substep.cu",
        "replaces": "gym_kmanip_tpu/ops/pallas_substep.py:404",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
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
