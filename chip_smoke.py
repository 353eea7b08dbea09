"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. build:       compile the eight CUDA libraries from gym_kmanip_torch/csrc,
                  K1 with the solo-width team shapes it was not built with,
                  K2 with its other warps per block, K5 and K7 with their
                  other items per block,
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
                  H=4, then solves/s of both routes (the K1 route's over 3
                  repeats of 10 solves, the plain route's over 2 solves).
  4. closed loop: the receding-horizon recipe of bench.py (H=20, K=256,
                  2 iterations, 10 substeps of 2 ms) against the plant
                  `control_step` for 30 steps.
  5. K2 pick:     the whole-horizon pick-cost kernel against its plain
                  version at K=256 (H=1 1e-5, H=3 1e-3, H=50 1e-4 of the
                  largest total) and against the K1 route's totals at H=50;
                  its time; both team widths of its library at H=50, at
                  K=256 against the plain version and at K=4096 against
                  each other (bit for bit), each timed, and the width the
                  wrapper picks at each K; the alternate block shape at
                  H=50, checked and timed.
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
                  1e-5, J 1e-4, nominal 1e-5), solves/s (3 x 3 solves) beside
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
 10. env:         the four golden env traces (tests/golden/*_env_trace.npz)
                  through the port's `make_task` on the card, full trace and
                  teacher-forced, at tests/test_env_parity.py's bands; every
                  env step launches K1 ten times (K=1), runs no plain
                  substep, and solves its IK with the native host solver.
                  K1 against its plain version on an env state and its
                  device time per launch at K=1; native against numpy IK ms
                  per solve; a 64-step episode of KManipSoloArm and of
                  KManipTorso through KManipEnvSim with seeded random
                  actions: steps/s, and ms per step split into goals (with
                  the device-to-host copy), host IK, decode, control_step,
                  obs and reward.
 11. lqr:         the solo iLQR of phase 7 (H=50) and the torso at H=100
                  with the associative-scan backward (`parallel_backward`)
                  against the serial K4 sweep and the plain serial sweep:
                  launches, solves/s, the largest gap in us, the costs; the
                  parallel cost must not exceed 1.1 x the serial + 1e-3
                  (tests/test_mpc.py:266); and the solve on K4's plain
                  version with and without its Gershgorin lift, whose
                  final costs show what the lift does.
 12. oracle:      FD against the jacfwd oracle (A and B) at solo H=6 without
                  contact, 5e-3 of the largest slope (tests/test_mpc.py:
                  170-171); the ms of one jacfwd linearization.
 13. examples:    examples 9 (solve time, EE error at the last scored state
                  and after the last control) and 11 at their sizes, and
                  example 8 at 30 control steps, with their launches; the
                  first K1 launch of each (robot, dt, contact, implicit, K)
                  and the first K4 launch of each (H, n, m) in them (the
                  iLQR solves' FD probes with contact and their full-state
                  sweeps among them) replayed against the plain versions:
                  K1 at phase 2's bands, K4 at 1e-4 of the largest gain.
 14. vec:         the vec env (env/vec_env.KManipVecEnv) at example 12's N = 64:
                  one 64-step KManipSoloArm episode and 4 steps past its
                  autoreset, and 8 steps of KManipTorso (two float32 TRFs
                  a step), each step ten K1 launches at K = 64 and no plain
                  substep; env and vec steps/s; the TRF's trials, syncs and
                  launches per solve; launches, syncs and the device-busy
                  share of a vec step; the TRF with each of cuSOLVER's SVD
                  drivers; its split (goals, TRF,
                  control_step, obs and reward); the card's TRF against the
                  float64 host solver on 3 x 64 problems (largest rad
                  distance, at most 1e-3, and status flips); one vec step's
                  ten K1 launches against the plain substep at phase 2's
                  bands, K1's device time at K = 64; one PPO update of
                  example 12 (N = 64, T = 16), updates/s.
 15. vision:      the vision serving path, each line with the card's name
                  and power limit: every camera of the three Vision robots
                  rendered at its Cam spec size on the card and on the CPU
                  from one seeded state (one level on 99.5% of the pixels,
                  std > 0, the sky's pixel counts within 0.5%; ms per frame);
                  a 32-step KManipSoloArmVision episode and 16 steps each of
                  KManipDualArmVision and KManipTorsoVision through
                  KManipEnvSim (the backend gym.make's env steps; gymnasium
                  is not needed), ten K1 launches a step and no plain
                  substep, steps/s, render ms by camera, one step's ten K1
                  launches against the plain substep at phase 2's bands; the
                  vec env KManipSoloArmVision at N = 64, render_hw (32, 32),
                  8 steps, its split (goals, TRF, control_step, render, obs
                  and reward, the rest); the vision MPPI solve at example
                  10's shape (H = 10, K = 64, top camera 48 x 64, CostCNN
                  weights drawn in flax's layout and carried on the card):
                  H K1 launches a solve, solves/s, renders + CNN evaluations
                  per s, J against the plain substep's on one injected draw
                  (1e-4 of |J|); all four zoo artifacts loaded, and
                  bc_pixels_solo and bc_pick_solo closed loop on
                  control_step for 120 steps (control steps/s, tip-cube
                  distance, the card's controls against the CPU's at 1e-3
                  and 1e-4 of the ctrl range); one PPO update of example 12
                  --vision at N = 64, T = 16.
 16. learning:    the learning path at the JAX package's slow tests' sizes,
                  seeds and bars, each part with its K1 launches counted
                  (no plain substep, no other kernel) and the first K1
                  launch of each shape replayed against the plain version:
                  fit_distance_cost (256 frames 48 x 64, 1,200 steps) and its
                  vision MPPI (H = 20, K = 16, contact-free) from the
                  displaced start for 6 control steps, the closest true
                  tip-cube distance below d0 - 0.05
                  (tests/test_vision_mpc.py); example 14's run at seed 0 (2
                  episodes of 90 steps, K = 128; the estimator fit on the
                  torch generator's draws, 256 frames, 800 steps) and a
                  lift (tests/test_pick_from_pixels.py); the estimator's
                  error at seeds 0-7 no worse than the JAX package's at
                  the same seeds (its mean + 2 standard errors; the test's
                  0.02 m, which the JAX package misses at all eight, is
                  reported), and beside it, not bars,
                  the fit on the JAX test's own draws and initial weights
                  (tests/golden/pixels_estimator_draws.npz) and the fit at
                  run()'s defaults (512 frames, 1,500 steps) over its five
                  spawns; example 13's run_pipeline
                  (3 episodes of 80 steps, 1,500 BC steps, 4 evaluations as
                  one batch) into a temporary directory through the HDF5
                  logger (an in-memory stand-in of h5py.File where the host
                  has no h5py), the expert and the clone each lifting once,
                  three ACT files with cube_pose (tests/test_bc_pick.py),
                  then one dagger_collect episode and example 15's train of
                  200 steps on those files, finite; the expert's solves/s;
                  the zoo's drift check, each artifact over 8 episodes (seed
                  7) as one batch, its rate at least its meta's - 0.35
                  (tests/test_zoo.py:119-140). cuDNN's deterministic
                  algorithms throughout, so every fit repeats; the launches
                  per step or solve in the kernels line are read from each
                  part's counts. Every part runs before a missed bar fails
                  the phase.
 17. sharded:     the multi-device layer (gym_kmanip_torch/parallel/mesh.py),
                  each line with the card's name and power limit: a
                  one-rank NCCL group in this process, then two gloo ranks
                  sharing the card, spawned (each with its rendezvous
                  timeout, the parent's wait bounded; a failed or hung rank
                  fails the phase). On each: global_elite's tie across ranks
                  on the card (the smallest global index); example 8's MPPI
                  solve (H=20, K=256, 2 iterations, 10 substeps of 2 ms,
                  contact) sharded on one seeded noise draw against
                  make_mppi_solver (u0 1e-5, J 1e-4 relative, nominal 1e-5),
                  400 K1 launches a solve per rank at K / ranks and nothing
                  else, each rank's first K1 launch replayed against the
                  plain substep at phase 2's bands; phase 7's iLQR solve
                  sharded over 4 problems against make_ilqr_solver problem
                  by problem (controls 1e-5, costs 1e-5 relative), K1 10, K3
                  11 and K4 10 launches a problem. Reported, not bars: MPPI
                  solves/s single-device, one rank and two ranks, and iLQR
                  problems/s (two ranks on one card measure the
                  collectives' overhead, not scaling).
 18. slice:       the robots' tables, the dynamics identities and the zoo
                  tools, each line with the card's name and power limit:
                  gen_assets.build_asset_xml of each robot's _chains tables
                  byte-identical to the port's shipped asset; K5's bias
                  forces (rnea_terms_fast) against the Lagrangian autodiff
                  oracle bias_forces_ad on the card at atol = rtol = 1e-4,
                  K = 256 states of the solo arm and the torso drawn as
                  tests/test_dynamics.py:73-86 draws them (two K5 launches
                  and nothing else), K5 against its plain version on them,
                  M(q) symmetric to 1e-5 and positive definite;
                  gym_kmanip_torch/tools/train_zoo.py --model solo_arm at 2
                  episodes of 20 steps, 1 DAgger round of 1 episode, 50 BC
                  steps and 2 evals into a temporary --out-dir (the HDF5
                  stand-in where the host has no h5py): exactly the K1
                  launches of its episodes and nothing else, the first K1
                  launch of each shape replayed against the plain version,
                  the artifact reloaded through the port's loader with its
                  meta complete, the never-regress guard keeping a better
                  incumbent; expert solves/s and BC steps/s. Every part runs
                  before a failed check fails the phase.
Only the staged route moves the K5, K6 and K7 counters: every other phase,
and every plain-version call, leaves them as they were.
The kernels line, then the card's name and power limit (nvidia-smi), then
{"ok": true, "device": {...}}. Exits non-zero without a GPU, and after the
card's line, without the ok line, when a bar of phase 16 was missed or a
check of phase 18 failed.
"""

import copy
import ctypes
import dataclasses
import datetime
import functools
import glob
import importlib
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

from gym_kmanip_torch import constants, native, zoo  # noqa: E402
from gym_kmanip_torch.dynamics import contacts, engine  # noqa: E402
from gym_kmanip_torch.dynamics.state import SimState, init_state  # noqa: E402
from gym_kmanip_torch.env import config as env_config  # noqa: E402
from gym_kmanip_torch.env import env_sim  # noqa: E402
from gym_kmanip_torch.env import task as env_task  # noqa: E402
from gym_kmanip_torch.env.vec_env import KManipVecEnv  # noqa: E402
from gym_kmanip_torch.models import get_model, model_tensors  # noqa: E402
from gym_kmanip_torch.mpc.cost import (  # noqa: E402
    CostParams, cube_pick_cost, make_ee_tracking_cost_ilqr)
from gym_kmanip_torch.mpc.mppi import (  # noqa: E402
    MPPIConfig, init_mppi, make_fused_pick_solver, make_mppi_solver)
from gym_kmanip_torch.mpc import vision_cost  # noqa: E402
from gym_kmanip_torch.mpc.rollout import rollout  # noqa: E402
from gym_kmanip_torch.ops import _build, riccati_cuda, rollout_feedback_cuda  # noqa: E402
from gym_kmanip_torch.ops import chol_solve_cuda, contacts_cuda, rnea_cuda  # noqa: E402
from gym_kmanip_torch.ops import kinematics as kin  # noqa: E402
from gym_kmanip_torch.ops import linalg, sweep_floor_cuda  # noqa: E402
from gym_kmanip_torch.ops import rollout_pick_cuda, substep_cuda  # noqa: E402
from gym_kmanip_torch.parallel import mesh as pmesh  # noqa: E402
from gym_kmanip_torch.solvers import ik, ik_host, ilqr, trf  # noqa: E402
from gym_kmanip_torch.render import raycast  # noqa: E402
from gym_kmanip_torch.models import _table_models  # noqa: E402
from gym_kmanip_torch.tools import exp_sweep_floor, gen_assets, train_zoo  # noqa: E402
from gym_kmanip_torch.utils import optim  # noqa: E402
from gym_kmanip_torch.utils import rotations as rot  # noqa: E402
from gym_kmanip_torch.utils.flax_layers import same_side  # noqa: E402

ex12 = importlib.import_module("gym_kmanip_torch.examples.12_train_vec_rl")

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
# The team widths and warps per block that K1 was not built with at solo
# width (csrc/substep.cu), the warps per block that K2 (csrc/rollout_pick.cu,
# whose library holds both solo team widths), K5 (csrc/rnea.cu, solo width)
# and K7 (csrc/chol_solve.cu) were not built with, and the team width that
# K6 (csrc/contacts.cu) was not built with: built with -D beside the
# kernels, checked against the plain versions and timed beside them.
# KMANIP_SOLO_ONLY leaves out the torso kernels, which these flags do not
# change.
ALTERNATES = {
    "K1": (substep_cuda, {
        "16 lanes, 4 warps per block": ("-DKMANIP_SOLO_LANES=16", "-DKMANIP_SOLO_ONLY"),
        "32 lanes, 1 warp per block": ("-DKMANIP_TEAM_WARPS=1", "-DKMANIP_SOLO_ONLY")}),
    "K2": (rollout_pick_cuda, {
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


class k2_lanes:
    """Runs K2's launches on teams of `lanes` lanes for as long as it lasts,
    whatever K (the wrapper picks the width from K otherwise)."""

    def __init__(self, lanes):
        self.lanes = lanes

    def __enter__(self):
        self.saved = rollout_pick_cuda.team_lanes
        rollout_pick_cuda.team_lanes = lambda *args: self.lanes
        return self

    def __exit__(self, *exc):
        rollout_pick_cuda.team_lanes = self.saved


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


def kernel_device_ms(fn, tag, n=20, tries=6):
    """Device ms per launch of the kernel whose name holds `tag`, launched
    once by each of n calls of fn (torch.profiler): without the wrapper's
    host time, which bounds back-to-back calls of a kernel of a few tens of
    microseconds. The mean over the launches the trace holds: the profiler
    may drop some of a short trace's device records, or all of them for
    several traces in a row (PERF.md §7), and then the trace is taken again
    after a pause, up to `tries` traces in all; None (not measured) when
    none held a launch."""
    for _ in range(tries):
        rows = [v for key, v in profile_kernels(fn, n).items() if tag in key]
        t, launches = map(sum, zip(*rows)) if rows else (0.0, 0.0)
        if round(launches * n) != n:
            log("device", f"the profiler's trace of {n} calls held {launches * n:.0f} launches of "
                          f"{tag}")
        if launches > 0:
            return t / launches
        time.sleep(1.0)
    log("device", f"not measured: the profiler recorded no launch of {tag} in {tries} traces")
    return None


def us(ms):
    """A device time per launch from kernel_device_ms, in microseconds."""
    return "not measured" if ms is None else f"{1e3 * ms:.2f} us"


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

    rates, ms = solves_per_sec(solver, ms, sim_state, n_solves=10, repeats=3)
    plain = make_mppi_solver(model, cfg, cost, substep_fn=engine._substep_torch)
    plain_rates, _ = solves_per_sec(plain, ms, sim_state, n_solves=2, repeats=1)
    log("mppi", f"K1 route: {rate_line(rates)} x 10 solves")
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
    # both team widths of the one library: at K=256 each against the plain
    # version, at the fill point K=4096 the half-warp teams against the warp
    # teams, bit for bit; the width the wrapper picks at each K
    lib = rollout_pick_cuda._library()
    for lanes in (32, 16):
        n, sms = rollout_pick_cuda.resident(lib, model.nq, len(model.fingertips), lanes, True,
                                            True)
        log("K2", f"{lanes} lanes: {n} teams resident on the card's {sms} SMs")
    teams = {}
    U_fill = torch.as_tensor((model.home_qpos[: model.nu] + 0.1 * rng.randn(4096, H, model.nu))
                             .astype(np.float32), device=DEV)
    for U_, K_ in ((U, K), (U_fill, 4096)):
        picked = rollout_pick_cuda.team_lanes(lib, model, K_, True, True, DEV)
        out = {}
        for lanes in (32, 16):
            with k2_lanes(lanes):
                out[lanes] = rollout_pick_cuda.rollout_pick_costs(model, U_, s0)
                lanes_ms = cuda_ms(lambda: rollout_pick_cuda.rollout_pick_costs(model, U_, s0), 20)
            label = f"{lanes} lanes, 1 warp per block, K={K_}"
            if K_ == K:
                err = max_err(out[lanes], want)
                check("K2", f"{label}: kernel vs plain, K={K} H={H}", err, 1e-4 * scale)
            else:
                err = max_err(out[lanes], out[32])
                check("K2", f"{label}: kernel vs 32 lanes, K={K_} H={H}", err, 0.0)
            teams[label] = dict(max_abs_err=err, ms=lanes_ms, picked=lanes == picked)
            log("K2", f"{label}: {lanes_ms:.4f} ms at H={H}"
                      + (" (the wrapper's pick)" if lanes == picked else ""))
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
    for _ in range(3):
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
    busy, n_launch, by_kernel = device_profile(
        lambda: solve(s0, us), 3,
        expect=("substep_kernel", "rollout_feedback_kernel", "riccati_kernel"))
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
    log("K1", f"device time per launch (profiler): {us(k1['profiled_ms'])} at K={K} "
              f"with contact, {us(k1['profiled_ms_k1500'])} at K=1500 without (32 "
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
        log("K1", f"{label}: device time per launch {us(alt[0])} at K={K}, "
                  f"{us(alt[1])} at K=1500")

    # where a fused solve's time goes: device busy against the unprofiled
    # wall time, and K2's device time per launch inside the solve
    cfg = MPPIConfig(horizon=H, n_samples=K)
    solver = make_fused_pick_solver(model, cfg)
    sim_state = init_state(model, device=DEV)
    ms = init_mppi(model, cfg, seed=0, device=DEV)
    ms, _, _ = solver(ms, sim_state)
    busy, n_launch, by_kernel = device_profile(lambda: solver(ms, sim_state), 10,
                                               expect=("rollout_pick_kernel",))
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


def _cloned(args):
    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


class Recorder:
    """Stands in for a module function that its callers look up at call
    time: records the arguments of call number `at` (from 0) and passes
    every call on. With `key`, it also records the arguments and keywords
    of the first call of each distinct key(*args) in `by_key`. A kernel
    wrapper counts its launches on its module's name, which is this object
    while it stands in: `launches` is the wrapper's own."""

    def __init__(self, module, name, at=-1, key=None):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.at, self.calls, self.args = at, 0, None
        self.key, self.by_key = key, {}

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kwargs):
        if self.calls == self.at:
            self.args = _cloned(args)
        if self.key is not None and self.key(*args) not in self.by_key:
            self.by_key[self.key(*args)] = (_cloned(args), dict(zip(
                kwargs, _cloned(kwargs.values()))))
        self.calls += 1
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
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
    log("K5", f"device time per launch (profiler): {us(rows['K5']['device_ms'])} solo "
              f"K={K} (32 lanes, 4 warps per block), {us(rows['K5']['torso']['device_ms'])} "
              f"torso (32 lanes, 1 warp per block)")
    one = torch.zeros(1, device=DEV)
    floor_ms = kernel_device_ms(lambda: one.fill_(1.0), "FillFunctor")
    log("device", f"a one-element torch fill: {us(floor_ms)} per launch on the device "
                  f"(profiler), the least a launch reads there")
    log("K6", f"device time per launch (profiler): {us(rows['K6']['device_ms'])} solo "
              f"K={K}, {us(rows['K6']['torso']['device_ms'])} torso (32 lanes, 4 warps "
              f"per block)")
    log("K7", f"device time per launch (profiler): {us(rows['K7']['device_ms'])} at "
              f"n=10 (16-lane teams), {us(rows['K7']['n20']['device_ms'])} at n=20 "
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
                        + ", ".join(f"{us(t)} ({key})" for t, key in zip(times, keys)))


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

    rates, ms = solves_per_sec(solver, ms, sim_state, n_solves=3, repeats=3)
    log("staged", f"staged route: {rate_line(rates)} x 3 solves; K1 route "
                  f"{statistics.median(k1_rates):.2f}, fused route "
                  f"{statistics.median(fused_rates):.2f} (same run)")
    busy, n_launch, by_kernel = device_profile(
        lambda: solver(ms, sim_state), 2,
        expect=("rnea_kernel", "contacts_kernel", "chol_solve_kernel"))
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


def device_profile(fn, n, expect=(), tries=3):
    """torch.profiler over n calls of fn: device-busy ms per call, kernel
    launches per call, and {kernel name: (device ms, launches) per call}.
    A trace with no device time, or with no record of a kernel whose name
    holds a tag of `expect`, is taken again after a pause (the profiler
    drops records at times, PERF.md §7), up to `tries` traces in all."""
    for _ in range(tries):
        rows = profile_kernels(fn, n)
        busy = sum(t for t, _ in rows.values())
        kernels = {k: v for k, v in rows.items()
                   if "memcpy" not in k.lower() and "memset" not in k.lower()}
        missing = [tag for tag in expect if not any(tag in k for k in kernels)]
        if busy > 0.0 and not missing:
            return busy, sum(c for _, c in kernels.values()), kernels
        log("device", f"the profiler's trace of {n} calls held {busy:.3f} ms of device time, "
                      f"no record of {missing}; taken again")
        time.sleep(1.0)
    raise AssertionError(f"the profiler recorded no device time or no {missing} in {tries} traces")


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


# ---- the single env, the parallel backward, the oracle, the examples ----

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
ENV_CASES = (("solo_arm_env_trace.npz", "KManipSoloArm", ("eer",)),
             ("dual_arm_env_trace.npz", "KManipDualArm", ("eer", "eel")),
             ("torso_env_trace.npz", "KManipTorso", ("eer", "eel")),
             ("torso_inrange_env_trace.npz", "KManipTorso", ("eer", "eel")))


def golden_case(trace, env_id):
    """(data, cfg with the trace's recorded home, (reset, step, model), the
    start state on the card)."""
    data = np.load(os.path.join(GOLDEN, trace))
    cfg = env_config.CONFIGS[env_id]
    if "q_pos_home" in data.files:
        cfg = dataclasses.replace(cfg, q_pos_home=np.asarray(data["q_pos_home"], np.float64))
    task = env_task.make_task(cfg, device=DEV)
    state = task[0](np.asarray(data["cube_spawn"], np.float32)).state
    qh = torch.as_tensor(np.asarray(cfg.q_pos_home, np.float32), device=DEV)
    return data, cfg, task, state._replace(qpos=qh, ctrl=qh[: task[2].nu])


def golden_action(data, t, arms):
    a = torch.as_tensor(data["actions"][t], dtype=torch.float32, device=DEV)
    action = {}
    for i, side in enumerate(arms):
        action[f"{side}_pos"] = a[3 * i: 3 * i + 3]
        action[f"{side}_orn"] = torch.zeros(3, device=DEV)
        action[f"grip_{side[-1]}"] = torch.zeros(1, device=DEV)
    return action


def golden_pre_state(data, t, model, cfg):
    """The reference's own state before step t, on the card."""
    nq = model.nq
    qpos, qvel = data["raw_qpos_pre"][t], data["raw_qvel_pre"][t]
    prev = data["raw_ctrl"][t - 1] if t > 0 else cfg.q_pos_home[: model.nu]

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEV)

    return SimState(qpos=f(qpos[:nq]), qvel=f(qvel[:nq]), ctrl=f(prev),
                    cube_pos=f(qpos[nq: nq + 3]), cube_quat=f(qpos[nq + 3: nq + 7]),
                    cube_linvel=f(qvel[nq: nq + 3]), cube_angvel=f(qvel[nq + 3: nq + 6]),
                    time=torch.zeros((), device=DEV))


def replay_golden(trace, env_id, arms):
    """One golden trace through make_task on the card, full trace and
    teacher-forced, at tests/test_env_parity.py's bands; every env step
    launches K1 ten times. Returns a state of the trace (K1's env inputs)."""
    data, cfg, (_, step_fn, model), state = golden_case(trace, env_id)
    n = data["actions"].shape[0]
    arm = list(cfg.q_id_r_mask) + (list(cfg.q_id_l_mask) if cfg.q_id_l_mask is not None
                                   else [])
    reset_counts()
    q_dev, cube_dev, reward_dev, mid = [], [], [], None
    for t in range(n):
        out = step_fn(state, golden_action(data, t, arms))
        state = out.state
        mid = state if t == n // 2 else mid
        q_dev.append(np.abs(out.obs["q_pos"].cpu().numpy() - data["q_pos"][t]))
        cube_dev.append(np.abs(out.obs["cube_pos"].cpu().numpy() - data["cube_pos"][t]))
        reward_dev.append(abs(float(out.reward) - float(data["reward"][t])))
    if counts() != only(K1=10 * n):
        raise AssertionError(f"env {trace}: launches {counts()} for {n} steps, expected "
                             f"{10 * n} of K1 only")
    q_dev, cube_dev = np.stack(q_dev), np.stack(cube_dev)
    tag = f"{env_id} [{trace}]"
    check("env", f"{tag}: IK-controlled arm joints (q_pos obs)", q_dev[:, arm].max(), 0.002)
    check("env", f"{tag}: all joints (q_pos obs)", q_dev.max(), 0.06)
    check("env", f"{tag}: settled cube", cube_dev[-1].max(), 0.002)
    check("env", f"{tag}: cube", cube_dev.max(), 0.02)
    check("env", f"{tag}: reward", max(reward_dev), 0.02)

    parts = step_fn.parts
    dev_ctrl, dev_dyn = [], []
    reset_counts()
    for t in range(n):
        pre = golden_pre_state(data, t, model, cfg)
        action = golden_action(data, t, arms)
        qpos_np, goals_np, goals_dev = parts.goals(pre, action)
        ctrl, qpos_ik, _, _ = env_task._decode_action(model, cfg, pre, action,
                                                      parts.ik(qpos_np, goals_np), goals_dev)
        dev_ctrl.append(np.abs(ctrl.double().cpu().numpy() - data["raw_ctrl"][t])[arm].max())
        post, _ = engine.control_step(
            model, pre._replace(qpos=qpos_ik),
            torch.as_tensor(data["raw_ctrl"][t], dtype=torch.float32, device=DEV),
            qpos_force=pre.qpos)
        dev_dyn.append(np.abs(post.qpos.double().cpu().numpy()
                              - data["raw_qpos_post"][t][: model.nq])[arm].max())
    if counts() != only(K1=10 * n):
        raise AssertionError(f"env {trace} teacher-forced: launches {counts()}")
    check("env", f"{tag}: teacher-forced decode", max(dev_ctrl), 1e-4)
    check("env", f"{tag}: teacher-forced dynamics", max(dev_dyn), 4.5e-4)
    return model, mid


def random_actions(cfg, n, seed):
    """n seeded uniform actions of the env's action space (numpy)."""
    rng = np.random.default_rng(seed)
    sizes = {"eel_pos": 3, "eel_orn": 3, "eer_pos": 3, "eer_orn": 3, "grip_l": 1, "grip_r": 1}
    sizes.update(q_pos_r=len(cfg.q_id_r_mask),
                 q_pos_l=len(cfg.q_id_l_mask) if cfg.q_id_l_mask is not None else 0)
    return [{a: rng.uniform(-1, 1, sizes[a]).astype(np.float32) for a in cfg.act_list}
            for _ in range(n)]


def env_episode(env_id):
    """One 64-step episode of `env_id` through KManipEnvSim, seeded random
    actions; then the same actions through the task's stages, each ended by
    a synchronize, for the split of a step; and a profile of a few steps."""
    cfg = env_config.CONFIGS[env_id]
    n = constants.MAX_EPISODE_STEPS
    shell = types.SimpleNamespace(cfg=cfg, obs_list=list(cfg.obs_list), cameras=[],
                                  np_random=np.random.default_rng(0))
    sim = env_sim.KManipEnvSim(shell, device=DEV)
    actions = random_actions(cfg, n, seed=1)
    sim.k_reset()
    sim.k_step(actions[0])  # first step: the cached tensors
    sim.k_reset()
    reset_counts()
    t0 = time.perf_counter()
    for a in actions:
        _, reward, _, obs, sim_time = sim.k_step(a)
    seconds = time.perf_counter() - t0
    if counts() != only(K1=10 * n):
        raise AssertionError(f"{env_id} episode: launches {counts()}, expected {10 * n} of K1")
    if not (np.isfinite(reward) and all(np.all(np.isfinite(v)) for v in obs.values())
            and abs(sim_time - n * constants.CONTROL_TIMESTEP) < 1e-4):
        raise AssertionError(f"{env_id} episode ended non-finite or at time {sim_time}")

    # the split: goals and the device-to-host copy, host IK, decode,
    # control_step, obs and reward with the host copy
    model, parts = sim.model, sim.step_fn.parts
    state = sim.reset_fn(np.array([0.2, 0.6, 0.62], np.float32)).state
    split = dict(goals=0.0, ik=0.0, decode=0.0, control_step=0.0, obs_reward=0.0)
    for a in actions:
        action = sim._device_action(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols = goals_dev = None
        if parts.goals is not None:
            qpos_np, goals_np, goals_dev = parts.goals(state, action)
            t1 = time.perf_counter()
            sols = parts.ik(qpos_np, goals_np)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            split["goals"] += t1 - t0
            split["ik"] += t2 - t1
            t0 = t2
        ctrl, qpos_ik, _, _ = env_task._decode_action(model, cfg, state, action, sols,
                                                      goals_dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, aux = engine.control_step(model, state._replace(qpos=qpos_ik), ctrl,
                                         qpos_force=state.qpos)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        obs = env_task._observe(model, cfg, state)
        reward = env_task._reward(model, cfg, state, aux)
        torch.cat([v.reshape(-1) for v in obs.values()] + [reward.reshape(1)]).cpu()
        t3 = time.perf_counter()
        split["decode"] += t1 - t0
        split["control_step"] += t2 - t1
        split["obs_reward"] += t3 - t2
    busy, n_launch, _ = device_profile(lambda: sim.k_step(actions[0]), 8)
    ms = {key: 1e3 * v / n for key, v in split.items()}
    log("env", f"{env_id}: {n}-step episode through KManipEnvSim in {seconds:.3f} s, "
               f"{n / seconds:.2f} steps/s ({1e3 * seconds / n:.2f} ms per step); split of a "
               f"step (synchronized, ms): goals + device-to-host copy {ms['goals']:.3f}, host "
               f"IK {ms['ik']:.3f}, decode {ms['decode']:.3f} (decode and goals "
               f"{ms['goals'] + ms['decode']:.3f}), control_step {ms['control_step']:.3f}, "
               f"obs + reward + host copy {ms['obs_reward']:.3f}; profile of 8 steps: device "
               f"busy {busy:.3f} ms per step ({busy * n / (1e3 * seconds):.1%} of the episode's "
               f"step), {n_launch:.0f} kernel launches per step")


def phase_env():
    """The four golden env traces on the card (K1 at K=1, ten launches per
    env step, no plain substep, the native host IK), K1 against its plain
    version on the env's inputs and its device time at K=1, native against
    numpy IK, and a 64-step episode of the solo arm and the torso."""
    plain_substeps = Recorder(engine, "_substep_torch")
    native_calls = Recorder(native, "solve_ik_native")
    numpy_calls = Recorder(ik_host, "_solve_np")
    if not native.available():
        raise AssertionError(f"the native host IK did not build: {native.load_error()}")
    with plain_substeps, native_calls, numpy_calls:
        for trace, env_id, arms in ENV_CASES:
            model, mid = replay_golden(trace, env_id, arms)
            if env_id == "KManipSoloArm":
                solo, solo_mid = model, mid
        for env_id in ("KManipSoloArm", "KManipTorso"):
            env_episode(env_id)
    if plain_substeps.calls or numpy_calls.calls or not native_calls.calls:
        raise AssertionError(f"env phase: {plain_substeps.calls} plain substeps, "
                             f"{numpy_calls.calls} numpy IK solves, {native_calls.calls} native")
    log("env", f"{native_calls.calls} host IK solves, all native; no plain substep")

    # K1 at the env's shape: one rollout, 2 ms, explicit, with contact
    s = solo_mid
    inputs = [a[None].contiguous() for a in (s.qpos, s.qvel, s.ctrl, torch.cat(
        [s.cube_pos, s.cube_quat, s.cube_linvel, s.cube_angvel]))]
    err = compare_substep("env K=1 dt=0.002 explicit", solo, 0.002, True, False, inputs)
    args = (solo, 0.002, True, False, *inputs)
    ms = cuda_ms(lambda: substep_cuda.substep_batched(*args), 200)
    plain_ms = cuda_ms(lambda: substep_cuda.substep_batched_reference(*args), 20)
    profiled = kernel_device_ms(lambda: substep_cuda.substep_batched(*args), "substep_kernel")
    T, nq, nu = len(solo.fingertips), solo.nq, solo.nu
    b = bound(substep_flops(solo, True), 4 * (2 * nq + nu + 13) + 4 * (2 * nq + 13 + 7 * nq) + T)
    log("K1", f"env K=1: device {us(profiled)} per launch (profiler), CUDA events "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.8f} ms ({b[1]}); 10 launches "
              f"per env step")

    # host IK per solve: native against the numpy twin on a solo problem
    cfg = env_config.CONFIGS["KManipSoloArm"]
    _, step_fn, _ = env_task.make_task(cfg, device=DEV)
    action = {"eer_pos": torch.tensor([1.0, -1.0, 0.5], device=DEV),
              "eer_orn": torch.tensor([0.3, 0.0, -0.3], device=DEV),
              "grip_r": torch.zeros(1, device=DEV)}
    qpos_np, goals, _ = step_fn.parts.goals(solo_mid, action)
    q_home = np.asarray(cfg.q_pos_home, np.float32).astype(np.float64)
    ik_args = (qpos_np, *goals["r"], q_home, qpos_np)
    ik_kw = dict(model=solo, q_mask=tuple(int(i) for i in cfg.q_id_r_mask), site_name="eer_site")
    ik_ms = {}
    for name, fn, reps in (("native", native.solve_ik_native, 200),
                           ("numpy", ik_host._solve_np, 5)):
        fn(*ik_args, **ik_kw)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*ik_args, **ik_kw)
        ik_ms[name] = 1e3 * (time.perf_counter() - t0) / reps
        if name == "native":
            q_native = out[0]
    gap = float(np.abs(q_native - out[0]).max())
    check("env", "host IK: native vs numpy solution", gap, 1e-9)
    log("env", f"host IK per solo solve: native {ik_ms['native']:.4f} ms, numpy "
               f"{ik_ms['numpy']:.2f} ms ({ik_ms['numpy'] / ik_ms['native']:.0f}x)")
    return dict(K=1, launches_per_env_step=10, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                profiled_ms=profiled, bound_ms=b[0], bound_by=b[1])


def phase_lqr():
    """The production solo iLQR (H=50) and the torso at H=100 with the
    associative-scan backward (`parallel_backward`) against the serial K4
    sweep on the same problem, and against the plain serial sweep
    (`pallas_backward=False`), the associative scan's exact counterpart
    while lam_extra is 0 (tests/test_mpc.py:269)."""
    variants = (("serial K4", dict()), ("serial linalg", dict(pallas_backward=False)),
                ("parallel", dict(parallel_backward=True)))
    # K4's plain version in the solve, with and without its Gershgorin lift:
    # what the lift does to the solve's end, on the card (not timed)
    twins = (("K4 plain", riccati_cuda.riccati_sweep_reference),
             ("K4 plain, no Gershgorin lift", functools.partial(
                 riccati_cuda.riccati_sweep_reference, gershgorin_lift=False)))
    out = {}
    for name, horizon, n_solves in (("solo_arm", H, 2), ("torso", TORSO_H, 1)):
        model = get_model(name)
        s0, _, cost_xu, quad_xu, cfg, us = ilqr_setup(model, horizon)
        solvers = {key: ilqr.make_ilqr_solver(model, cfg._replace(**kw), cost_xu,
                                              quad_xu=quad_xu) for key, kw in variants}
        results, rates = {}, {key: [] for key in solvers}
        for key, sweep in twins:
            ops = ilqr.KERNEL_OPS._replace(riccati_sweep=sweep)
            results[key] = ilqr.make_ilqr_solver(model, cfg, cost_xu, quad_xu=quad_xu,
                                                 ops=ops)(s0, us)
            trace = results[key].cost_trace.cpu().numpy()
            log("lqr", f"{name} H={horizon} {key}: trace {np.array2string(trace, precision=5)}")
        for key, solve in solvers.items():
            solve(s0, us)  # first call builds the cached tensors
            reset_counts()
            results[key] = solve(s0, us)
            torch.cuda.synchronize()
            launches = counts()
            k4 = 10 if key == "serial K4" else 0
            want = (only(K1=10, K3=11, K4=k4) if name == "solo_arm"
                    else only(K1=10 + 11 * horizon, K4=k4))
            if launches != want:
                raise AssertionError(f"lqr {name} {key}: launches {launches}, expected {want}")
            trace = results[key].cost_trace.cpu().numpy()
            if not (np.all(np.isfinite(trace)) and np.all(np.diff(trace) <= 1e-5)):
                raise AssertionError(f"lqr {name} {key}: the cost trace is not monotone")
            log("lqr", f"{name} H={horizon} {key}: trace {np.array2string(trace, precision=5)}")
        for _ in range(2):
            for key, solve in solvers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n_solves):
                    solve(s0, us)
                torch.cuda.synchronize()
                rates[key].append(n_solves / (time.perf_counter() - t0))
        costs = {key: float(r.cost) for key, r in results.items()}
        par = results["parallel"]
        log("lqr", f"{name} H={horizon}: " + "; ".join(
            f"{key} {rate_line(rates[key])}, cost {costs[key]:.6f}" for key in solvers)
            + "; largest |us| gap, parallel vs serial K4 "
            f"{max_err(par.us, results['serial K4'].us):.3e}, vs serial linalg "
            f"{max_err(par.us, results['serial linalg'].us):.3e}; "
            + "; ".join(f"{key} cost {costs[key]:.6f}" for key, _ in twins))
        out[name] = dict(rates=rates, costs=costs)
    # the bound of tests/test_mpc.py:266 on the final cost: against K4 on
    # the solo arm, and against the plain serial sweep on both robots. On
    # the torso K4's Gershgorin-adaptive lift takes another path than the
    # unlifted sweeps (the serial one and the associative scan end
    # together); the K4 plain twins, lifted and not, show what the lift does
    for name, ref in (("solo_arm", "serial K4"), ("solo_arm", "serial linalg"),
                      ("torso", "serial linalg")):
        c = out[name]["costs"]
        check("lqr", f"{name}: parallel final cost {c['parallel']:.6f} over 1.1 x the {ref} "
                     f"{c[ref]:.6f} + 1e-3", max(c["parallel"] - 1.1 * c[ref] - 1e-3, 0.0), 0.0)
    c = out["torso"]["costs"]
    log("lqr", "torso, final costs over K4's: " + ", ".join(
        f"{key} {c[key] / c['serial K4']:.4f}" for key in c if key != "serial K4"))
    return out


def phase_oracle():
    """FD against the jacfwd oracle at solo H=6, contact off, in the
    relative band of tests/test_mpc.py:170-171, off the joint and control
    stops (the gripper sliders moved into their range); the ms of one
    jacfwd linearization."""
    model = get_model("solo_arm")
    q = np.asarray(model.home_qpos, np.float32).copy()
    q[8:10] = -0.012  # the sliders' home is their stop, a kink of the dynamics
    s0 = init_state(model, device=DEV)
    s0 = s0._replace(qpos=torch.as_tensor(q, device=DEV),
                     ctrl=torch.as_tensor(q[: model.nu], device=DEV))

    def cost_xu(x, u):
        s = ilqr.unflatten_state(model, x, s0)
        return 10.0 * torch.sum(s.qpos ** 2, -1) + 1e-2 * torch.sum(u ** 2, -1)

    h = 6
    cfg_fd = ilqr.ILQRConfig(horizon=h, n_iters=1, contact=False)
    cfg_jac = cfg_fd._replace(fd_linearize=False, pallas_backward=False, fast_rollouts=False)
    derivs_fd = ilqr._build_pieces(model, cfg_fd, cost_xu)[1]
    rollout0, derivs_jac = ilqr._build_pieces(model, cfg_jac, cost_xu)[:2]
    rng = np.random.RandomState(0)
    us = ilqr._clip_u(model, torch.as_tensor(
        (q[: model.nu] + 0.02 * rng.randn(h, model.nu)).astype(np.float32), device=DEV))
    xs, _ = rollout0(ilqr.flatten_state(s0), us, s0)
    A_fd, B_fd = derivs_fd(xs, us, s0)[:2]
    A_j, B_j = derivs_jac(xs, us, s0)[:2]
    for name, fd, jac in (("A", A_fd, A_j), ("B", B_fd, B_j)):
        scale = float(jac.abs().max())
        check("oracle", f"FD vs jacfwd {name} (slopes up to {scale:.3g})", max_err(fd, jac),
              5e-3 * scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        derivs_jac(xs, us, s0)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 3
    log("oracle", f"one jacfwd linearization (A, B and the cost blocks) at H={h}, n=33, m=10: "
                  f"{ms:.1f} ms")
    return ms


def run_examples():
    """Examples 9 and 11 at their sizes and example 8 at 30 control steps,
    with their kernel launches counted."""
    out = {}
    reset_counts()
    ex9 = importlib.import_module("gym_kmanip_torch.examples.9_mpc_ilqr").main(device=DEV)
    launches = counts()
    if not (ex9["finite"] and np.all(np.diff(ex9["cost_trace"]) <= 1e-5)
            and launches["K1"] > 0 and launches["K4"] > 0):
        raise AssertionError(f"example 9: {ex9}, launches {launches}")
    log("examples", f"9_mpc_ilqr: solve {ex9['solve_s']:.2f} s, EE error "
                    f"{ex9['ee_err_mm_scored']:.2f} mm at the last scored state, "
                    f"{ex9['ee_err_mm_final']:.2f} mm after the last control; launches {launches}")
    out["ex9"] = ex9
    reset_counts()
    ex11 = importlib.import_module("gym_kmanip_torch.examples.11_bimanual_torso").main(
        device=DEV)
    launches = counts()
    if not (np.isfinite(ex11["dual"]["J"]) and np.all(np.isfinite(ex11["torso"]["cost_trace"]))
            and launches["K1"] > 0 and launches["K4"] > 0):
        raise AssertionError(f"example 11: {ex11}, launches {launches}")
    log("examples", f"11_bimanual_torso: dual-arm MPPI {ex11['dual']['ms_per_solve']:.1f} ms per "
                    f"solve; torso iLQR {ex11['torso']['solve_s']:.2f} s; launches "
                    f"{launches}")
    out["ex11"] = ex11
    reset_counts()
    ex8 = importlib.import_module("gym_kmanip_torch.examples.8_mpc_mppi").main(
        n_control_steps=30, device=DEV)
    launches = counts()
    if not (ex8["finite"] and np.isfinite(ex8["tip_cube_m"]) and launches["K1"] > 0):
        raise AssertionError(f"example 8: {ex8}, launches {launches}")
    log("examples", f"8_mpc_mppi: 30 steps at {ex8['hz']:.2f} Hz closed loop, final tip-cube "
                    f"{ex8['tip_cube_m']:.4f} m, touch steps {ex8['touch_steps']}; launches "
                    f"{launches}")
    out["ex8"] = ex8
    return out


def phase_examples():
    """The examples (run_examples), with the arguments of the first K1
    launch of each (robot, dt, contact, implicit, K) and the first K4
    launch of each (H, n, m) recorded: the iLQR solves' FD probe batches
    (contact on, K = H (n + m)), line searches and rollouts, the MPPI
    solves and the plants, and the full-state sweeps, which take K4's
    runtime-width code. Each is replayed through its kernel and its plain
    version: K1 at compare_substep's bands, K4 at 1e-4 of the largest gain.
    Returns the errors, for the K1 and K4 rows."""
    k1_rec = Recorder(substep_cuda, "substep_batched",
                      key=lambda m, dt, contact, implicit, q, *_: (
                          m.nq, dt, contact, implicit, q.shape[0]))
    k4_rec = Recorder(riccati_cuda, "riccati_sweep",
                      key=lambda A, B, *_: (A.shape[0], A.shape[1], B.shape[2]))
    kernel_ops = ilqr.KERNEL_OPS
    with k1_rec, k4_rec:
        # a solver takes KERNEL_OPS as it stands when it is built
        ilqr.KERNEL_OPS = kernel_ops._replace(riccati_sweep=riccati_cuda.riccati_sweep)
        try:
            run_examples()
        finally:
            ilqr.KERNEL_OPS = kernel_ops
    rows = {"K1": [], "K4": []}
    for (nq, dt, contact, implicit, k_), (args, _) in sorted(k1_rec.by_key.items()):
        tag = f"examples nq={nq} K={k_} dt={dt} contact={contact} implicit={implicit}"
        err = compare_substep(tag, *args[:4], [a.contiguous() for a in args[4:]])
        rows["K1"].append(dict(nq=nq, K=k_, dt=dt, contact=contact, implicit=implicit,
                               max_abs_err=err))
    for (h, n, m), (args, kwargs) in sorted(k4_rec.by_key.items()):
        got = riccati_cuda.riccati_sweep(*args, **kwargs)
        want = riccati_cuda.riccati_sweep_reference(*args, **kwargs)
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
        lam = float(kwargs.get("lam_extra", 0.0))
        check("K4", f"examples ({h}, {n}, {m}), lam_extra {lam:.3g}: kernel vs plain (gains "
                    f"up to {scale:.3g})", err, 1e-4 * scale)
        rows["K4"].append(dict(H=h, n=n, m=m, max_abs_err=err))
    if not rows["K1"] or not rows["K4"]:
        raise AssertionError(f"the examples recorded no launch: {rows}")
    return rows


# ---- the vec env, its float32 device TRF and example 12's PPO ----

N_VEC = 64  # example 12's N_ENVS


def vec_actions(cfg, n, rng):
    """Seeded uniform actions of the env's action space, (n, dim) tensors
    on the card."""
    sizes = {"eel_pos": 3, "eel_orn": 3, "eer_pos": 3, "eer_orn": 3, "grip_l": 1, "grip_r": 1}
    return {a: torch.as_tensor(rng.uniform(-1, 1, (n, sizes[a])).astype(np.float32), device=DEV)
            for a in cfg.act_list}


def trf_stats(fn):
    """(fn's result, {solves, trials, syncs}) of the TRF solves fn runs."""
    before = dict(trf.counts)
    out = fn()
    return out, {key: v - before[key] for key, v in trf.counts.items()}


def host_syncs(fn):
    """(fn's result, the synchronizing CUDA calls torch reports in it)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def trf_against_host(env, states, action):
    """The card's float32 TRF (ik_trf, as the decode runs it) against the
    float64 native host solver on the same N problems of every arm: the
    largest rad distance of the solutions, and the status flips among the
    problems the host solves (in range)."""
    cfg, model = env.cfg, env.model
    q_home = torch.as_tensor(np.asarray(cfg.q_pos_home, np.float32), device=DEV)
    q_home64 = np.asarray(cfg.q_pos_home, np.float32).astype(np.float64)
    qpos = states.qpos.double().cpu().numpy()
    dist, flips, solved = 0.0, 0, 0
    for side in ("r", "l"):
        if f"ee{side}_pos" not in cfg.act_list:
            continue
        mask = tuple(int(i) for i in getattr(cfg, f"q_id_{side}_mask"))
        gp, go = env_task._ee_goal(model, cfg, states, action, side)
        captured = []
        real = trf.least_squares_trf
        trf.least_squares_trf = lambda *a, **kw: captured.append(real(*a, **kw)) or captured[-1]
        try:
            q_sol, _ = ik.ik_trf(model, states.qpos, gp, go, q_home, states.qpos, q_mask=mask,
                                 site_name=f"ee{side}_site")
        finally:
            trf.least_squares_trf = real
        status = captured[0].status.cpu().numpy()
        q_sol = q_sol.cpu().numpy()
        gp, go = gp.double().cpu().numpy(), go.double().cpu().numpy()
        for b in range(qpos.shape[0]):
            want, _, st = native.solve_ik_native(qpos[b], gp[b], go[b], q_home64, qpos[b],
                                                 model=model, q_mask=mask,
                                                 site_name=f"ee{side}_site", return_status=True)
            dist = max(dist, float(np.abs(want - q_sol[b]).max()))
            if st >= 0:
                solved += 1
                flips += int(st != status[b])
    return dist, flips, solved


def svd_drivers(env, states, action):
    """The TRF on one set of N problems with each of cuSOLVER's SVD drivers
    that torch.linalg.svd offers: ms per solve (synchronized, after one
    untimed solve), trials, and the largest distance from the float64 host
    solver with the status flips."""
    saved = trf.SVD_DRIVER
    try:
        for driver in (None, "gesvdj", "gesvda", "gesvd"):
            trf.SVD_DRIVER = driver
            trf_against_host(env, states, action)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (dist, flips, solved), stats = trf_stats(
                lambda: trf_against_host(env, states, action))
            ms = 1e3 * (time.perf_counter() - t0)
            log("vec", f"SVD driver {driver or 'torch default'}: {ms:.1f} ms per solve with the "
                       f"host check, {stats['trials']} trials, largest distance {dist:.3e} rad, "
                       f"{flips} status flips of {solved}")
    finally:
        trf.SVD_DRIVER = saved


def vec_split(env, actions):
    """ms per vec step by stage, each ended by a synchronize: the goals (the
    EE FK), the TRF of every arm, control_step (with the rest of the
    decode), and obs with reward (no step of these truncates)."""
    model, cfg = env.model, env.cfg
    sides = [s for s in ("r", "l") if f"ee{s}_pos" in cfg.act_list]
    q_home = torch.as_tensor(np.asarray(cfg.q_pos_home, np.float32), device=DEV)
    split = dict(goals=0.0, trf=0.0, control_step=0.0, obs_reward=0.0)
    states = env._states
    for a in actions:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        goals = {s: env_task._ee_goal(model, cfg, states, a, s) for s in sides}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sols = {s: ik.ik_trf(model, states.qpos, *goals[s], q_home, states.qpos,
                             q_mask=tuple(int(i) for i in getattr(cfg, f"q_id_{s}_mask")),
                             site_name=f"ee{s}_site") for s in sides}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ctrl, qpos_ik, _, _ = env_task._decode_action(model, cfg, states, a, sols, goals)
        new, aux = engine.control_step(model, states._replace(qpos=qpos_ik), ctrl,
                                       qpos_force=states.qpos)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        env_task._reward(model, cfg, new, aux)
        env_task._observe(model, cfg, new)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        states = new
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            split[key] += 1e3 * dt / len(actions)
    return split


def vec_run(env_id, n_steps, seed):
    """n_steps vec steps of `env_id` at N = 64 with seeded actions: the
    launches checked (ten K1 launches a step, no plain substep), the rate,
    the TRF's trials and syncs; returns the stats."""
    env = KManipVecEnv(env_id, N_VEC, seed=seed, device=DEV)
    rng = np.random.default_rng(seed)
    actions = [vec_actions(env.cfg, N_VEC, rng) for _ in range(n_steps)]
    env.reset()
    env.step(actions[0])  # first step: cuSOLVER's set-up and the cached tensors
    env.reset()
    reset_counts()
    plain_substeps = Recorder(engine, "_substep_torch")
    truncated_at = []
    with plain_substeps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (_, stats) = trf_stats(lambda: [truncated_at.append(i + 1) if env.step(a)[3].any() else None
                                        for i, a in enumerate(actions)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if counts() != only(K1=10 * n_steps) or plain_substeps.calls:
        raise AssertionError(f"{env_id} vec run: launches {counts()}, plain substeps "
                             f"{plain_substeps.calls}; expected {10 * n_steps} of K1 and none")
    obs = env_task._observe(env.model, env.cfg, env._states)
    if not all(bool(torch.isfinite(v).all()) for v in obs.values()):
        raise AssertionError(f"{env_id} vec run ended non-finite")
    expect = [t for t in range(1, n_steps + 1) if t % constants.MAX_EPISODE_STEPS == 0]
    if truncated_at != expect:
        raise AssertionError(f"{env_id} vec run truncated at {truncated_at}, expected {expect}")
    per_solve = {k_: v / max(stats["solves"], 1) for k_, v in stats.items() if k_ != "solves"}
    log("vec", f"{env_id} N={N_VEC}: {n_steps} vec steps in {seconds:.3f} s, "
               f"{n_steps / seconds:.3f} vec steps/s, {N_VEC * n_steps / seconds:.1f} env steps/s; "
               f"10 K1 launches and no plain substep per vec step; {stats['solves']} TRF solves, "
               f"{per_solve['trials']:.2f} trials and {per_solve['syncs']:.2f} termination reads "
               f"per solve; autoreset at steps {truncated_at}")
    return env, actions, dict(vec_steps_per_s=n_steps / seconds,
                              env_steps_per_s=N_VEC * n_steps / seconds, **per_solve)


def phase_vec():
    """The vec env at example 12's size (N = 64): one 64-step KManipSoloArm
    episode and 4 steps past its autoreset, and 8 steps of KManipTorso
    (two TRFs a step), each with ten K1 launches at K = 64 and no plain
    substep per step; the split of a solo step; the TRF's trials, syncs
    and launches per solve, and the card's float32 TRF against the float64
    host solver; one vec step's ten K1 launches against the plain substep
    at phase 2's bands, and K1's device time at K = 64; the device-busy
    share; one PPO update of example 12 (N = 64, T = 16)."""
    n = constants.MAX_EPISODE_STEPS + 4
    env, actions, solo = vec_run("KManipSoloArm", n, seed=1)
    # one vec step's ten K1 launches against the plain substep, and K1's
    # device time at K = 64, before the TRF's large profiles below
    calls = iter(range(1 << 30))
    rec = Recorder(substep_cuda, "substep_batched", key=lambda *_: next(calls))
    with rec:
        env.step(actions[0])
    torch.cuda.synchronize()
    launches = sorted(rec.by_key.items())
    if len(launches) != 10:
        raise AssertionError(f"vec: a step made {len(launches)} K1 launches")
    err = max(compare_substep(f"vec K={N_VEC} launch {i}", *args[:4],
                              [x.contiguous() for x in args[4:]])
              for i, (_, (args, _)) in enumerate(launches))
    args = launches[0][1][0]
    m = args[0]
    profiled = kernel_device_ms(lambda: substep_cuda.substep_batched(*args), "substep_kernel")
    events = cuda_ms(lambda: substep_cuda.substep_batched(*args), 200)
    T, nq, nu = len(m.fingertips), m.nq, m.nu
    b = bound(N_VEC * substep_flops(m, True),
              N_VEC * (4 * (2 * nq + nu + 13) + 4 * (2 * nq + 13 + 7 * nq) + T))
    log("K1", f"vec K={N_VEC}: device {us(profiled)} per launch (profiler), CUDA events "
              f"{events:.4f} ms (the wrapper's host time), bound {b[0]:.8f} ms ({b[1]}); "
              f"10 launches per vec "
              f"step, the ten of one step within phase 2's bands (largest {err:.3e})")

    _, _, torso = vec_run("KManipTorso", 8, seed=2)

    # the card's TRF against the float64 host solver, on the problems of a
    # reset and of a mid-episode state
    env.reset()
    worst = [0.0, 0, 0]
    for a in actions[:3]:
        d, f, s = trf_against_host(env, env._states, a)
        worst = [max(worst[0], d), worst[1] + f, worst[2] + s]
        env.step(a)
    log("vec", f"TRF float32 on the card against the float64 host solver, 3 x {N_VEC} solo "
               f"problems: largest distance {worst[0]:.3e} rad (tests/test_ik.py:200 holds 1e-3), "
               f"{worst[1]} status flips of {worst[2]} problems")
    if not worst[0] <= 1e-3:
        raise AssertionError(f"vec: the card's TRF is {worst[0]:.3e} rad from the host's")

    svd_drivers(env, env._states, actions[3])

    # syncs and launches: per vec step and per TRF solve
    a = actions[3]
    _, step_syncs = host_syncs(lambda: env.step(a))
    goals = env_task._ee_goal(env.model, env.cfg, env._states, a, "r")
    q_home = torch.as_tensor(np.asarray(env.cfg.q_pos_home, np.float32), device=DEV)
    mask = tuple(int(i) for i in env.cfg.q_id_r_mask)

    def solve():
        return ik.ik_trf(env.model, env._states.qpos, *goals, q_home, env._states.qpos,
                         q_mask=mask, site_name="eer_site")

    (_, stats), solve_syncs = host_syncs(lambda: trf_stats(solve))
    _, solve_launches, _ = device_profile(solve, 1)
    step_ms = 1e3 / solo["vec_steps_per_s"]
    busy, step_launches, _ = device_profile(lambda: env.step(a), 1)
    log("vec", f"per TRF solve: {stats['trials']} trials, {solve_syncs} synchronizing calls "
               f"({stats['syncs']} termination reads), {solve_launches:.0f} device launches "
               f"({solve_launches / max(stats['trials'], 1):.0f} per trial); per vec step: "
               f"{step_syncs} synchronizing calls, {step_launches:.0f} launches, device busy "
               f"{busy:.2f} ms of {step_ms:.2f} ({busy / step_ms:.1%})")
    split = vec_split(env, actions[4:7])
    log("vec", "split of a solo vec step (3 steps, synchronized, ms): " + ", ".join(
        f"{key} {v:.2f}" for key, v in split.items()))

    # example 12: one PPO update at N = 64, T = 16
    ex12 = importlib.import_module("gym_kmanip_torch.examples.12_train_vec_rl")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy, rewards = ex12.train(env_id="KManipSoloArm", n_updates=1, n_envs=N_VEC,
                                 t_rollout=ex12.T_ROLLOUT, seed=0, log=lambda *_: None,
                                 device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_steps = ex12.T_ROLLOUT
    if counts() != only(K1=10 * n_steps):
        raise AssertionError(f"example 12: launches {counts()}, expected {10 * n_steps} of K1")
    if not (all(np.isfinite(rewards)) and all(bool(torch.isfinite(p).all())
                                              for p in policy.parameters())):
        raise AssertionError(f"example 12: rewards {rewards}")
    log("vec", f"example 12: 1 PPO update (N={N_VEC}, T={ex12.T_ROLLOUT}, "
               f"{ex12.PPO_EPOCHS} epochs) in {seconds:.2f} s, {1 / seconds:.4f} updates/s; mean "
               f"reward {rewards[0]:.4f}")
    return dict(K=N_VEC, launches_per_vec_step=10, max_abs_err=err, profiled_ms=profiled,
                ms=events, bound_ms=b[0], bound_by=b[1], env_steps_per_s=solo["env_steps_per_s"],
                torso_env_steps_per_s=torso["env_steps_per_s"],
                trf_trials_per_solve=solo["trials"], trf_max_rad=worst[0],
                trf_status_flips=worst[1], ppo_updates_per_s=1 / seconds)


# ---- the vision serving path: the raycaster, the Vision ids, the vision
# cost in MPPI, the zoo's policies (phase 15) ----

VISION_EPISODES = {"KManipSoloArmVision": 32, "KManipDualArmVision": 16,
                   "KManipTorsoVision": 16}
VISION_VEC_STEPS = 8
# example 10's solve (gym_kmanip_tpu/examples/10_vision_mpc.py:23-47)
VISION_MPPI = MPPIConfig(horizon=10, n_samples=64, n_iters=1, noise_beta=0.9)
VISION_MPPI_HW = (48, 64)
VISION_MPPI_SOLVES = 10
ZOO_STEPS = 120


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0]


def vision_renders(card):
    """Every camera of the three Vision robots at its Cam spec size, on the
    card and on the CPU, from one seeded state each: at most one level apart
    on at least 99.5% of the pixels, a real render (std > 0), the sky's
    pixel counts within 0.5%; ms per frame on the card."""
    sky = np.clip(raycast._SKY * 255.0, 0, 255).astype(np.uint8)
    rng = np.random.default_rng(15)
    frame_ms, worst = {}, 1.0
    for env_id in VISION_EPISODES:
        model = get_model(env_config.CONFIGS[env_id].mjcf_filename)
        cube = rng.uniform(constants.CUBE_SPAWN_RANGE[:, 0], constants.CUBE_SPAWN_RANGE[:, 1])
        s = init_state(model, cube_pos=cube, device="cpu")
        s = s._replace(qpos=s.qpos + torch.as_tensor(rng.uniform(-0.2, 0.2, model.nq),
                                                     dtype=torch.float32))
        args = (s.qpos, s.cube_pos, s.cube_quat)
        on_card = tuple(a.to(DEV) for a in args)
        for cam in model.cameras:
            spec = constants.CAMERAS[cam.name]
            want = raycast.render_camera(model, cam.name, *args, spec.h, spec.w).numpy()
            got = raycast.render_camera(model, cam.name, *on_card, spec.h, spec.w).cpu().numpy()
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
            within, differ = float((diff <= 1).mean()), float((diff > 0).mean())
            n_sky, n_sky_cpu = int(np.all(got == sky, -1).sum()), int(np.all(want == sky, -1).sum())
            ms = cuda_ms(lambda: raycast.render_camera(model, cam.name, *on_card, spec.h, spec.w),
                         10)
            frame_ms[f"{model.name}/{cam.name}"] = ms
            worst = min(worst, within)
            if cam.name == "head":
                busy, n_launch, _ = device_profile(
                    lambda: raycast.render_camera(model, cam.name, *on_card, spec.h, spec.w), 3)
                log("vision", f"{model.name} head frame: device busy {busy:.3f} ms of {ms:.3f}, "
                              f"{n_launch:.0f} launches a frame (profiler) [{card}]")
            log("vision", f"{model.name} {cam.name} {spec.h}x{spec.w}: {ms:.3f} ms per frame on "
                          f"the card (CUDA events); {differ:.4%} of pixels differ from the CPU's, "
                          f"{within:.4%} within one level; sky pixels {n_sky} (CPU {n_sky_cpu}) "
                          f"[{card}]")
            if not (within >= 0.995 and got.std() > 0
                    and abs(n_sky - n_sky_cpu) <= max(0.005 * n_sky_cpu, 1)):
                raise AssertionError(f"vision: {model.name} {cam.name} on the card is not the "
                                     f"CPU's frame ({within:.4%} within one level, sky "
                                     f"{n_sky} against {n_sky_cpu})")
    return frame_ms, worst


def vision_shell(env_id, seed):
    """The Gym shell's view that KManipEnvSim reads (gymnasium is not
    needed: the backend is what gym.make's env steps)."""
    cfg = env_config.CONFIGS[env_id]
    return types.SimpleNamespace(
        cfg=cfg, obs_list=list(cfg.obs_list), np_random=np.random.default_rng(seed),
        cameras=[constants.CAMERAS[o.split("/")[-1]] for o in cfg.obs_list if "camera" in o])


def vision_episode(env_id, n, card):
    """An n-step episode of a Vision id through KManipEnvSim with seeded
    actions: ten K1 launches a step and no plain substep, in-space frames;
    steps/s, the render's ms per step by camera, and one step's ten K1
    launches against the plain substep."""
    shell = vision_shell(env_id, 0)
    sim = env_sim.KManipEnvSim(shell, device=DEV)
    actions = random_actions(shell.cfg, n, seed=1)
    sim.k_reset()
    sim.k_step(actions[0])
    sim.k_reset()
    reset_counts()
    plain_substeps = Recorder(engine, "_substep_torch")
    with plain_substeps:
        t0 = time.perf_counter()
        for a in actions:
            _, reward, _, obs, _ = sim.k_step(a)
        seconds = time.perf_counter() - t0
    if counts() != only(K1=10 * n) or plain_substeps.calls:
        raise AssertionError(f"{env_id}: launches {counts()}, plain substeps "
                             f"{plain_substeps.calls}; expected {10 * n} of K1 and none")
    for cam in shell.cameras:
        img = obs[cam.log_name]
        if not (img.dtype == np.uint8 and img.shape == (cam.h, cam.w, 3) and img.std() > 0):
            raise AssertionError(f"{env_id}: {cam.log_name} {img.dtype} {img.shape}")
    if not np.isfinite(reward):
        raise AssertionError(f"{env_id}: reward {reward}")
    s = sim.state
    render_ms = {cam.name: cuda_ms(lambda: sim.render_fns[cam.name](s.qpos, s.cube_pos,
                                                                      s.cube_quat), 10)
                 for cam in shell.cameras}
    calls = iter(range(1 << 30))
    rec = Recorder(substep_cuda, "substep_batched", key=lambda *_: next(calls))
    with rec:
        sim.k_step(actions[0])
    launches = sorted(rec.by_key.items())
    if len(launches) != 10:
        raise AssertionError(f"{env_id}: a step made {len(launches)} K1 launches")
    err = max(compare_substep(f"{env_id} step launch {i}", *args[:4],
                              [x.contiguous() for x in args[4:]])
              for i, (_, (args, _)) in enumerate(launches))
    log("vision", f"{env_id}: {n} steps through KManipEnvSim in {seconds:.3f} s, "
                  f"{n / seconds:.2f} steps/s; 10 K1 launches and no plain substep per step; "
                  f"render ms per step (CUDA events) " + ", ".join(
                      f"{c} {v:.3f}" for c, v in render_ms.items())
                  + f"; one step's ten K1 launches within phase 2's bands (largest {err:.3e}) "
                  f"[{card}]")
    return dict(steps_per_s=n / seconds, render_ms=render_ms, max_abs_err=err)


def vision_vec(card):
    """The vec env KManipSoloArmVision at N = 64, render_hw = VISION_HW:
    ten K1 launches a step and no plain substep; vec and env steps/s, and
    the split of a step."""
    env = KManipVecEnv("KManipSoloArmVision", N_VEC, seed=3, device=DEV,
                       render_hw=ex12.VISION_HW)
    rng = np.random.default_rng(3)
    actions = [vec_actions(env.cfg, N_VEC, rng) for _ in range(VISION_VEC_STEPS)]
    env.reset()
    env.step(actions[0])
    env.reset()
    reset_counts()
    plain_substeps = Recorder(engine, "_substep_torch")
    with plain_substeps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in actions:
            obs = env.step(a)[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    n = len(actions)
    if counts() != only(K1=10 * n) or plain_substeps.calls:
        raise AssertionError(f"vision vec: launches {counts()}, plain substeps "
                             f"{plain_substeps.calls}; expected {10 * n} of K1 and none")
    for cam in env.cameras:
        img = obs[cam.log_name]
        if not (img.dtype == torch.uint8 and tuple(img.shape) == (N_VEC,) + ex12.VISION_HW + (3,)
                and float(img.float().std()) > 0):
            raise AssertionError(f"vision vec: {cam.log_name} {img.dtype} {tuple(img.shape)}")
    # the split of a step: its stages from the same state, each ended by a
    # synchronize, then the step itself, its render and the rest
    split = dict(goals=0.0, trf=0.0, control_step=0.0, obs_reward=0.0, render=0.0, rest=0.0)
    for a in actions[:4]:
        part = vec_split(env, [a])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env.step(a)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = env._states
        for cam in env.cameras:
            raycast.render_camera(env.model, cam.name, st.qpos, st.cube_pos, st.cube_quat,
                                  *ex12.VISION_HW)
        torch.cuda.synchronize()
        part["render"] = 1e3 * (time.perf_counter() - t1)
        part["rest"] = 1e3 * (t1 - t0) - sum(part.values())
        for key, v in part.items():
            split[key] += v / 4
    log("vision", f"vec KManipSoloArmVision N={N_VEC} render_hw={ex12.VISION_HW}: {n} vec steps "
                  f"in {seconds:.3f} s, {n / seconds:.3f} vec steps/s, {N_VEC * n / seconds:.1f} "
                  f"env steps/s; 10 K1 launches and no plain substep per step; split of a step "
                  f"(ms): " + ", ".join(f"{key} {v:.2f}" for key, v in split.items())
                  + f" [{card}]")
    return dict(vec_steps_per_s=n / seconds, env_steps_per_s=N_VEC * n / seconds, split_ms=split)


def vision_cost_params(h, w, seed):
    """CostCNN parameters for (h, w) frames in flax's layout (HWIO conv and
    (in, out) Dense kernels), drawn by numpy from a seed."""
    rng = np.random.default_rng(seed)
    flat = same_side(same_side(h)) * same_side(same_side(w)) * 16
    shapes = {"Conv_0": (3, 3, 3, 8), "Conv_1": (3, 3, 8, 16), "Dense_0": (flat, 32),
              "Dense_1": (32, 1)}
    return {"params": {name: {
        "kernel": (rng.normal(size=s) / np.sqrt(np.prod(s[:-1]))).astype(np.float32),
        "bias": rng.normal(0, 0.1, s[-1]).astype(np.float32)} for name, s in shapes.items()}}


def vision_mppi(card):
    """The vision MPPI solve at example 10's shape: H K1 launches a solve
    and no plain substep, solves/s and renders plus CNN evaluations per
    second; its J against the plain substep's on one injected draw (1e-4 of
    |J|); the time of one step's render and CNN beside K1's."""
    model = get_model("solo_arm")
    cfg, (h, w) = VISION_MPPI, VISION_MPPI_HW
    net = vision_cost.cost_cnn_from_flax(vision_cost_params(h, w, seed=10), device=DEV)
    cost = vision_cost.make_vision_cost(model, net, "top", h, w)
    solver = make_mppi_solver(model, cfg, cost)
    s0 = init_state(model, cube_pos=np.array([0.15, 0.58, 0.62]), device=DEV)
    ms = init_mppi(model, cfg, seed=0, device=DEV)
    ms, u0, J = solver(ms, s0)
    reset_counts()
    plain_substeps = Recorder(engine, "_substep_torch")
    with plain_substeps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VISION_MPPI_SOLVES):
            ms, u0, J = solver(ms, s0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    n, H, Kv = VISION_MPPI_SOLVES, cfg.horizon, cfg.n_samples
    if counts() != only(K1=H * n) or plain_substeps.calls:
        raise AssertionError(f"vision MPPI: launches {counts()}, plain substeps "
                             f"{plain_substeps.calls}; expected {H * n} of K1 and none")
    if not (bool(torch.isfinite(J)) and bool(torch.isfinite(u0).all())):
        raise AssertionError(f"vision MPPI: J {float(J)}")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    eps = torch.randn((Kv, H, model.nu), generator=gen, device=DEV) * 0.05
    fresh = init_mppi(model, cfg, seed=0, device=DEV)
    _, u_k, J_k = solver(fresh, s0, eps=eps)
    _, u_p, J_p = plain(make_mppi_solver(model, cfg, cost, substep_fn=engine._substep_torch),
                        fresh, s0, eps=eps)
    check("vision", f"MPPI J on the K1 route against the plain substep, relative [{card}]",
          abs(float(J_k) - float(J_p)) / abs(float(J_p)), 1e-4)
    states = SimState(*(x.expand((Kv,) + tuple(x.shape)).contiguous() for x in s0))
    step_cost_ms = cuda_ms(lambda: cost(states, None, None), 10)
    busy, n_launch, _ = device_profile(lambda: cost(states, None, None), 3)
    solve_ms = 1e3 * seconds / n
    log("vision", f"MPPI H={H} K={Kv} top {h}x{w}: {n / seconds:.2f} solves/s ({solve_ms:.2f} ms a "
                  f"solve), {Kv * H * n / seconds:.0f} renders + CNN evaluations per s; "
                  f"{H} K1 launches and no plain substep per solve; one step's render + CNN "
                  f"{step_cost_ms:.3f} ms (CUDA events; device busy {busy:.3f} ms in "
                  f"{n_launch:.0f} launches), {H} of them {H * step_cost_ms:.2f} ms of the "
                  f"solve; J {float(J_k):.6f} against the plain substep's {float(J_p):.6f} "
                  f"[{card}]")
    return dict(solves_per_s=n / seconds, renders_per_s=Kv * H * n / seconds,
                step_render_cnn_ms=step_cost_ms, J_rel_err=abs(float(J_k) - float(J_p))
                / abs(float(J_p)))


def tip_cube_m(model, state):
    xpos, xquat, _ = kin.fk(model, state.qpos)
    tips = engine._tips_from_frames(model, xpos, xquat)
    return float(torch.linalg.vector_norm(tips - state.cube_pos, dim=-1).min())


def vision_zoo(card):
    """The zoo: all four artifacts load and act on the card; bc_pixels_solo
    and bc_pick_solo run one 120-step episode each closed loop on
    control_step (ten K1 launches a step, no plain substep), and their
    controls on the card match the CPU's (1e-3 and 1e-4 of the ctrl range)."""
    for name in zoo.list_policies():
        policy, meta = zoo.load_policy(name, device=DEV)
        m = get_model(meta["model"])
        u = policy(init_state(m, device=DEV))
        if tuple(u.shape) != (m.nu,) or not bool(torch.isfinite(u).all()):
            raise AssertionError(f"zoo: {name} gave {tuple(u.shape)}")
    out = {}
    for name, tol in (("bc_pixels_solo", 1e-3), ("bc_pick_solo", 1e-4)):
        policy, meta = zoo.load_policy(name, device=DEV)
        policy_cpu, _ = zoo.load_policy(name, device="cpu")
        model = get_model(meta["model"])
        # the JAX package's evaluation (examples/13_bc_pick.py:294-311): the
        # cube settles for 5 steps at the home pose, then the episode; lifted
        # is the cube 4 cm above its settled height
        s0 = init_state(model, cube_pos=np.array([0.2, 0.6, 0.62]), device=DEV)
        hold = torch.as_tensor(model.home_qpos[: model.nu], dtype=torch.float32, device=DEV)
        for _ in range(5):
            s0, _ = engine.control_step(model, s0, hold)
        z0 = float(s0.cube_pos[2])
        engine.control_step(model, s0, policy(s0))
        reset_counts()
        plain_substeps = Recorder(engine, "_substep_torch")
        kept, state, cube_z = [], s0, []
        with plain_substeps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(ZOO_STEPS):
                if t % 40 == 0:
                    kept.append(state)
                state, aux = engine.control_step(model, state, policy(state))
                cube_z.append(state.cube_pos[2])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        if counts() != only(K1=10 * ZOO_STEPS) or plain_substeps.calls:
            raise AssertionError(f"zoo {name}: launches {counts()}, plain substeps "
                                 f"{plain_substeps.calls}")
        span = torch.as_tensor(model.ctrl_range[:, 1] - model.ctrl_range[:, 0],
                               dtype=torch.float32)
        batch = SimState(*(torch.stack(x) for x in zip(*kept)))
        gap = float(((policy(batch).cpu() - policy_cpu(SimState(*(x.cpu() for x in batch))))
                     .abs() / span).max())
        check("vision", f"zoo {name}: card against CPU controls on {len(kept)} states, "
                        f"share of the ctrl range [{card}]", gap, tol)
        d0, d1 = tip_cube_m(model, s0), tip_cube_m(model, state)
        lift = float(torch.stack(cube_z).max()) - z0
        log("vision", f"zoo {name}: {ZOO_STEPS} control steps closed loop in {seconds:.3f} s, "
                      f"{ZOO_STEPS / seconds:.2f} control steps/s; tip-cube distance {d0:.4f} -> "
                      f"{d1:.4f} m, the cube's highest {lift:+.4f} m from its settled height "
                      f"(lifted: {lift > 0.04}); {10 * ZOO_STEPS} K1 launches, no plain "
                      f"substep [{card}]")
        out[name] = dict(control_steps_per_s=ZOO_STEPS / seconds, ctrl_gap=gap)
    return out


def phase_vision():
    """Phase 15: the vision serving path, each piece on K1 with no plain
    substep."""
    card = card_line()
    t0 = time.perf_counter()
    frame_ms, within = vision_renders(card)
    episodes = {env_id: vision_episode(env_id, n, card) for env_id, n in VISION_EPISODES.items()}
    vec = vision_vec(card)
    mppi = vision_mppi(card)
    zoo_runs = vision_zoo(card)
    reset_counts()
    lines = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ex12.train(env_id=ex12.VISION_ENV, vision=True, n_updates=1, n_envs=N_VEC,
               t_rollout=ex12.T_ROLLOUT, seed=0, log=lines.append, device=DEV)
    torch.cuda.synchronize()
    ppo_s = time.perf_counter() - t1
    loss = float(lines[0].split("loss")[-1])
    if counts() != only(K1=10 * ex12.T_ROLLOUT) or not np.isfinite(loss):
        raise AssertionError(f"example 12 --vision: launches {counts()}, loss {loss}")
    log("vision", f"example 12 --vision: one PPO update (N={N_VEC}, T={ex12.T_ROLLOUT}, "
                  f"{ex12.PPO_EPOCHS} epochs, CNNPolicy at {ex12.VISION_HW}) in {ppo_s:.2f} s, "
                  f"loss {loss:.4f} [{card}]")
    log("done", f"the vision phase took {time.perf_counter() - t0:.1f} s")
    err = max(e["max_abs_err"] for e in episodes.values())
    return dict(launches_per_env_step=10, launches_per_vec_step=10,
                launches_per_mppi_solve=VISION_MPPI.horizon, launches_per_zoo_step=10,
                max_abs_err=err, render_within_one_level=within, render_ms=frame_ms,
                env_steps_per_s={k_: e["steps_per_s"] for k_, e in episodes.items()},
                vec_env_steps_per_s=vec["env_steps_per_s"], mppi_solves_per_s=mppi["solves_per_s"],
                mppi_renders_per_s=mppi["renders_per_s"],
                zoo_control_steps_per_s={k_: z["control_steps_per_s"]
                                         for k_, z in zoo_runs.items()},
                ppo_update_s=ppo_s)


# ---- the learning path: the two vision fits, examples 10, 13, 14 and 15,
# the HDF5 logger and the zoo's drift check (phase 16) ----

# the JAX package's slow tests: tests/test_vision_mpc.py:31-78,
# tests/test_pick_from_pixels.py:14-24, tests/test_bc_pick.py:16-36 and
# tests/test_zoo.py:119-140, at their sizes, seeds and bars
VMPC_FIT = dict(seed=0, n_samples=256, n_steps=1200, height=48, width=64, cam_name="top")
VMPC_MPPI = MPPIConfig(horizon=20, n_samples=16, n_iters=1, sigma=0.12, noise_beta=0.9,
                       contact=False)
VMPC_STEPS = 6
PIXELS_RUN = dict(n_episodes=2, ep_len=90, n_samples=128, est_samples=256, est_steps=800,
                  seed=0)
PIXELS_DEFAULTS = (512, 1500)  # example 14's run(): est_samples, est_steps
# The JAX package's estimator error (mean over run()'s first two spawns of
# the seed) at the test's sizes, PRNGKey(seed) for seeds 0-7, on the CPU in
# float32: `tools/jax_estimator_bar.py --seeds 0 1 2 3 4 5 6 7`. It misses
# the test's 0.02 m at every seed, so the port's estimator is held to this
# distribution over the same seeds and spawns, and 0.02 m is reported.
JAX_ESTIMATOR_ERRS = (0.021426625549793243, 0.06731288135051727, 0.04685238562524319,
                      0.04956459626555443, 0.05960860662162304, 0.07068898156285286,
                      0.03876790963113308, 0.04870109632611275)
BC_RUN = dict(n_episodes=3, ep_len=80, n_samples=128, n_train=1500, n_evals=4)
DAGGER_EP_LEN = 40  # one dagger_collect episode
PIXELS_BC_STEPS = 200  # one example 15 `train`
ZOO_EVALS, ZOO_SEED, ZOO_SLACK = 8, 7, 0.35
EXPERT_SOLVES = 10

ex10 = importlib.import_module("gym_kmanip_torch.examples.10_vision_mpc")
ex13 = importlib.import_module("gym_kmanip_torch.examples.13_bc_pick")
ex14 = importlib.import_module("gym_kmanip_torch.examples.14_pick_from_pixels")
ex15 = importlib.import_module("gym_kmanip_torch.examples.15_bc_pixels")


def h5py_stand_in():
    """The h5py module, or where the host has none (the GPU host), a stand-in
    of the part of h5py.File that log/log_h5py.py and examples 13 and 15 use:
    datasets as numpy arrays, groups and attrs as dicts, kept in memory by
    path, with an empty file at the path so that a glob finds it. The
    schema (names, shapes, dtypes, attrs) is the logger's; the HDF5 bytes
    are held on the CPU by tests/test_torch_learning.py."""
    try:
        import h5py
        return h5py, bool(getattr(h5py, "IN_MEMORY_STAND_IN", False))
    except ImportError:
        pass
    files = {}

    class Group:
        def __init__(self):
            self.attrs = {}

    class File:
        def __init__(self, path, mode="r", **_):
            if mode == "w":
                files[path] = ({}, {}, {})
                open(path, "wb").close()
            self.data, self.groups, self.attrs = files[path]

        def create_group(self, name):
            return self.groups.setdefault(name.strip("/"), Group())

        def create_dataset(self, name, shape, dtype=np.float32, chunks=None):
            self.data[name.strip("/")] = np.zeros(shape, dtype)
            return self.data[name.strip("/")]

        def __getitem__(self, name):
            return self.data[name.strip("/")]

        def __contains__(self, name):
            return name.strip("/") in self.data or name.strip("/") in self.groups

        def flush(self):
            pass

        def close(self):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    mod = types.ModuleType("h5py")
    mod.File = File
    mod.IN_MEMORY_STAND_IN = True  # a later call reports the stand-in, not h5py
    sys.modules["h5py"] = mod
    return mod, True


def k1_key(m, dt, contact, implicit, q, *_):
    return (m.nq, dt, contact, implicit, q.shape[0])


def replay_k1(tag, rec):
    """The first K1 launch of each (robot, dt, contact, implicit, K) that
    `rec` recorded, through the kernel and its plain version at phase 2's
    bands; returns the rows."""
    rows = []
    for (nq, dt, contact, implicit, k_), (args, _) in sorted(rec.by_key.items()):
        err = compare_substep(f"{tag} nq={nq} K={k_} dt={dt} contact={contact} "
                              f"implicit={implicit}", *args[:4],
                              [a.contiguous() for a in args[4:]])
        rows.append(dict(nq=nq, K=k_, dt=dt, contact=contact, implicit=implicit,
                         max_abs_err=err))
    if not rows:
        raise AssertionError(f"{tag}: no K1 launch was recorded")
    return rows


class launches_of:
    """Counts set to 0 on entry, read on exit with no plain substep in
    between; `expected` (a K1 count) is checked when it is given."""

    def __init__(self, what, expected=None):
        self.what, self.expected = what, expected
        self.k1 = Recorder(substep_cuda, "substep_batched", key=k1_key)
        self.plain_substeps = Recorder(engine, "_substep_torch")

    def __enter__(self):
        reset_counts()
        self.k1.__enter__()
        self.plain_substeps.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.plain_substeps.__exit__()
        self.k1.__exit__()
        self.counts = counts()
        if exc[0] is None:
            k1 = self.counts["K1"]
            if (self.counts != only(K1=k1) or self.plain_substeps.calls
                    or (self.expected is not None and k1 != self.expected) or k1 < 1):
                raise AssertionError(f"{self.what}: launches {self.counts}, plain substeps "
                                     f"{self.plain_substeps.calls}; expected "
                                     f"{self.expected} of K1 and nothing else")


def fit_step_profile(model, net, h, w):
    """One fit_distance_cost step (`optim.mse_step`) on a copy of `net` at
    the fit's batch: CUDA-event ms per step, device busy ms and launches per
    step, and the three largest kernels (device ms and launches per step)."""
    probe = copy.deepcopy(net)
    opt, sched = optim.adam(probe.parameters(), 1e-4)
    qs, cubes = vision_cost.draw_examples(model, torch.Generator().manual_seed(1),
                                          VMPC_FIT["n_samples"], 0.5)
    imgs = vision_cost._frames(model, VMPC_FIT["cam_name"], qs.to(DEV), cubes.to(DEV), h, w)
    dists = torch.rand(imgs.shape[0], device=DEV)

    def step():
        return optim.mse_step(probe, opt, sched, dists, imgs)

    step_ms = cuda_ms(step, 20)
    busy, n_launch, kernels = device_profile(step, 5)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
    return step_ms, busy, n_launch, top


def learning_vision_mpc(card, failures):
    """tests/test_vision_mpc.py:31-78 on the card: fit_distance_cost, then
    its MPPI from the displaced start for 6 control steps; bar: the lowest
    true tip-cube distance < d0 - 0.05."""
    model = get_model("solo_arm")
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = vision_cost.fit_distance_cost(model, device=DEV, losses=losses, **VMPC_FIT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    h, w = VMPC_FIT["height"], VMPC_FIT["width"]
    step_ms, busy, n_launch, top = fit_step_profile(model, net, h, w)
    log("learning", f"a fit_distance_cost step (256 frames {h}x{w}, full batch): {step_ms:.3f} ms "
                    f"(CUDA events), device busy {busy:.3f} ms in {n_launch:.0f} launches "
                    f"(profiler); largest kernels " + ", ".join(
                        f"{name[:60]} {ms:.3f} ms x {c:.0f}" for name, (ms, c) in top)
                    + f" [{card}]")
    cost = vision_cost.make_vision_cost(model, net, "top", h, w, w_vel=0.001)
    cfg = VMPC_MPPI
    solver = make_mppi_solver(model, cfg, cost)
    ms = init_mppi(model, cfg, seed=0, device=DEV)
    state = init_state(model, cube_pos=np.array([0.15, 0.58, 0.62]), device=DEV)
    t = model_tensors(model, DEV)
    home = torch.as_tensor(model.home_qpos, dtype=torch.float32, device=DEV)
    q_off = torch.clamp(home + torch.nn.functional.one_hot(torch.tensor(0), model.nq).to(DEV)
                        * -0.5, t.jnt_lo, t.jnt_hi)
    state = state._replace(qpos=q_off, ctrl=q_off[: model.nu].clone())
    ms = ms._replace(nominal=q_off[: model.nu].repeat(cfg.horizon, 1))

    def true_dist(aux, s):
        return float(torch.linalg.vector_norm(aux.tip_pos - s.cube_pos[None, :], dim=-1).min())

    _, aux0 = engine.control_step(model, state, state.ctrl)
    d0 = true_dist(aux0, state)
    dists = []
    with launches_of("vision MPC", VMPC_STEPS * (cfg.horizon + 10)) as run:
        for _ in range(VMPC_STEPS):
            ms, u0, J = solver(ms, state)
            state, aux = engine.control_step(model, state, u0)
            dists.append(true_dist(aux, state))
    rows = replay_k1("learning vision MPC", run.k1)
    ok = all(np.isfinite(dists)) and min(dists) < d0 - 0.05
    log("learning", f"vision MPC: fit_distance_cost ({VMPC_FIT['n_samples']} frames {h}x{w}, "
                    f"{VMPC_FIT['n_steps']} full-batch steps) in {fit_s:.2f} s, "
                    f"{VMPC_FIT['n_steps'] / fit_s:.1f} steps/s, loss "
                    f"{losses[0]:.5f} -> {losses[-1]:.5f}; MPPI H={cfg.horizon} K={cfg.n_samples} "
                    f"contact-free, {VMPC_STEPS} control steps in {run.seconds:.3f} s "
                    f"({VMPC_STEPS / run.seconds:.2f} steps/s, {run.counts['K1']} K1 launches); "
                    f"true tip-cube distance d0 {d0:.4f} m, then "
                    + ", ".join(f"{d:.4f}" for d in dists)
                    + f"; bar min < d0 - 0.05: {'met' if ok else 'MISSED'} [{card}]")
    if not ok:
        failures.append(f"vision MPC: min distance {min(dists):.4f} m, d0 {d0:.4f} m")
    return dict(fit_s=fit_s, fit_steps_per_s=VMPC_FIT["n_steps"] / fit_s, fit_step_ms=step_ms,
                fit_step_device_ms=busy, d0=d0,
                min_dist=min(dists), launches=run.counts["K1"],
                launches_per_step=run.counts["K1"] / VMPC_STEPS,
                control_steps_per_s=VMPC_STEPS / run.seconds, k1=rows)


def pixels_estimator_draws():
    """The JAX test's own draws for its estimator fit (PRNGKey(0); written
    by tools/make_golden_learning.py): ((qs, cubes, idx), flax params)."""
    with np.load(os.path.join(GOLDEN, "pixels_estimator_draws.npz")) as d:
        params = zoo._unflatten_params({key[2:]: d[key] for key in d.files
                                        if key.startswith("p:")})
        return (d["qs"], d["cubes"], d["idx"].astype(np.int64)), params


def estimator_error(estimate, seed, n_episodes):
    """The mean initial estimate error over run()'s first n_episodes spawns,
    as run() measures it."""
    model, rng, errs = get_model("solo_arm"), np.random.RandomState(seed + 1), []
    for _ in range(n_episodes):
        spawn = np.clip(np.array([0.15, 0.58, 0.62]) + rng.uniform(-1, 1, 3)
                        * np.array([0.02, 0.02, 0.0]), constants.CUBE_SPAWN_RANGE[:, 0],
                        constants.CUBE_SPAWN_RANGE[:, 1])
        s = init_state(model, cube_pos=spawn, device=DEV)
        img = raycast.render_camera(model, ex14.CAM, s.qpos, s.cube_pos, s.cube_quat,
                                    ex14.H_PX, ex14.W_PX).float() / 255.0
        errs.append(float(torch.linalg.vector_norm(estimate(img) - s.cube_pos)))
    return float(np.mean(errs))


def estimator_fit(n_samples, n_steps, draws=None, init=None, seed=PIXELS_RUN["seed"]):
    """fit_cube_pos_estimator as run() calls it at `seed`: (estimate,
    seconds, first and last loss)."""
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, estimate = vision_cost.fit_cube_pos_estimator(
        get_model("solo_arm"), seed=seed, n_samples=n_samples, n_steps=n_steps,
        height=ex14.H_PX, width=ex14.W_PX, cam_name=ex14.CAM, device=DEV, draws=draws,
        init=init, losses=losses)
    torch.cuda.synchronize()
    return estimate, time.perf_counter() - t0, losses[0], losses[-1]


def estimator_bar(seed0_err):
    """The estimator's error at the test's sizes over seeds 0-7 (seed 0 from
    run(), the others fitted here), each at run()'s spawns of its seed,
    against JAX_ESTIMATOR_ERRS: the port's mean at most the reference's
    plus two standard errors of the difference. Returns (errors, mean,
    bar)."""
    errs = [seed0_err] + [
        estimator_error(estimator_fit(PIXELS_RUN["est_samples"], PIXELS_RUN["est_steps"],
                                      seed=seed)[0], seed, PIXELS_RUN["n_episodes"])
        for seed in range(1, len(JAX_ESTIMATOR_ERRS))]
    n = len(errs)
    se = (statistics.variance(errs) / n + statistics.variance(JAX_ESTIMATOR_ERRS) / n) ** 0.5
    return errs, statistics.mean(errs), statistics.mean(JAX_ESTIMATOR_ERRS) + 2 * se


def learning_pixels(card, failures):
    """tests/test_pick_from_pixels.py:14-24 on the card: example 14's run at
    the test's sizes and seed (the estimator on the port's own draws of that
    seed); bars: at least one lift, and the estimator's error over seeds 0-7
    no worse than the JAX package's (`estimator_bar`); the test's 0.02 m,
    which the JAX package misses at each of those seeds, is reported. Beside
    it, not bars: the estimator fit on the JAX test's own draws and initial
    weights (PRNGKey(0)), and at run()'s defaults (512 frames, 1,500 steps)
    over its five default spawns."""
    lines = []
    cfg_steps = PIXELS_RUN["n_episodes"] * PIXELS_RUN["ep_len"]
    # a step: the expert's 2 x 20 x 10 substeps, the plant's 10, the belief's 10
    with launches_of("pick from pixels", cfg_steps * (2 * 20 * 10 + 20)) as run:
        rate, est_err = ex14.run(log=lines.append, device=DEV, **PIXELS_RUN)
    rows = replay_k1("learning pick from pixels", run.k1)
    fit_s = float([ln for ln in lines if "estimator trained" in ln][0].split()[-1][:-1])
    control_s = run.seconds - fit_s
    errs, est_mean, est_bar = estimator_bar(est_err)
    ok = est_mean <= est_bar and rate > 0
    log("learning", f"pick from pixels: fit_cube_pos_estimator ({PIXELS_RUN['est_samples']} "
                    f"frames {ex14.H_PX}x{ex14.W_PX}, {PIXELS_RUN['est_steps']} steps of 128, "
                    f"seed {PIXELS_RUN['seed']}) in {fit_s:.1f} s; "
                    f"{PIXELS_RUN['n_episodes']} episodes of "
                    f"{PIXELS_RUN['ep_len']} steps (MPPI H=20 K={PIXELS_RUN['n_samples']}, 2 "
                    f"iterations) in "
                    f"{control_s:.1f} s, {cfg_steps / control_s:.2f} control steps/s, "
                    f"{run.counts['K1']} K1 launches; estimator error {est_err:.4f} m (the "
                    f"test's < 0.02: {'met' if est_err < 0.02 else 'missed'}; the JAX package's "
                    f"{JAX_ESTIMATOR_ERRS[0]:.4f}), success rate {rate:.2f}; the estimator over "
                    f"seeds 0-{len(errs) - 1} {[round(e, 4) for e in errs]}, mean {est_mean:.4f} m "
                    f"against the JAX package's {statistics.mean(JAX_ESTIMATOR_ERRS):.4f} "
                    f"(0.02 missed at {sum(e >= 0.02 for e in JAX_ESTIMATOR_ERRS)} of "
                    f"{len(JAX_ESTIMATOR_ERRS)} seeds); bars mean <= {est_bar:.4f} (its mean + "
                    f"2 standard errors) and a lift: {'met' if ok else 'MISSED'} [{card}]")
    for ln in lines:
        if "episode" in ln or "t=" in ln:
            log("learning", f"pick from pixels: {ln.strip()}")
    if not ok:
        failures.append(f"pick from pixels: estimator mean {est_mean:.4f} m over seeds 0-"
                        f"{len(errs) - 1} (bar {est_bar:.4f}), rate {rate}")

    draws, init = pixels_estimator_draws()
    golden, _, g0, g1 = estimator_fit(PIXELS_RUN["est_samples"], PIXELS_RUN["est_steps"],
                                      draws, init)
    golden_err = estimator_error(golden, PIXELS_RUN["seed"], PIXELS_RUN["n_episodes"])
    defaults, defaults_s, d0, d1 = estimator_fit(*PIXELS_DEFAULTS)
    defaults_err = estimator_error(defaults, PIXELS_RUN["seed"], 5)
    log("learning", f"pick from pixels, not bars: the estimator fit on the JAX test's draws and "
                    f"initial weights (PRNGKey(0)): error {golden_err:.4f} m at the test's "
                    f"spawns, loss {g0:.4f} -> {g1:.4f}; at run()'s defaults "
                    f"({PIXELS_DEFAULTS[0]} frames, {PIXELS_DEFAULTS[1]} steps, seed "
                    f"{PIXELS_RUN['seed']}) in {defaults_s:.1f} s: error {defaults_err:.4f} m "
                    f"over its 5 spawns, loss {d0:.4f} -> {d1:.4f} (the constant-mean plateau "
                    f"is ~0.33) [{card}]")
    return dict(est_err=est_err, est_errs_seeds=errs, est_mean=est_mean, est_bar=est_bar,
                rate=rate, fit_s=fit_s, control_steps_per_s=cfg_steps / control_s,
                launches=run.counts["K1"], launches_per_step=run.counts["K1"] / cfg_steps,
                golden_draws_est_err=golden_err, defaults_est_err=defaults_err,
                defaults_fit_s=defaults_s, k1=rows)


def learning_bc(card, failures):
    """tests/test_bc_pick.py:16-36 on the card: example 13's run_pipeline
    into a temporary directory (bars: the expert and the clone each lift at
    least once; three ACT-layout files with cube_pose), then one
    dagger_collect episode and one example 15 `train` of 200 steps on those
    files (finite outputs), and the expert's solves/s."""
    import tempfile

    h5py, stand_in = h5py_stand_in()
    h5py_kind = "an in-memory stand-in of h5py.File: the host has no h5py" if stand_in else "h5py"
    data_dir = tempfile.mkdtemp(prefix="kmanip_bc_")
    times, outs = {}, {}
    saved = {name: getattr(ex13, name) for name in ("record", "train", "evaluate")}

    def timed(name):
        def fn(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = saved[name](*args, **kwargs)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            return outs[name]
        return fn

    n_ep, ep_len, n_evals = BC_RUN["n_episodes"], BC_RUN["ep_len"], BC_RUN["n_evals"]
    eval_len = int(ep_len * 1.2)
    # record: 5 settling steps and ep_len steps of (2 x 20 x 10 expert + 10
    # plant) per episode; evaluate: the n_evals episodes as one batch
    expected = n_ep * (50 + ep_len * 410) + 10 * (5 + eval_len)
    lines = []
    try:
        for name in saved:
            setattr(ex13, name, timed(name))
        with launches_of("BC pick", expected) as run:
            expert_rate, bc_rate = ex13.run_pipeline(data_dir=data_dir, log=lines.append,
                                                     device=DEV, **BC_RUN)
    finally:
        for name, fn in saved.items():
            setattr(ex13, name, fn)
    rows = replay_k1("learning BC pick", run.k1)
    files = sorted(glob.glob(os.path.join(data_dir, "episode_*.hdf5")))
    layout = []
    for path in files:
        with h5py.File(path, "r") as f:
            layout.append(all(n in f for n in ("observations/qpos", "observations/qvel",
                                               "action", "observations/cube_pose"))
                          and f["observations/cube_pose"].shape == (2 * constants.MAX_EPISODE_STEPS,
                                                                    7))
    ok = expert_rate > 0 and bc_rate > 0 and len(files) == n_ep and all(layout)
    train_sps = BC_RUN["n_train"] / times["train"]
    eval_sps = n_evals * eval_len / times["evaluate"]
    log("learning", f"BC pick: record {n_ep} expert episodes of {ep_len} steps "
                    f"(K={BC_RUN['n_samples']}) in "
                    f"{times['record']:.1f} s ({n_ep / times['record']:.3f} episodes/s); train "
                    f"{BC_RUN['n_train']} steps in {times['train']:.2f} s ({train_sps:.1f} "
                    f"steps/s); evaluate {n_evals} episodes of {eval_len} steps as one batch in "
                    f"{times['evaluate']:.2f} s ({eval_sps:.1f} control steps/s); "
                    f"{run.counts['K1']} K1 launches; expert rate {expert_rate:.2f}, BC rate "
                    f"{bc_rate:.2f}; {len(files)} ACT files with cube_pose "
                    f"({h5py_kind}); bars: {'met' if ok else 'MISSED'} [{card}]")
    if not ok:
        failures.append(f"BC pick: expert {expert_rate}, BC {bc_rate}, files {len(files)}, "
                        f"layout {layout}")

    # the expert's solves/s at this size
    model = get_model("solo_arm")
    solver, ms0 = ex13.make_expert(model, n_samples=BC_RUN["n_samples"], device=DEV)
    s0 = init_state(model, cube_pos=ex13.SPAWN_CENTER, device=DEV)
    ms, u0, _ = solver(ms0, s0)
    with launches_of("the expert's solves", EXPERT_SOLVES * 400) as solves:
        for _ in range(EXPERT_SOLVES):
            ms, u0, _ = solver(ms, s0)
    expert_sps = EXPERT_SOLVES / solves.seconds
    per_solve = solves.counts["K1"] / EXPERT_SOLVES

    # one DAgger episode under the clone, then example 15 on the files
    policy = outs["train"][0]
    with launches_of("dagger_collect", 50 + DAGGER_EP_LEN * 410) as dag:
        X, Y = ex13.dagger_collect(policy, n_episodes=1, ep_len=DAGGER_EP_LEN,
                                   n_samples=BC_RUN["n_samples"], log=lambda *a: None, device=DEV)
    np.savez(os.path.join(data_dir, "dagger_labels.npz"), X=X, Y=Y)
    lines15 = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p15, _, _ = ex15.train(data_dir, n_steps=PIXELS_BC_STEPS, log=lines15.append, device=DEV)
    torch.cuda.synchronize()
    t15 = time.perf_counter() - t0
    loss15 = float(lines15[-1].split("loss")[-1])
    u15 = p15(s0)
    ok15 = (np.all(np.isfinite(X)) and np.all(np.isfinite(Y)) and X.shape == (DAGGER_EP_LEN, 27)
            and np.isfinite(loss15) and bool(torch.isfinite(u15).all()))
    log("learning", f"expert (MPPI H=20 K={BC_RUN['n_samples']}, 2 iterations, 10 substeps): "
                    f"{expert_sps:.2f} solves/s, {per_solve:g} K1 launches a solve; "
                    f"dagger_collect: one episode of {DAGGER_EP_LEN} labels in "
                    f"{dag.seconds:.2f} s; example 15 "
                    f"train ({lines15[0]}) {PIXELS_BC_STEPS} steps of 64 in {t15:.2f} s, last "
                    f"logged loss {loss15:.5f}, its policy's control finite: "
                    f"{'yes' if ok15 else 'NO'} [{card}]")
    if not ok15:
        failures.append(f"dagger / example 15: X {X.shape}, loss {loss15}, u {u15}")
    return dict(expert_rate=expert_rate, bc_rate=bc_rate, record_episodes_per_s=n_ep /
                times["record"], train_steps_per_s=train_sps, eval_control_steps_per_s=eval_sps,
                expert_solves_per_s=expert_sps, launches=run.counts["K1"],
                launches_per_expert_solve=per_solve, pixels_bc_s=t15, k1=rows)


def learning_zoo(card, failures):
    """tests/test_zoo.py:119-140 on the card: each shipped artifact over 8
    episodes (seed 7) of its meta's length, its rate >= the meta's - 0.35."""
    out, rows = {}, []
    for name in zoo.list_policies():
        policy, meta = zoo.load_policy(name, device=DEV)
        ep_len = int(meta.get("eval_ep_len", 120))
        with launches_of(f"zoo {name}", 10 * (5 + ep_len)) as run:
            rate = ex13.evaluate(policy, n_evals=ZOO_EVALS, ep_len=ep_len, seed=ZOO_SEED,
                                 log=lambda *a: None, model_name=str(meta["model"]),
                                 spawn_range=np.asarray(meta["spawn_range"], np.float64),
                                 device=DEV)
        rows += replay_k1(f"learning zoo {name}", run.k1)
        bar = float(meta["eval_success_rate"]) - ZOO_SLACK
        ok = rate >= bar
        sps = ZOO_EVALS * ep_len / run.seconds
        log("learning", f"zoo drift check {name}: {ZOO_EVALS} episodes of {ep_len} steps (seed "
                        f"{ZOO_SEED}) as one batch in {run.seconds:.2f} s, {sps:.1f} control "
                        f"steps/s; rate {rate:.3f} against the meta's "
                        f"{float(meta['eval_success_rate']):.3f} (bar >= {bar:.3f}: "
                        f"{'met' if ok else 'MISSED'}) [{card}]")
        if not ok:
            failures.append(f"zoo {name}: rate {rate} < {bar:.3f}")
        out[name] = dict(rate=rate, meta_rate=float(meta["eval_success_rate"]),
                         control_steps_per_s=sps, launches=run.counts["K1"], steps=5 + ep_len)
    return out, rows


def phase_learning():
    """Phase 16: the learning path at the JAX slow tests' sizes and bars,
    each run on K1 with no plain substep. Every part runs; returns (the
    row, the missed bars): a missed bar fails the script after the kernels
    line (main)."""
    card = card_line()
    t0 = time.perf_counter()
    failures = []
    # cuDNN's nondeterministic algorithms made two fits on the same draws
    # differ; its deterministic ones make every fit of this phase repeat
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        vmpc = learning_vision_mpc(card, failures)
        pixels = learning_pixels(card, failures)
        bc = learning_bc(card, failures)
        zoo_rates, zoo_rows = learning_zoo(card, failures)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    rows = vmpc.pop("k1") + pixels.pop("k1") + bc.pop("k1") + zoo_rows
    log("done", f"the learning phase took {time.perf_counter() - t0:.1f} s")
    # launches per step or solve, read from each part's counts
    zoo_steps = sum(z.pop("steps") for z in zoo_rates.values())
    return dict(launches_per_vision_mpc_step=vmpc["launches_per_step"],
                launches_per_expert_solve=bc["launches_per_expert_solve"],
                launches_per_pixels_step=pixels["launches_per_step"],
                launches_per_evaluate_step=sum(z["launches"] for z in zoo_rates.values())
                / zoo_steps,
                max_abs_err=max(r["max_abs_err"] for r in rows), vision_mpc=vmpc,
                pick_from_pixels=pixels, bc_pick=bc, zoo=zoo_rates), failures


# phase 17: example 8's MPPI solve (H=20, K=256, 2 iterations, 10 substeps of
# 2 ms, contact) and phase 7's iLQR problems, sharded
SHARDED_MPPI = MPPIConfig(horizon=20, n_samples=K, n_iters=2, sigma=0.15, n_substeps=10,
                          dt=constants.PHYSICS_TIMESTEP, noise_beta=0.9)
SHARDED_RANKS = 2
SHARDED_B = 4  # iLQR problems
SHARDED_RATE = (3, 3)  # solves x repeats of each rate
RENDEZVOUS_S, RANKS_WAIT_S = 120.0, 420.0


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_problem(model):
    """Example 8's plant state and cost, the MPPI noise (n_iters, K, H, nu)
    and phase 7's production iLQR set-up with SHARDED_B start states and
    warm starts around it, all from seeds, on DEV."""
    ex8 = importlib.import_module("gym_kmanip_torch.examples.8_mpc_mppi")
    cfg = SHARDED_MPPI
    sim = init_state(model, cube_pos=ex8.CUBE_SPAWN, device=DEV)
    eps = torch.randn((cfg.n_iters, cfg.n_samples, cfg.horizon, model.nu),
                      generator=torch.Generator().manual_seed(17)) * cfg.sigma
    s0, _, cost_xu, quad_xu, icfg, us = ilqr_setup(model, H)
    x0 = ilqr.flatten_state(s0, reduced=True).cpu().numpy()
    rng = np.random.RandomState(17)
    x0s = (x0[None] + 0.01 * rng.randn(SHARDED_B, x0.size)).astype(np.float32)
    uss = (us.cpu().numpy()[None] + 0.01 * rng.randn(SHARDED_B, *us.shape)).astype(np.float32)
    return dict(cost=ex8.make_cost(model), sim=sim, eps=eps.to(DEV), s0=s0, cost_xu=cost_xu,
                quad_xu=quad_xu, icfg=icfg, x0s=torch.as_tensor(x0s, device=DEV),
                uss=torch.as_tensor(uss, device=DEV))


def timed_rates(fn, n, repeats):
    rates = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    return rates


def sharded_run(model, mesh):
    """Phase 17's work on one rank of `mesh`: the elite's tie-break on the
    card, the sharded MPPI solve on the injected noise with its launches
    counted and its first K1 launch of each shape replayed against the plain
    substep, its solves/s, and the sharded iLQR with its launches counted
    and its problems/s. Prints nothing; returns numpy arrays and JSON."""
    p = sharded_problem(model)
    out = {}
    local_k, w = 3, mesh.size
    costs = torch.ones(w * local_k, device=DEV)
    costs[local_k - 1] = costs[w * local_k - 1] = 0.5  # rank 0's and the last rank's last
    cand = torch.arange(w * local_k * 4, dtype=torch.float32, device=DEV).reshape(-1, 4)
    mine = slice(mesh.rank * local_k, (mesh.rank + 1) * local_k)
    best, gmin = pmesh.global_elite(costs[mine], cand[mine], local_k, mesh)
    out.update(elite_best=best.cpu().numpy(), elite_gmin=gmin.cpu().numpy())

    solve = pmesh.make_sharded_mppi_solver(model, SHARDED_MPPI, p["cost"], mesh)
    ms0 = init_mppi(model, SHARDED_MPPI, device=DEV)
    solve(ms0, p["sim"], eps=p["eps"])  # builds the cached tensors
    with launches_of("sharded MPPI", expected=SHARDED_MPPI.n_iters * SHARDED_MPPI.horizon
                     * SHARDED_MPPI.n_substeps) as lo:
        ms, u0, J = solve(ms0, p["sim"], eps=p["eps"])
    out.update(mppi_u0=u0.cpu().numpy(), mppi_J=J.cpu().numpy(),
               mppi_nominal=ms.nominal.cpu().numpy(), mppi_counts=json.dumps(lo.counts))
    replays = []
    for key, (args, _) in sorted(lo.k1.by_key.items()):
        args = [a.contiguous() if torch.is_tensor(a) else a for a in args]
        got = substep_cuda.substep_batched(*args)
        want = substep_cuda.substep_batched_reference(*args)
        errs = {n: float((g - w_).abs().max()) for n, g, w_ in zip(OUTS, got, want)
                if n != "touch"}
        replays.append(dict(K=key[-1], dt=key[1], contact=key[2], errs=errs,
                            flips=int((got[3] != want[3]).sum())))
    out["k1_replays"] = json.dumps(replays)
    out["mppi_rates"] = np.array(timed_rates(lambda: solve(ms0, p["sim"], eps=p["eps"]),
                                             *SHARDED_RATE))

    isolve = pmesh.make_sharded_ilqr_solver(model, p["icfg"], p["cost_xu"], mesh, p["s0"],
                                            SHARDED_B, quad_xu=p["quad_xu"])
    isolve(p["x0s"], p["uss"])  # builds the cached tensors
    reset_counts()
    us, icosts, traces = isolve(p["x0s"], p["uss"])
    torch.cuda.synchronize()
    out.update(ilqr_us=us.cpu().numpy(), ilqr_costs=icosts.cpu().numpy(),
               ilqr_traces=traces.cpu().numpy(), ilqr_counts=json.dumps(counts()))
    out["ilqr_rates"] = SHARDED_B * np.array(timed_rates(lambda: isolve(p["x0s"], p["uss"]),
                                                         1, 2))
    return out


def sharded_rank(rank, world, port, out_path):
    """One rank of phase 17's group (spawned): joins through
    127.0.0.1:`port` on DEV, where init_distributed picks gloo since the
    ranks share the card, runs `sharded_run` and writes its results to
    `out_path`."""
    dev = pmesh.init_distributed(f"127.0.0.1:{port}", world, rank, timeout_s=RENDEZVOUS_S)
    if dev != DEV or dist.get_backend() != "gloo":
        raise AssertionError(f"rank {rank}: {dev} over {dist.get_backend()}, expected {DEV} "
                             f"over gloo")
    try:
        np.savez(out_path, **sharded_run(get_model("solo_arm"), pmesh.make_mesh()))
    finally:
        dist.destroy_process_group()


def spawn_ranks(world):
    """`world` ranks of `sharded_rank`, spawned, each with its own
    rendezvous timeout; the parent waits RANKS_WAIT_S at most. A rank that
    fails or hangs fails the phase. Returns each rank's results."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f"rank{r}.npz") for r in range(world)]
        procs = [ctx.Process(target=sharded_rank, args=(r, world, port, paths[r]))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.perf_counter() + RANKS_WAIT_S
        for proc in procs:
            proc.join(max(0.0, deadline - time.perf_counter()))
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(30)
        if hung or any(proc.exitcode != 0 for proc in procs):
            raise AssertionError(f"sharded ranks: hung {hung}, exit codes "
                                 f"{[proc.exitcode for proc in procs]}")
        return [dict(np.load(path)) for path in paths]


def phase_sharded(model):
    """Phase 17: the sharded MPPI and iLQR on a one-rank NCCL group in
    process and on two gloo ranks sharing the card, against the
    single-device solvers."""
    card = card_line()
    t0 = time.perf_counter()

    def say(msg):
        log("sharded", f"{msg} ({card})")

    def within(what, err, tol):
        check("sharded", f"{what} ({card})", err, tol)

    p = sharded_problem(model)
    single = make_mppi_solver(model, SHARDED_MPPI, p["cost"])
    ms0 = init_mppi(model, SHARDED_MPPI, device=DEV)
    ms1, u01, J1 = single(ms0, p["sim"], eps=p["eps"])
    single_rates = timed_rates(lambda: single(ms0, p["sim"], eps=p["eps"]), *SHARDED_RATE)
    isolve = ilqr.make_ilqr_solver(model, p["icfg"], p["cost_xu"], quad_xu=p["quad_xu"])
    ref = [isolve(ilqr.unflatten_state(model, x0, p["s0"]), u)
           for x0, u in zip(p["x0s"], p["uss"])]
    torch.cuda.synchronize()

    torch.cuda.set_device(DEV)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
    try:
        one = sharded_run(model, pmesh.make_mesh())
    finally:
        dist.destroy_process_group()
    t_spawn = time.perf_counter()
    ranks = spawn_ranks(SHARDED_RANKS)
    say(f"{SHARDED_RANKS} gloo ranks spawned, run and joined in "
        f"{time.perf_counter() - t_spawn:.1f} s")
    for key, value in ranks[0].items():  # the replicated results
        if key not in ("mppi_rates", "ilqr_rates", "k1_replays") and not np.array_equal(
                ranks[1][key], value):
            raise AssertionError(f"sharded: rank 1's {key} differs from rank 0's")

    worst = 0.0
    for tag, r, w, replays in (
            ("1 rank, NCCL", one, 1, json.loads(str(one["k1_replays"]))),
            (f"{SHARDED_RANKS} ranks, gloo", ranks[0], SHARDED_RANKS,
             [x for rank in ranks for x in json.loads(str(rank["k1_replays"]))])):
        local_k = 3
        want = (local_k - 1) * 4 + np.arange(4)
        if not (np.array_equal(r["elite_best"], want) and float(r["elite_gmin"]) == 0.5):
            raise AssertionError(f"sharded {tag}: tie-break gave {r['elite_best']}")
        say(f"{tag}: global_elite's tie across ranks went to global index {local_k - 1}")
        within(f"{tag}: MPPI u0 against make_mppi_solver",
               max_err(torch.as_tensor(r["mppi_u0"]), u01.cpu()), 1e-5)
        within(f"{tag}: MPPI J against make_mppi_solver (J {float(J1):.6f}, relative)",
               abs(float(r["mppi_J"]) - float(J1)) / abs(float(J1)), 1e-4)
        within(f"{tag}: MPPI nominal against make_mppi_solver",
               max_err(torch.as_tensor(r["mppi_nominal"]), ms1.nominal.cpu()), 1e-5)
        c = json.loads(str(r["mppi_counts"]))
        shapes = sorted({x["K"] for x in replays})
        if shapes != [K // w]:
            raise AssertionError(f"sharded {tag}: K1 launched at K={shapes}, expected {K // w}")
        for x in replays:
            bad = {n: e for n, e in x["errs"].items() if not e <= TOL[n]}
            if bad or x["flips"]:
                raise AssertionError(f"sharded {tag}: K1 at K={x['K']} against the plain "
                                     f"substep: {bad}, {x['flips']} touch flips")
            worst = max(worst, max(x["errs"].values()))
        say(f"{tag}: {c['K1']} K1 launches a solve per rank at K={shapes[0]}, no other kernel, "
            f"no plain substep; each rank's first launch against the plain substep: "
            f"{json.dumps([x['errs'] for x in replays])}")
        ic = json.loads(str(r["ilqr_counts"]))
        per = SHARDED_B // w
        if ic != only(K1=10 * per, K3=11 * per, K4=10 * per):
            raise AssertionError(f"sharded {tag}: iLQR launches {ic} for {per} problems")
        us_err = max(max_err(torch.as_tensor(r["ilqr_us"][b]), x.us.cpu())
                     for b, x in enumerate(ref))
        cost_rel = max(abs(float(r["ilqr_costs"][b]) - float(x.cost)) / abs(float(x.cost))
                       for b, x in enumerate(ref))
        within(f"{tag}: iLQR controls against make_ilqr_solver, {SHARDED_B} problems", us_err,
               1e-5)
        within(f"{tag}: iLQR costs against make_ilqr_solver (relative)", cost_rel, 1e-5)
        tr = r["ilqr_traces"]
        if not (np.all(np.isfinite(tr)) and np.all(np.diff(tr, axis=1) <= 1e-5)):
            raise AssertionError(f"sharded {tag}: an iLQR cost trace rises or is not finite")
        say(f"{tag}: iLQR launches per problem K1 {ic['K1'] // per}, K3 {ic['K3'] // per}, "
            f"K4 {ic['K4'] // per}")
    say(f"MPPI solves/s (example 8's solve): single device {rate_line(single_rates)}; "
        f"1 rank over NCCL {rate_line(one['mppi_rates'])}; {SHARDED_RANKS} ranks over gloo "
        f"sharing this one card {rate_line(ranks[0]['mppi_rates'])}: two ranks on one card "
        f"measure the collectives' overhead, not multi-card scaling")
    say(f"iLQR problems/s (phase 7's solve, {SHARDED_B} problems): 1 rank over NCCL "
        f"{statistics.median(one['ilqr_rates']):.2f}, {SHARDED_RANKS} ranks over gloo sharing "
        f"the card {statistics.median(ranks[0]['ilqr_rates']):.2f} (two host processes "
        f"dispatching to one card: the collectives' overhead and the host's parallel "
        f"dispatch, not multi-card scaling)")
    seconds = time.perf_counter() - t0
    say(f"the sharded phase took {seconds:.1f} s")
    rc = json.loads(str(ranks[0]["ilqr_counts"]))
    per = SHARDED_B // SHARDED_RANKS
    return dict(
        k1=dict(launches_per_mppi_solve=json.loads(str(ranks[0]["mppi_counts"]))["K1"],
                K=K // SHARDED_RANKS, launches_per_ilqr_problem=rc["K1"] // per,
                max_abs_err=worst),
        k3=dict(launches_per_ilqr_problem=rc["K3"] // per),
        k4=dict(launches_per_ilqr_problem=rc["K4"] // per),
        seconds=seconds)


# phase 18: the robots' tables and asset generator, K5 against the autodiff
# oracle, and the zoo's train-and-ship pipeline at a toy size
ORACLE_K, ORACLE_SEED = 256, 0
ZOO_TOY = dict(episodes=2, ep_len=20, dagger_episodes=1, train_steps=50, evals=2)


def slice_assets(failures):
    """gen_assets.build_asset_xml of each robot's tables against the port's
    shipped file, byte for byte."""
    rows = {}
    for name, builder in _table_models().items():
        emitted = gen_assets.build_asset_xml(builder()).encode()
        with open(os.path.join(constants.ASSETS_DIR, f"{name}.xml"), "rb") as f:
            shipped = f.read()
        same = emitted == shipped
        log("slice", f"assets: {name}.xml emitted from the tables, {len(emitted)} bytes, "
                     f"{'byte-identical to' if same else 'DIFFERS from'} the shipped file")
        if not same:
            failures.append(f"assets: {name}.xml differs from the tables' emission")
        rows[name] = len(emitted)
    return rows


def slice_oracle(card, failures):
    """K5's bias forces (`rnea_terms_fast` on the card) against the
    Lagrangian autodiff oracle `bias_forces_ad` on the card at atol = rtol
    = 1e-4 (tests/test_dynamics.py:73-86's draws at K = 256), K5 against
    its plain version, and M(q) symmetric to 1e-5 and positive definite;
    the solo arm and the torso, with K5's launches counted."""
    rng = np.random.RandomState(ORACLE_SEED)
    inputs, out = {}, {}
    for name in ("solo_arm", "torso"):
        m = get_model(name)
        lo, hi = np.maximum(m.jnt_range[:, 0], -3), np.minimum(m.jnt_range[:, 1], 3)
        q = rng.uniform(lo, hi, (ORACLE_K, m.nq)).astype(np.float32)
        v = (rng.randn(ORACLE_K, m.nq) * 0.5).astype(np.float32)
        inputs[name] = (m, torch.as_tensor(q, device=DEV), torch.as_tensor(v, device=DEV))
    reset_counts()
    bias = {name: kin.rnea_terms_fast(m, q, v)[3] for name, (m, q, v) in inputs.items()}
    torch.cuda.synchronize()
    launches = counts()
    if launches != only(K5=len(inputs)):
        failures.append(f"oracle: launches {launches}, expected {len(inputs)} of K5")
    for name, (m, q, v) in inputs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oracle = kin.bias_forces_ad(m, q, v)
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        err = max_err(bias[name], oracle)
        ok = bool(torch.all((bias[name] - oracle).abs() <= 1e-4 + 1e-4 * oracle.abs()))
        M = kin.mass_matrix(m, q)
        sym = max_err(M, M.transpose(-1, -2))
        min_eig = float(torch.linalg.eigvalsh(M.double()).min())
        plain_err = k5_errors(f"oracle {name} K={ORACLE_K}", m, q.contiguous(), v.contiguous())
        ms = cuda_ms(lambda: rnea_cuda.rnea_terms_batched(m, q, v), 50)
        log("slice", f"oracle {name}: K5 bias vs bias_forces_ad at K={ORACLE_K}: max abs err "
                     f"{err:.3e}, within atol = rtol = 1e-4: {'yes' if ok else 'NO'}; M(q) "
                     f"asymmetry {sym:.3e} (<= 1e-5), smallest eigenvalue {min_eig:.3e} (> 0); "
                     f"K5 vs its plain version {plain_err:.3e}; K5 {ms:.4f} ms a launch, the "
                     f"oracle {oracle_s * 1e3:.1f} ms (torch.func, eager) [{card}]")
        if not (ok and sym <= 1e-5 and min_eig > 0):
            failures.append(f"oracle {name}: err {err:.3e}, asymmetry {sym:.3e}, "
                            f"smallest eigenvalue {min_eig:.3e}")
        out[name] = dict(max_abs_err_vs_oracle=err, max_abs_err=plain_err, ms=ms,
                         oracle_ms=oracle_s * 1e3, mass_matrix_asymmetry=sym)
    return dict(launches=launches["K5"], max_abs_err=max(r["max_abs_err"] for r in out.values()),
                robots=out)


def slice_zoo(card, failures):
    """`train_zoo --model solo_arm` at a toy size into a temporary --out-dir
    through the HDF5 logger (its in-memory stand-in where the host has no
    h5py), with its K1 launches counted (exactly those of its record,
    DAgger and eval episodes, and nothing else); the artifact loads through
    the port's loader with its meta complete, the first K1 launch of each
    shape replayed against the plain version, and the never-regress guard
    refuses to replace a better incumbent."""
    _, stand_in = h5py_stand_in()
    out_dir = tempfile.mkdtemp(prefix="kmanip_zoo_out_")
    t = ZOO_TOY
    argv = ["--model", "solo_arm", "--episodes", str(t["episodes"]), "--ep-len", str(t["ep_len"]),
            "--dagger-rounds", "1", "--dagger-episodes", str(t["dagger_episodes"]),
            "--train-steps", str(t["train_steps"]), "--evals", str(t["evals"]),
            "--out-dir", out_dir, "--data-dir", tempfile.mkdtemp(prefix="kmanip_zoo_data_")]
    eval_len = int(t["ep_len"] * 1.2)
    # record and DAgger: 5 settling steps, then ep_len steps of one expert
    # solve (2 iterations x 20 steps x 10 substeps) and one plant step;
    # each evaluate (two selection evals and the final one) is one batch
    expected = ((t["episodes"] + t["dagger_episodes"]) * (50 + t["ep_len"] * 410)
                + 3 * 10 * (5 + eval_len))
    lines = []
    with launches_of("zoo tools", expected) as run:
        summary = train_zoo.main(argv, log=lines.append)
    rows = replay_k1("slice zoo tools", run.k1)
    meta = summary["meta"]
    want_keys = {"arch", "model", "hidden", "depth", "trained_by", "device", "n_expert_episodes",
                 "dagger_rounds", "dagger_episodes_per_round", "expert_success_rate",
                 "eval_success_rate", "eval_episodes", "eval_ep_len", "spawn_range", "lift_dz",
                 "format_version"}
    path = summary["artifact"]
    policy, loaded = zoo.load_policy(path, device=DEV)
    s0 = init_state(get_model("solo_arm"), cube_pos=ex13.SPAWN_CENTER, device=DEV)
    complete = (summary["shipped"] and set(loaded) == want_keys and loaded == meta
                and loaded["trained_by"] == "gym_kmanip_torch/tools/train_zoo.py"
                and loaded["device"] == torch.cuda.get_device_name(0)
                and bool(torch.isfinite(policy(s0)).all()))
    # the guard: an incumbent that evaluated better stays
    art = zoo.load_artifact(path)
    better = dict({k_: v for k_, v in meta.items() if k_ != "format_version"},
                  eval_success_rate=float(meta["eval_success_rate"]) + 0.25)
    zoo.save_policy(path, art.params, art.stats, better)
    with open(path, "rb") as f:
        before = f.read()
    refused = not train_zoo.ship(path, zoo.bc_mlp_from_flax(art.params), art.stats, meta,
                                 log=lines.append)
    with open(path, "rb") as f:
        refused = refused and f.read() == before
    sec = summary["stage_seconds"]
    solves_per_s = summary["expert_solves"] / (sec["record"] + sec["dagger"])
    bc_per_s = summary["bc_steps"] / sec["train"]
    log("slice", f"zoo tools: train_zoo --model solo_arm at {t['episodes']} episodes of "
                 f"{t['ep_len']} steps, 1 DAgger round of {t['dagger_episodes']}, "
                 f"{t['train_steps']} BC steps, {t['evals']} evals in {sum(sec.values()):.1f} s "
                 f"({', '.join(f'{k_} {v:.2f} s' for k_, v in sec.items())}); "
                 f"{run.counts['K1']} K1 launches (expected {expected}), no other kernel; expert "
                 f"{solves_per_s:.2f} solves/s (record and DAgger, plant steps included), BC "
                 f"{bc_per_s:.1f} steps/s; expert rate {meta['expert_success_rate']:.2f}, "
                 f"selection {summary['selection_eval']:.2f}, eval {meta['eval_success_rate']:.2f}; "
                 f"artifact written, reloaded, meta complete: {'yes' if complete else 'NO'}; the "
                 f"guard kept a better incumbent: {'yes' if refused else 'NO'} "
                 f"({'an in-memory stand-in of h5py.File' if stand_in else 'h5py'}) [{card}]")
    if not complete:
        failures.append(f"zoo tools: artifact {path}, meta {loaded}")
    if not refused:
        failures.append("zoo tools: the guard replaced a better incumbent")
    return dict(launches=run.counts["K1"], max_abs_err=max(r["max_abs_err"] for r in rows),
                expert_solves_per_s=solves_per_s, bc_steps_per_s=bc_per_s, stage_seconds=sec,
                eval_success_rate=meta["eval_success_rate"], k1=rows)


def phase_slice():
    """Phase 18: the assets from the tables, K5 against the autodiff oracle,
    and the zoo pipeline at a toy size; every part runs, then returns (the
    K5 row, the K1 row, the failures): a failure fails the script after the
    kernels line (main)."""
    card = card_line()
    t0 = time.perf_counter()
    failures = []
    assets = slice_assets(failures)
    oracle = slice_oracle(card, failures)
    zoo_row = slice_zoo(card, failures)
    log("done", f"the slice phase took {time.perf_counter() - t0:.1f} s")
    oracle["asset_bytes"] = assets
    return oracle, zoo_row, failures


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
    t_new = time.perf_counter()
    k1["env"] = phase_env()
    k1["max_abs_err"] = max(k1["max_abs_err"], k1["env"]["max_abs_err"])
    phase_oracle()
    examples = phase_examples()
    for name, r in (("K1", k1), ("K4", k4)):
        r["examples"] = examples[name]
        r["max_abs_err"] = max([r["max_abs_err"]] + [e["max_abs_err"] for e in examples[name]])
    phase_lqr()
    no_staged_launch("the env, lqr, oracle and examples phases")
    log("done", f"the env, lqr, oracle and examples phases took "
                f"{time.perf_counter() - t_new:.1f} s")
    t_vec = time.perf_counter()
    k1["vec"] = phase_vec()
    k1["max_abs_err"] = max(k1["max_abs_err"], k1["vec"]["max_abs_err"])
    no_staged_launch("the vec phase")
    log("done", f"the vec phase took {time.perf_counter() - t_vec:.1f} s")
    k1["vision"] = phase_vision()
    k1["max_abs_err"] = max(k1["max_abs_err"], k1["vision"]["max_abs_err"])
    no_staged_launch("the vision phase")
    k1["learning"], missed = phase_learning()
    k1["max_abs_err"] = max(k1["max_abs_err"], k1["learning"]["max_abs_err"])
    no_staged_launch("the learning phase")
    sharded = phase_sharded(model)
    k1["sharded"], k3["sharded"], k4["sharded"] = sharded["k1"], sharded["k3"], sharded["k4"]
    k1["max_abs_err"] = max(k1["max_abs_err"], k1["sharded"]["max_abs_err"])
    no_staged_launch("the sharded phase")
    oracle, zoo_tools, slice_failures = phase_slice()
    missed = missed + slice_failures
    zoo_tools.pop("k1")
    staged["K5"]["oracle"], k1["zoo_tools"] = oracle, zoo_tools
    staged["K5"]["max_abs_err"] = max(staged["K5"]["max_abs_err"], oracle["max_abs_err"])
    k1["max_abs_err"] = max(k1["max_abs_err"], zoo_tools["max_abs_err"])

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
    log("done", f"all phases ran in {time.perf_counter() - t_start:.1f} s; "
                + (f"missed bars: {missed}" if missed else "every check passed"))
    # the row's own numbers are the main path's; a second path or shape
    # (K1's iLQR probes and the env's K=1 step, K1's and K4's shapes in the
    # examples, the sharded solves' launches, the torso, K7 at n = 20, K8's
    # other variants, the alternate builds) sits under a key of its own, as
    # does the device time
    # per launch that the profiler read on the staged route and in the iLQR
    # solve (profiled_ms), and on phase 8's inputs (device_ms)
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    extra = ("ilqr", "env", "vec", "vision", "learning", "sharded", "zoo_tools", "oracle",
             "examples", "torso", "n20", "variants", "k4_ms", "profiled_ms", "profiled_ms_k1500",
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
    print(card_line())
    if missed:
        # every phase ran and every kernel check passed; a bar of the
        # learning phase or a check of the slice phase failed, so the run
        # fails without the ok line
        sys.exit("chip_smoke: the learning or slice phase missed: " + "; ".join(missed))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
