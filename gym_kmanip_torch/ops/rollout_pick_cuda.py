"""The whole (K, H) rollout and the cube-pick cost as one hand-written CUDA
kernel (csrc/rollout_pick.cu).

Replaces the JAX package's Pallas TPU kernel
`gym_kmanip_tpu/ops/pallas_substep.py::rollout_pick_costs` and keeps its
signature and output: the (K,) total pick cost of K control sequences from
one shared start state. `rollout_pick_costs` launches the kernel for CUDA
tensors and counts the launch in `rollout_pick_costs.launches`, and in
`rollout_pick_costs.pair_launches` where it ran two rollouts a warp
(`team_lanes`); for CPU tensors it runs the plain version,
`rollout_pick_costs_reference` (the port's `rollout` with
`cube_pick_cost`). Anything else raises.

Importing this module needs neither nvcc nor a GPU: the kernel is built
(ops/_build.py) at its first launch, or ahead of it by
`_build.build_libraries`.
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.engine import _substep_torch
from gym_kmanip_torch.dynamics.state import SimState
from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.mpc.cost import CostParams, cube_pick_cost
from gym_kmanip_torch.mpc.rollout import rollout
from gym_kmanip_torch.ops import _build
from gym_kmanip_torch.ops.substep_cuda import SUPPORTED, _check, _model_buffers
from gym_kmanip_torch.utils.profiling import span

SOURCES = ("rollout_pick.cu",)
HEADERS = ("rollout.cuh", "substep.cuh", "substep_team.cuh", "team.cuh")
LIBRARY = ("rollout_pick", SOURCES, HEADERS)

_P = ctypes.c_void_p
# Warp schedulers per SM on the cards the library is built for (sm_90: four
# sub-partitions, each issuing for its own warps).
SCHEDULERS_PER_SM = 4


class PickCostSpec(NamedTuple):
    """The weights of `cube_pick_cost` (mpc/cost.py) and which gripper
    sites it rewards, as the fused kernel takes them (host values)."""

    w_vel: float = float(k.REWARD_VEL_PENALTY)
    w_grip_dist: float = float(k.REWARD_GRIP_DIST)
    w_touch: float = float(k.REWARD_TOUCH_CUBE)
    w_lift: float = float(k.REWARD_LIFT_CUBE)
    w_ctrl: float = 1e-3
    use_right: bool = True
    use_left: bool = False


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load_library(*LIBRARY))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry points' argument types on a loaded library, and
    gives it `pair_above`: (nq, fingertips, contact, implicit, device index)
    -> the K above which a launch runs on half-warp teams (`team_lanes`)."""
    lib.kmanip_rollout_pick.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        _P, _P, _P, _P,
    ]
    lib.kmanip_rollout_pick.restype = ctypes.c_int
    lib.kmanip_rollout_pick_resident.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.kmanip_rollout_pick_resident.restype = ctypes.c_int
    lib.pair_above = {}
    return lib


def resident(lib: ctypes.CDLL, nq: int, T: int, lanes: int, contact: bool, implicit: bool):
    """(teams, SMs): how many teams of `lanes` lanes of the kernel for
    (nq, T, contact, implicit) the current device holds at once, and its
    SM count (csrc/rollout_pick.cu, kmanip_rollout_pick_resident)."""
    teams, sms = ctypes.c_int(), ctypes.c_int()
    rc = lib.kmanip_rollout_pick_resident(nq, T, lanes, int(contact), int(implicit),
                                          ctypes.byref(teams), ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"reading the rollout_pick kernel's occupancy failed: cudaError_t {rc}")
    return teams.value, sms.value


def _pair_above(lib, nq, T, contact, implicit) -> int:
    """The K above which the warp team would put more than one warp on a
    warp scheduler, in one wave or in several: the warp team's resident
    teams per SM, at most one per scheduler, times the SMs. On an H100
    (12 resident, 132 SMs) that is 528, where the two widths' times cross
    (PERF.md §6)."""
    teams, sms = resident(lib, nq, T, 32, contact, implicit)
    return min(teams // sms, SCHEDULERS_PER_SM) * sms


def team_lanes(lib: ctypes.CDLL, model: RobotModel, K: int, contact: bool, implicit: bool,
               device: torch.device) -> int:
    """Lanes per team for a launch of K rollouts on `device`, the current
    device: 16, two rollouts a warp, at solo width (nq <= 16) once K is
    above `_pair_above` (read once per library, model, modes and device);
    32 otherwise. Alone on a scheduler the warp team's chain is the
    shorter; sharing one, the warp team leaves most of its issue slots to
    idle lanes, and two half-warp teams a warp do the same work in fewer
    warp instructions (PERF.md §6)."""
    if model.nq > 16:
        return 32
    key = (model.nq, len(model.fingertips), contact, implicit, device.index)
    above = lib.pair_above.get(key)
    if above is None:
        above = lib.pair_above[key] = _pair_above(lib, *key[:4])
    return 16 if K > above else 32


def spec_arrays(model: RobotModel, spec: PickCostSpec):
    """The spec in the kernel's layout (csrc/rollout_pick.cu): float32
    [5 weights, two site offsets] and int32 [n_sites, two site parents]."""
    floats = np.zeros(11, np.float32)
    floats[:5] = (spec.w_vel, spec.w_grip_dist, spec.w_touch, spec.w_lift, spec.w_ctrl)
    ints = np.zeros(3, np.int32)
    for use, name in ((spec.use_right, "eer_site"), (spec.use_left, "eel_site")):
        if use:
            site = model.sites[model.site_index(name)]
            floats[5 + 3 * ints[0]: 8 + 3 * ints[0]] = site.pos
            ints[1 + ints[0]] = site.parent
            ints[0] += 1
    return floats, ints


def rollout_pick_costs(model: RobotModel, ctrl_seqs: torch.Tensor, state0: SimState,
                       spec: PickCostSpec = PickCostSpec(), n_substeps: int = 1,
                       dt: float = k.CONTROL_TIMESTEP, contact: bool = True,
                       implicit_actuation: bool = True) -> torch.Tensor:
    """Total pick cost (K,) of the control sequences ctrl_seqs (K, H, nu)
    rolled out from the unbatched state0, n_substeps substeps of dt per
    control step. float32, contiguous, all on one device. The team width
    follows K (`team_lanes`), which changes no total. Under a
    `torch.profiler` session the CUDA branch, from the checks to the
    launch's return, is the span `k2.wrapper` (`utils.profiling.span`)."""
    device = ctrl_seqs.device
    devices = {x.device for x in state0} | {device}
    if len(devices) != 1:
        raise ValueError(f"inputs are on several devices: {sorted(map(str, devices))}")
    if device.type == "cpu":
        return rollout_pick_costs_reference(model, ctrl_seqs, state0, spec, n_substeps,
                                            dt, contact, implicit_actuation)
    if device.type != "cuda":
        raise ValueError(f"rollout_pick_costs runs on CUDA or the CPU, not {device}")
    with span("k2.wrapper"):
        device = canonical_device(device)
        nq, nu, T = model.nq, model.nu, len(model.fingertips)
        if (nq, T) not in SUPPORTED:
            raise ValueError(f"the kernel is built for (nq, fingertips) in {SUPPORTED}, "
                             f"not ({nq}, {T})")
        if ctrl_seqs.dim() != 3 or n_substeps < 1:
            raise ValueError(f"ctrl_seqs must be (K, H, nu) and n_substeps >= 1, got "
                             f"{tuple(ctrl_seqs.shape)} and {n_substeps}")
        K, H = ctrl_seqs.shape[:2]
        _check("ctrl_seqs", ctrl_seqs, device, (K, H, nu))
        for name, x, shape in zip(SimState._fields, state0,
                                  ((nq,), (nq,), (nu,), (3,), (4,), (3,), (3,), ())):
            _check(f"state0.{name}", x, device, shape)

        spec_f, spec_i = spec_arrays(model, spec)
        contact, implicit_actuation = bool(contact), bool(implicit_actuation)
        lib = _library()
        with torch.cuda.device(device):
            model_f, model_i = _model_buffers(model, device)
            lanes = team_lanes(lib, model, K, contact, implicit_actuation, device)
            start = torch.cat([state0.qpos, state0.qvel, state0.cube_pos, state0.cube_quat,
                               state0.cube_linvel, state0.cube_angvel])
            cost = torch.empty(K, dtype=torch.float32, device=device)
            rc = lib.kmanip_rollout_pick(
                nq, T, lanes, model_f.data_ptr(), model_i.data_ptr(), float(dt),
                int(contact), int(implicit_actuation), int(n_substeps), K, H,
                spec_f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                spec_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                ctrl_seqs.data_ptr(), start.data_ptr(), cost.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream,
            )
    if rc != 0:
        raise RuntimeError(f"rollout_pick kernel launch failed: cudaError_t {rc}")
    rollout_pick_costs.launches += 1
    if lanes == 16:
        rollout_pick_costs.pair_launches += 1
    return cost


rollout_pick_costs.launches = 0
rollout_pick_costs.pair_launches = 0  # the launches on half-warp teams


def rollout_pick_costs_reference(model: RobotModel, ctrl_seqs, state0, spec=PickCostSpec(),
                                 n_substeps: int = 1, dt: float = k.CONTROL_TIMESTEP,
                                 contact: bool = True, implicit_actuation: bool = True):
    """The plain PyTorch version of `rollout_pick_costs`, on any device: the
    port's `rollout` with `cube_pick_cost` through the plain substep."""
    params = CostParams(w_vel=spec.w_vel, w_grip_dist=spec.w_grip_dist,
                        w_touch=spec.w_touch, w_lift=spec.w_lift, w_ctrl=spec.w_ctrl)

    def cost(s, aux, u):
        return cube_pick_cost(model, s, aux, u, params, use_right=spec.use_right,
                              use_left=spec.use_left)

    total, _ = rollout(model, state0, ctrl_seqs, cost, n_substeps=n_substeps, dt=dt,
                       contact=contact, implicit_actuation=implicit_actuation,
                       substep_fn=_substep_torch)
    return total
