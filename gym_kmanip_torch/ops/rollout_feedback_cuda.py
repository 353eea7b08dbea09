"""The iLQR feedback rollout for B step sizes as one hand-written CUDA
kernel (csrc/rollout_feedback.cu).

Replaces the JAX package's Pallas TPU kernel
`gym_kmanip_tpu/ops/pallas_substep.py::rollout_feedback` and keeps its
signature and outputs: for each step size alpha_b, H control steps of

    u = clip(us_nom[h] + alpha_b ks[h] + Ks[h] (x - xs_nom[h]), ctrl_range)

then n_substeps contact-free substeps with implicit actuation, on the
reduced state x = [qpos, qvel] with the cube reset to `cube0` every step.
`rollout_feedback` launches the kernel for CUDA tensors and counts the
launch in `rollout_feedback.launches`; for CPU tensors it runs the plain
version, `rollout_feedback_reference`. Anything else raises.

Importing this module needs neither nvcc nor a GPU: the kernel is built
(ops/_build.py) at its first launch, or ahead of it by
`_build.build_libraries`.
"""

import ctypes
import functools

import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.engine import _substep_torch
from gym_kmanip_torch.dynamics.state import SimState
from gym_kmanip_torch.models import canonical_device, model_tensors
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import _build
from gym_kmanip_torch.ops.substep_cuda import SUPPORTED, _check, _model_buffers

SOURCES = ("rollout_feedback.cu",)
HEADERS = ("feedback_warp.cuh", "substep.cuh", "substep_team.cuh", "team.cuh")
LIBRARY = ("rollout_feedback", SOURCES, HEADERS)

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load_library(*LIBRARY))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry point's argument types on a loaded library."""
    lib.kmanip_rollout_feedback.argtypes = [
        ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ]
    lib.kmanip_rollout_feedback.restype = ctypes.c_int
    return lib


def rollout_feedback(model: RobotModel, x0: torch.Tensor, cube0: torch.Tensor,
                     xs_nom: torch.Tensor, us_nom: torch.Tensor, ks: torch.Tensor,
                     Ks: torch.Tensor, alphas: torch.Tensor, n_substeps: int = 1,
                     dt: float = k.CONTROL_TIMESTEP):
    """One launch for the whole (B step sizes, H steps) feedback rollout.

    x0 (2nq,) reduced start state, cube0 (13,) the cube's pinned state
    (pos, quat, linvel, angvel), xs_nom (H, 2nq), us_nom (H, nu), ks
    (H, nu), Ks (H, nu, 2nq), alphas (B,); float32, contiguous, one
    device. Returns (xs (B, H, 2nq) post-step states, us (B, H, nu) the
    controls as applied)."""
    tensors = (x0, cube0, xs_nom, us_nom, ks, Ks, alphas)
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs are on several devices: {sorted(map(str, devices))}")
    device = x0.device
    if device.type == "cpu":
        return rollout_feedback_reference(model, *tensors, n_substeps=n_substeps, dt=dt)
    if device.type != "cuda":
        raise ValueError(f"rollout_feedback runs on CUDA or the CPU, not {device}")
    device = canonical_device(device)
    nq, nu, T = model.nq, model.nu, len(model.fingertips)
    if (nq, T) not in SUPPORTED:
        raise ValueError(f"the kernel is built for (nq, fingertips) in {SUPPORTED}, "
                         f"not ({nq}, {T})")
    if xs_nom.dim() != 2 or alphas.dim() != 1 or n_substeps < 1:
        raise ValueError(f"xs_nom must be (H, 2nq), alphas (B,) and n_substeps >= 1, got "
                         f"{tuple(xs_nom.shape)}, {tuple(alphas.shape)}, {n_substeps}")
    H, n, B = xs_nom.shape[0], 2 * nq, alphas.shape[0]
    for name, x, shape in (("x0", x0, (n,)), ("cube0", cube0, (13,)),
                           ("xs_nom", xs_nom, (H, n)), ("us_nom", us_nom, (H, nu)),
                           ("ks", ks, (H, nu)), ("Ks", Ks, (H, nu, n)),
                           ("alphas", alphas, (B,))):
        _check(name, x, device, shape)

    with torch.cuda.device(device):
        model_f, model_i = _model_buffers(model, device)
        t = model_tensors(model, device)
        xs = torch.empty((B, H, n), dtype=torch.float32, device=device)
        us = torch.empty((B, H, nu), dtype=torch.float32, device=device)
        rc = _library().kmanip_rollout_feedback(
            nq, T, model_f.data_ptr(), model_i.data_ptr(), float(dt), int(n_substeps), B, H,
            *(x.data_ptr() for x in (alphas, x0, xs_nom, us_nom, ks, Ks,
                                     t.ctrl_lo, t.ctrl_hi, xs, us)),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rollout_feedback kernel launch failed: cudaError_t {rc}")
    rollout_feedback.launches += 1
    return xs, us


rollout_feedback.launches = 0


def rollout_feedback_reference(model: RobotModel, x0, cube0, xs_nom, us_nom, ks, Ks, alphas,
                               n_substeps: int = 1, dt: float = k.CONTROL_TIMESTEP):
    """The plain PyTorch version of `rollout_feedback`, on any device: the
    same control law and loop over the plain substep."""
    t = model_tensors(model, x0.device)
    nq, B = model.nq, alphas.shape[0]
    x = x0.expand(B, -1)
    cube = cube0.expand(B, -1)
    xs, us = [], []
    for h in range(xs_nom.shape[0]):
        u = us_nom[h] + alphas[:, None] * ks[h] + (x - xs_nom[h]) @ Ks[h].transpose(0, 1)
        u = torch.clamp(u, t.ctrl_lo, t.ctrl_hi)
        s = SimState(qpos=x[:, :nq], qvel=x[:, nq:], ctrl=u, cube_pos=cube[:, :3],
                     cube_quat=cube[:, 3:7], cube_linvel=cube[:, 7:10],
                     cube_angvel=cube[:, 10:13], time=x.new_zeros(B))
        for _ in range(n_substeps):
            s, _ = _substep_torch(model, s, dt, False, True)
        x = torch.cat([s.qpos, s.qvel], dim=-1)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)
