"""Batched FK + RNEA as a hand-written CUDA kernel (csrc/rnea.cu).

Replaces the JAX package's Pallas TPU kernel
`gym_kmanip_tpu/ops/pallas_dynamics.py::rnea_terms_batched` and keeps its
signature and outputs. `rnea_terms_batched` launches the kernel for CUDA
tensors and counts the launch in `rnea_terms_batched.launches`; for CPU
tensors it runs the plain version, `rnea_terms_batched_reference`
(`ops/kinematics.rnea_terms`). Anything else raises.

Importing this module needs neither nvcc nor a GPU: the kernel is built
(ops/_build.py) at its first launch, or ahead of it by
`_build.build_libraries`.
"""

import ctypes
import functools

import torch

from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import _build
from gym_kmanip_torch.ops.substep_cuda import SUPPORTED, _check, _model_buffers

SOURCES = ("rnea.cu",)
HEADERS = ("staged_team.cuh", "substep.cuh", "substep_team.cuh", "team.cuh")
LIBRARY = ("rnea", SOURCES, HEADERS)

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load_library(*LIBRARY))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry point's argument types on a loaded library."""
    lib.kmanip_rnea.argtypes = [ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int,
                                _P, _P, _P, _P, _P, _P, _P]
    lib.kmanip_rnea.restype = ctypes.c_int
    return lib


def rnea_terms_batched(model: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor):
    """(xpos (K, nq, 3), xquat (K, nq, 4), axis_w (K, nq, 3), bias (K, nq))
    of qpos, qvel (K, nq), float32 and contiguous on one device."""
    if qpos.device != qvel.device:
        raise ValueError(f"qpos is on {qpos.device} and qvel on {qvel.device}")
    if qpos.device.type == "cpu":
        return rnea_terms_batched_reference(model, qpos, qvel)
    if qpos.device.type != "cuda":
        raise ValueError(f"rnea_terms_batched runs on CUDA or the CPU, not {qpos.device}")
    device = canonical_device(qpos.device)
    nq, T = model.nq, len(model.fingertips)
    if (nq, T) not in SUPPORTED:
        raise ValueError(f"the FK + RNEA kernel is built for (nq, fingertips) in {SUPPORTED}, "
                         f"not ({nq}, {T})")
    K = qpos.shape[0]
    _check("qpos", qpos, device, (K, nq))
    _check("qvel", qvel, device, (K, nq))
    with torch.cuda.device(device):
        model_f, model_i = _model_buffers(model, device)
        xpos = torch.empty((K, nq, 3), dtype=torch.float32, device=device)
        xquat = torch.empty((K, nq, 4), dtype=torch.float32, device=device)
        axis = torch.empty((K, nq, 3), dtype=torch.float32, device=device)
        bias = torch.empty((K, nq), dtype=torch.float32, device=device)
        rc = _library().kmanip_rnea(
            nq, T, model_f.data_ptr(), model_i.data_ptr(), K, qpos.data_ptr(), qvel.data_ptr(),
            xpos.data_ptr(), xquat.data_ptr(), axis.data_ptr(), bias.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"FK + RNEA kernel launch failed: cudaError_t {rc}")
    rnea_terms_batched.launches += 1
    return xpos, xquat, axis, bias


rnea_terms_batched.launches = 0


def rnea_terms_batched_reference(model: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor):
    """The plain PyTorch version of `rnea_terms_batched`, on any device."""
    from gym_kmanip_torch.ops.kinematics import rnea_terms

    return rnea_terms(model, qpos, qvel)
