"""Batched penalty contacts as a hand-written CUDA kernel
(csrc/contacts.cu).

Replaces the JAX package's Pallas TPU kernel
`gym_kmanip_tpu/ops/pallas_contacts.py::contact_forces_batched` and keeps
its signature and outputs. `contact_forces_batched` launches the kernel for
CUDA tensors and counts the launch in `contact_forces_batched.launches`;
for CPU tensors it runs the plain version, `contact_forces_batched_reference`
(`dynamics/contacts.contact_forces` with the model's fingertip radii).
Anything else raises.

Importing this module needs neither nvcc nor a GPU: the kernel is built
(ops/_build.py) at its first launch, or ahead of it by
`_build.build_libraries`.
"""

import ctypes
import functools

import torch

from gym_kmanip_torch.models import canonical_device, model_tensors
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import _build
from gym_kmanip_torch.ops.substep_cuda import SUPPORTED, _check, _model_buffers

SOURCES = ("contacts.cu",)
HEADERS = ("staged_team.cuh", "substep.cuh", "substep_team.cuh", "team.cuh")
LIBRARY = ("contacts", SOURCES, HEADERS)

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load_library(*LIBRARY))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry point's argument types on a loaded library."""
    lib.kmanip_contacts.argtypes = [ctypes.c_int, ctypes.c_int, _P, ctypes.c_int] + [_P] * 12
    lib.kmanip_contacts.restype = ctypes.c_int
    return lib


def contact_forces_batched(model: RobotModel, tip_pos, tip_vel, cube_pos, cube_quat,
                           cube_linvel, cube_angvel):
    """ContactOut (force_cube (K, 3), torque_cube (K, 3), tip_forces
    (K, T, 3), touch_tip (K, T) bool, touch_table (K,) bool) of tip_pos,
    tip_vel (K, T, 3), cube_pos (K, 3), cube_quat (K, 4), cube_linvel,
    cube_angvel (K, 3), float32 and contiguous on one device."""
    from gym_kmanip_torch.dynamics.contacts import ContactOut

    inputs = (tip_pos, tip_vel, cube_pos, cube_quat, cube_linvel, cube_angvel)
    devices = {x.device for x in inputs}
    if len(devices) != 1:
        raise ValueError(f"inputs are on several devices: {sorted(map(str, devices))}")
    if tip_pos.device.type == "cpu":
        return contact_forces_batched_reference(model, *inputs)
    if tip_pos.device.type != "cuda":
        raise ValueError(f"contact_forces_batched runs on CUDA or the CPU, not {tip_pos.device}")
    device = canonical_device(tip_pos.device)
    nq, T = model.nq, len(model.fingertips)
    if (nq, T) not in SUPPORTED:
        raise ValueError(f"the contact kernel is built for (nq, fingertips) in {SUPPORTED}, "
                         f"not ({nq}, {T})")
    K = tip_pos.shape[0]
    for name, x, shape in (("tip_pos", tip_pos, (K, T, 3)), ("tip_vel", tip_vel, (K, T, 3)),
                           ("cube_pos", cube_pos, (K, 3)), ("cube_quat", cube_quat, (K, 4)),
                           ("cube_linvel", cube_linvel, (K, 3)),
                           ("cube_angvel", cube_angvel, (K, 3))):
        _check(name, x, device, shape)
    with torch.cuda.device(device):
        model_f, _ = _model_buffers(model, device)
        out = ContactOut(
            force_cube=torch.empty((K, 3), dtype=torch.float32, device=device),
            torque_cube=torch.empty((K, 3), dtype=torch.float32, device=device),
            tip_forces=torch.empty((K, T, 3), dtype=torch.float32, device=device),
            touch_tip=torch.empty((K, T), dtype=torch.bool, device=device),
            touch_table=torch.empty((K,), dtype=torch.bool, device=device),
        )
        rc = _library().kmanip_contacts(
            nq, T, model_f.data_ptr(), K,
            *(x.data_ptr() for x in inputs), *(x.data_ptr() for x in out),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"contact kernel launch failed: cudaError_t {rc}")
    contact_forces_batched.launches += 1
    return out


contact_forces_batched.launches = 0


def contact_forces_batched_reference(model: RobotModel, tip_pos, tip_vel, cube_pos, cube_quat,
                                     cube_linvel, cube_angvel):
    """The plain PyTorch version of `contact_forces_batched`, on any
    device."""
    from gym_kmanip_torch.dynamics.contacts import contact_forces

    radius = model_tensors(model, tip_pos.device).tip_radius
    return contact_forces(tip_pos, tip_vel, radius, cube_pos, cube_quat, cube_linvel,
                          cube_angvel)
