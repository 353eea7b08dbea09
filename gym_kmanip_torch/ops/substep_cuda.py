"""The physics substep as a hand-written CUDA kernel (csrc/substep.cu).

Replaces the JAX package's Pallas TPU kernel
`gym_kmanip_tpu/ops/pallas_substep.py::substep_batched` and keeps its
signature and outputs. `substep_batched` launches the kernel for a CUDA
tensor and counts the launch in `substep_batched.launches`; for a CPU
tensor it runs the plain version, `substep_batched_reference`. Anything
else raises.

Importing this module needs neither nvcc nor a GPU: the kernel is built
(ops/_build.py) at its first launch, or ahead of it by
`_build.build_libraries`.
"""

import ctypes
import functools

import numpy as np
import torch

from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import _build

SOURCES = ("substep.cu",)
HEADERS = ("substep.cuh", "substep_team.cuh", "team.cuh")
LIBRARY = ("substep", SOURCES, HEADERS)
# (nq, fingertips) the kernel is instantiated for: solo arm; dual arm and torso
SUPPORTED = ((10, 2), (20, 4))

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load_library(*LIBRARY))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry points' argument types on a loaded library."""
    lib.kmanip_substep.argtypes = [
        ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ]
    lib.kmanip_substep.restype = ctypes.c_int
    lib.kmanip_substep_model_sizes.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.kmanip_substep_model_sizes.restype = ctypes.c_int
    return lib


def pack_model(model: RobotModel):
    """The model's constants in the kernel's packed layout (csrc/substep.cuh,
    ModelView): (float32 array, int32 array)."""
    nq, nu = model.nq, model.nu
    kp = np.zeros(nq)
    kp[:nu] = model.actuator_kp
    flo = np.full(nq, -np.inf)
    fhi = np.full(nq, np.inf)
    flo[:nu] = model.force_range[:, 0]
    fhi[:nu] = model.force_range[:, 1]
    tips = model.fingertips
    floats = np.concatenate([
        np.ravel(model.jnt_pos), np.ravel(model.jnt_quat), model.body_mass,
        np.ravel(model.body_com), np.ravel(model.body_inertia), model.armature,
        kp, flo, fhi, model.jnt_range[:, 0], model.jnt_range[:, 1],
        model.jnt_frictionloss,
        np.ravel([t.pos for t in tips]), [t.radius for t in tips],
    ]).astype(np.float32)
    ints = np.concatenate([
        model.parent, model.jnt_type, np.ravel(model.ancestors),
        [t.parent for t in tips], [nu],
    ]).astype(np.int32)
    return floats, ints


def _model_buffers(model: RobotModel, device: torch.device):
    """Packed model buffers on `device`, built once per (model, device)."""
    key = ("substep_cuda", str(device))
    bufs = model.cache.get(key)
    if bufs is None:
        floats, ints = pack_model(model)
        n_f, n_i = ctypes.c_int(), ctypes.c_int()
        rc = _library().kmanip_substep_model_sizes(
            model.nq, len(model.fingertips), ctypes.byref(n_f), ctypes.byref(n_i)
        )
        if rc != 0 or (n_f.value, n_i.value) != (floats.size, ints.size):
            raise RuntimeError(
                f"packed model sizes {floats.size}, {ints.size} do not match "
                f"the kernel's {n_f.value}, {n_i.value}"
            )
        bufs = (torch.as_tensor(floats, device=device),
                torch.as_tensor(ints, device=device))
        model.cache[key] = bufs
    return bufs


def _check(name, x, device, shape):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def substep_batched(model: RobotModel, dt: float, contact: bool,
                    implicit_actuation: bool, qpos: torch.Tensor,
                    qvel: torch.Tensor, ctrl: torch.Tensor, cube13: torch.Tensor):
    """One substep for the whole rollout batch.

    qpos, qvel (K, nq), ctrl (K, nu), cube13 (K, 13) = (pos, quat wxyz,
    linvel, angvel), float32 and contiguous. Returns (qpos', qvel',
    cube13', touch (K, T) bool, xpos (K, nq, 3), xquat (K, nq, 4)); the
    frames are the PRE-step frames."""
    devices = {x.device for x in (qpos, qvel, ctrl, cube13)}
    if len(devices) != 1:
        raise ValueError(f"inputs are on several devices: {sorted(map(str, devices))}")
    if qpos.device.type == "cpu":
        return substep_batched_reference(
            model, dt, contact, implicit_actuation, qpos, qvel, ctrl, cube13
        )
    if qpos.device.type != "cuda":
        raise ValueError(f"substep_batched runs on CUDA or the CPU, not {qpos.device}")
    device = canonical_device(qpos.device)
    K = qpos.shape[0]
    nq, nu, T = model.nq, model.nu, len(model.fingertips)
    if (nq, T) not in SUPPORTED:
        raise ValueError(
            f"the substep kernel is built for (nq, fingertips) in {SUPPORTED}, "
            f"not ({nq}, {T})"
        )
    _check("qpos", qpos, device, (K, nq))
    _check("qvel", qvel, device, (K, nq))
    _check("ctrl", ctrl, device, (K, nu))
    _check("cube13", cube13, device, (K, 13))

    with torch.cuda.device(device):
        model_f, model_i = _model_buffers(model, device)
        qo = torch.empty_like(qpos)
        vo = torch.empty_like(qvel)
        co = torch.empty_like(cube13)
        touch = torch.empty((K, T), dtype=torch.bool, device=device)
        xpos = torch.empty((K, nq, 3), dtype=torch.float32, device=device)
        xquat = torch.empty((K, nq, 4), dtype=torch.float32, device=device)
        rc = _library().kmanip_substep(
            nq, T, model_f.data_ptr(), model_i.data_ptr(), float(dt),
            int(bool(contact)), int(bool(implicit_actuation)), K,
            qpos.data_ptr(), qvel.data_ptr(), ctrl.data_ptr(), cube13.data_ptr(),
            qo.data_ptr(), vo.data_ptr(), co.data_ptr(), touch.data_ptr(),
            xpos.data_ptr(), xquat.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"substep kernel launch failed: cudaError_t {rc}")
    substep_batched.launches += 1
    return qo, vo, co, touch, xpos, xquat


substep_batched.launches = 0


def random_inputs(model: RobotModel, K: int, seed: int):
    """Seeded numpy inputs (qpos, qvel, ctrl, cube13), float32, for checking
    the kernel against its plain version: joints near home, and the cube
    either among the fingertips (even rows, so contacts are exercised) or
    near the spawn point (odd rows)."""
    from gym_kmanip_torch.dynamics.engine import _tips_from_frames
    from gym_kmanip_torch.ops.kinematics import fk

    nq, nu = model.nq, model.nu
    rng = np.random.RandomState(seed)
    home = torch.as_tensor(model.home_qpos, dtype=torch.float32)
    tips = _tips_from_frames(model, *fk(model, home)[:2]).numpy()
    qpos = np.tile(model.home_qpos, (K, 1)) + rng.randn(K, nq) * 0.05
    qvel = rng.randn(K, nq) * 0.3
    ctrl = np.tile(model.home_qpos[:nu], (K, 1)) + rng.randn(K, nu) * 0.05
    cube_pos = np.where(
        (np.arange(K) % 2 == 0)[:, None],
        tips[: max(len(tips) // 2, 1)].mean(0) + rng.randn(K, 3) * 0.01,
        np.array([0.23, 0.52, 0.62]) + rng.randn(K, 3) * 0.01,
    )
    quat = rng.randn(K, 4) * 0.05 + np.array([1.0, 0, 0, 0])
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    cube13 = np.concatenate(
        [cube_pos, quat, rng.randn(K, 3) * 0.1, rng.randn(K, 3) * 0.3], axis=1
    )
    return tuple(a.astype(np.float32) for a in (qpos, qvel, ctrl, cube13))


def substep_batched_reference(model: RobotModel, dt: float, contact: bool,
                              implicit_actuation: bool, qpos, qvel, ctrl, cube13):
    """The plain PyTorch version of `substep_batched`, on the same I/O
    layout (a thin call into `engine._substep_torch`), on any device."""
    from gym_kmanip_torch.dynamics.engine import _substep_torch
    from gym_kmanip_torch.dynamics.state import SimState

    s = SimState(
        qpos=qpos, qvel=qvel, ctrl=ctrl,
        cube_pos=cube13[:, :3], cube_quat=cube13[:, 3:7],
        cube_linvel=cube13[:, 7:10], cube_angvel=cube13[:, 10:13],
        time=qpos.new_zeros(qpos.shape[0]),
    )
    s2, (touch, xpos, xquat) = _substep_torch(model, s, dt, contact, implicit_actuation)
    cube = torch.cat([s2.cube_pos, s2.cube_quat, s2.cube_linvel, s2.cube_angvel], -1)
    return s2.qpos, s2.qvel, cube, touch, xpos, xquat
