"""Native (C++) host IK: build on demand, load with ctypes.

Port of `gym_kmanip_tpu/native/__init__.py`. `csrc/ik_native.cpp` (a copy
of the JAX package's source) is the float64 IK pipeline of
`solvers/ik_host` compiled: FK -> the reference residual / Jacobian -> the
scipy-semantics TRF, as a dependency-free shared library. It is built with
g++ at first use into the git-ignored `gym_kmanip_torch/_build/`, keyed by
a hash of the source, written atomically (a temporary file, then a
rename), and loaded with ctypes.

`solve_ik_native` keeps `ik_host._solve_np`'s contract (out-of-bounds warm
start, NaN fallback, joint-range clip, qpos scribble, float32 outputs).
If g++ is missing or the build or load fails, `available()` is False and
`ik_host.solve_host` stays on the numpy twin: the native path is a fast
path, never a requirement.
"""

import ctypes
import hashlib
import os
import threading
from typing import Optional

import numpy as np

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.ops._build import BUILD_DIR, CSRC_DIR, compile_to

_SRC = os.path.join(CSRC_DIR, "ik_native.cpp")
_ABI_VERSION = 1

# the C++ solver's capacity (ik_native.cpp's NQMAX / NMAX): a larger
# problem takes the numpy path
NQMAX = 32
NMAX = 12

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_load_error: Optional[str] = None


def fits(model, q_mask) -> bool:
    """True if (model, mask) is within the C++ solver's compiled capacity."""
    return int(model.nq) <= NQMAX and 1 <= len(list(q_mask)) <= NMAX


def library_path() -> str:
    """The built library, compiling ik_native.cpp with g++ if needed."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"ik_native_{tag}.so")
    if not os.path.exists(so):
        compile_to(so, ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"], [_SRC])
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, _load_error
    if _load_attempted:
        return _lib
    with _lock:
        if _load_attempted:
            return _lib
        try:
            lib = ctypes.CDLL(library_path())
            lib.kmanip_ik_abi_version.restype = ctypes.c_int
            if lib.kmanip_ik_abi_version() != _ABI_VERSION:
                raise RuntimeError("ABI version mismatch")
            c_dp = ctypes.POINTER(ctypes.c_double)
            c_ip = ctypes.POINTER(ctypes.c_int)
            c_up = ctypes.POINTER(ctypes.c_ubyte)
            lib.kmanip_ik_solve.restype = ctypes.c_int
            lib.kmanip_ik_solve.argtypes = [
                ctypes.c_int, c_ip, c_ip, c_dp, c_dp,          # model tree
                ctypes.c_int, c_dp, c_dp, c_up,                 # site
                ctypes.c_int, c_ip, c_dp, c_dp,                 # mask/bounds
                c_dp, c_dp, c_dp, c_dp, c_dp,                   # problem
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double,               # weights
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_int,                                   # tolerances
                c_dp, c_dp,                                     # outputs
            ]
            _lib = lib
        except (OSError, RuntimeError, AttributeError) as e:  # any: the numpy path
            _load_error = f"{type(e).__name__}: {e}"
            _lib = None
            import warnings

            warnings.warn(f"gym_kmanip_torch: native IK unavailable ({_load_error}); using "
                          "the numpy solver", RuntimeWarning, stacklevel=3)
        _load_attempted = True
    return _lib


def available() -> bool:
    """True iff the native solver built and loaded."""
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the native solver is unavailable (None if it loaded)."""
    _load()
    return _load_error


def _c64(a):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _c32i(a):
    a = np.ascontiguousarray(a, dtype=np.int32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def solve_ik_native(qpos_full, goal_pos, goal_orn, q_home_full, q_prev_full, *,
                    model, q_mask, site_name, ftol=1e-8, xtol=1e-8, gtol=1e-8,
                    return_status=False):
    """`ik_host._solve_np` backed by the C++ solver: the same (q_sol,
    q_scribble) float32 outputs. An out-of-bounds warm start short-circuits
    (scipy raises before evaluating; the reference keeps the warm start),
    a non-finite result falls back to the warm start, and the solution is
    clipped to the joint range. `return_status` appends the TRF's
    termination status (scipy's: 0 max_nfev, 1 gtol, 2 ftol, 3 xtol, 4
    both; -1 for an out-of-range warm start, which is not solved)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native IK is unavailable: {_load_error}")
    qpos_full = np.asarray(qpos_full, np.float64)
    mask = list(q_mask)
    lo = np.asarray(model.jnt_range[mask, 0], np.float64)
    hi = np.asarray(model.jnt_range[mask, 1], np.float64)
    q0 = qpos_full[mask]
    if np.any((q0 < lo) | (q0 > hi)):
        out = (np.clip(q0, lo, hi).astype(np.float32), q0.astype(np.float32))
        return out + (-1,) if return_status else out

    site = model.site(site_name)
    n = len(mask)
    x_out = np.empty(n, np.float64)
    x_last = np.empty(n, np.float64)
    keep = []  # the arrays behind the pointers, alive until the call returns

    def dp(a):
        a, p = _c64(a)
        keep.append(a)
        return p

    def ip(a):
        a, p = _c32i(a)
        keep.append(a)
        return p

    anc = np.ascontiguousarray(model.ancestors[site.parent], dtype=np.uint8)
    status = lib.kmanip_ik_solve(
        int(model.nq), ip(model.parent), ip(model.jnt_type), dp(model.jnt_pos),
        dp(model.jnt_quat),
        int(site.parent), dp(site.pos), dp(site.quat),
        anc.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n, ip(mask), dp(lo), dp(hi),
        dp(qpos_full), dp(goal_pos), dp(goal_orn),
        dp(np.asarray(q_home_full, np.float64)[mask]),
        dp(np.asarray(q_prev_full, np.float64)[mask]),
        float(k.IK_RES_RAD), float(k.IK_RES_REG_PREV), float(k.IK_RES_REG_HOME),
        float(k.IK_JAC_RAD), float(k.IK_JAC_REG),
        float(ftol), float(xtol), float(gtol), 0,
        x_out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        x_last.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if status < 0 or np.any(~np.isfinite(x_out)):
        x_out = q0
    if np.any(~np.isfinite(x_last)):
        x_last = q0
    out = (np.clip(x_out, lo, hi).astype(np.float32), x_last.astype(np.float32))
    return out + (int(status),) if return_status else out
