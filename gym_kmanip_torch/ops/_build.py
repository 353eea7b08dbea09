"""Build the port's CUDA sources with nvcc and load them with ctypes.

The library is compiled from the sources in `gym_kmanip_torch/csrc/` at
first use, into `gym_kmanip_torch/_build/`, keyed by a hash of the sources
and the flags. A finished library is written atomically (a temporary file,
then a rename), so concurrent processes never load half a file. The C
interface keeps PyTorch's headers out of the build, which takes seconds.

`compile_to` is the atomic build step itself; the native host IK
(native/__init__.py) builds through it with g++.

Nothing here runs at import time: the CPU tests import the port on a host
without nvcc or a GPU.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# --fmad=false: every multiply and add rounds on its own, as in the plain
# PyTorch version's elementwise ops. With contraction on, the kernel's
# frames differ from the plain version's by a few ulps, and at dt = 0.02 the
# contact stiffness (kappa * dt = 200 per metre of penetration) carries
# that past 1e-4 in the cube velocity (measured on an H100: 1.4e-4 with
# contraction, 2.6e-5 without, for 10% more kernel time).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, stack and spills, on nvcc's stderr
)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            path = os.path.join(home, "bin", "nvcc")
            if os.path.exists(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")
    return path


def _digest(sources, headers, flags=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for name in sorted(sources + headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str, sources, headers, flags=()) -> str:
    """Path of the built library for `sources`, building it if needed;
    `flags` are passed to nvcc after NVCC_FLAGS."""
    return _build(name, sources, headers, flags)[0]


def compile_to(out: str, compiler, sources) -> str:
    """Run `compiler` (a command without its output) on `sources` into a
    temporary file in BUILD_DIR, then rename it to `out`, so a concurrent
    process never loads half a library. Returns the compiler's stderr."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [*compiler, "-o", tmp, *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{compiler[0]} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stderr


def _build(name: str, sources, headers, flags=()):
    """(library path, nvcc's stderr); the stderr is empty if the library
    was built already."""
    out = os.path.join(BUILD_DIR, f"{name}_{_digest(sources, headers, flags)}.so")
    if os.path.exists(out):
        return out, ""
    log = compile_to(out, [find_nvcc(), *NVCC_FLAGS, *flags],
                     [os.path.join(CSRC_DIR, s) for s in sources])
    return out, log


def load_library(name: str, sources, headers) -> ctypes.CDLL:
    """Build (once per source hash) and load the library."""
    return ctypes.CDLL(library_path(name, list(sources), list(headers)))


def build_libraries(libraries) -> dict:
    """Build every (name, sources, headers[, flags]) library not built yet,
    one nvcc each, all started together; `flags` are extra nvcc flags.
    Returns {name: (seconds until it was ready, nvcc's stderr with ptxas's
    report)}. Raises the first build's error."""
    t0 = time.perf_counter()

    def one(lib):
        name, sources, headers, *flags = lib
        _, log = _build(name, list(sources), list(headers), tuple(flags[0]) if flags else ())
        return name, (time.perf_counter() - t0, log)

    with ThreadPoolExecutor(max_workers=max(len(libraries), 1)) as pool:
        return dict(pool.map(one, libraries))
