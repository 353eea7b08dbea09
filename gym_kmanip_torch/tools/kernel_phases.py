"""Cycles per step, phase by phase, of the substep (K1), the pick-cost
rollout (K2), the feedback rollout (K3), the Riccati sweep (K4) and the
contact model (K6) on the card.

    python -m gym_kmanip_torch.tools.kernel_phases [K1 K2 K3 K4 K6]

Builds the kernels again with a prelude that turns their phase marks
(KMANIP_PHASE in csrc/substep_team.cuh, csrc/rollout.cuh,
csrc/feedback_warp.cuh, csrc/riccati.cuh, csrc/staged_team.cuh and the K1
and K2 kernels; no-ops in the normal build) into clock64 counters kept by
one thread of block 0 (thread 0; for K6 the last lane of the first team,
which sums the cube's force): each mark adds the cycles since the mark
before to its phase. It runs them through their wrappers at the main
path's shapes (K1: seeded solo states at K=256 with contact and at K=1,500
without, the iLQR FD probes' shape; K2: the solo arm, K=256, H=50, seeded
controls; K3: the solo arm, B=6 step sizes, H=50, seeded nominal and gains;
K4: the seeded problems at (50, 20, 10) and (100, 40, 20); K6: seeded solo
states at K=256 with fingertip and table contacts) and prints each phase's
mean cycles per step (per launch for K1 and K6). A mark costs a few
shared-memory operations on that thread; the kernels' times are
chip_smoke.py's. Needs nvcc and a CUDA device; exits non-zero without one.
"""

import ctypes
import hashlib
import os
import sys

import numpy as np
import torch

from gym_kmanip_torch.dynamics import engine
from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.ops import _build, contacts_cuda, riccati_cuda, rollout_feedback_cuda
from gym_kmanip_torch.ops import kinematics, rollout_pick_cuda, substep_cuda

N_PHASES = 16
PRELUDE = r"""
#include <cuda_runtime.h>
#ifndef KMANIP_PHASE_TID
#define KMANIP_PHASE_TID 0
#endif
__device__ long long kmanip_phase_cycles[16];
__shared__ long long kmanip_phase_acc[16];
__shared__ long long kmanip_phase_last;
#define KMANIP_PHASE_START() do { if (threadIdx.x == KMANIP_PHASE_TID) { \
  for (int p_ = 0; p_ < 16; ++p_) kmanip_phase_acc[p_] = 0; \
  kmanip_phase_last = clock64(); } } while (0)
#define KMANIP_PHASE(k) do { if (threadIdx.x == KMANIP_PHASE_TID) { \
  const long long n_ = clock64(); \
  kmanip_phase_acc[k] += n_ - kmanip_phase_last; kmanip_phase_last = n_; } } while (0)
#define KMANIP_PHASE_STOP() do { if (threadIdx.x == KMANIP_PHASE_TID && blockIdx.x == 0) \
  for (int p_ = 0; p_ < 16; ++p_) kmanip_phase_cycles[p_] = kmanip_phase_acc[p_]; } while (0)
extern "C" int kmanip_phase_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, kmanip_phase_cycles, sizeof(kmanip_phase_cycles));
}
"""
# the team substep's marks (csrc/substep_team.cuh) and the rollouts' own
SUBSTEP_PHASES = {0: "step's inputs", 1: "FK", 2: "loads, tips, corners, Jacobian columns",
                  8: "corner forces", 3: "mass matrix", 9: "backward pass, cube", 4: "torques",
                  5: "factor", 6: "solves and constraints", 7: "integration", 10: "pick cost",
                  11: "setup", 12: "outputs"}
K4_PHASES = ("wait and barrier", "P1 GW", "P2 Q blocks", "P3 factor", "P4 gains and V",
             "P5 value update")
K6_PHASES = ("stage", "tips and corners' states", "corner forces", "sums and outputs")


def instrumented(module, name, flags=()):
    """The wrapper module's library built with the phase prelude (and the
    extra nvcc `flags`) and bound like the normal one; also binds
    kmanip_phase_read."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    prelude = os.path.join(_build.BUILD_DIR,
                           f"phase_prelude_{hashlib.sha256(PRELUDE.encode()).hexdigest()[:8]}.cuh")
    if not os.path.exists(prelude):
        with open(prelude, "w") as f:
            f.write(PRELUDE)
    path = _build.library_path(f"{name}_phases", list(module.SOURCES), list(module.HEADERS),
                               ("-include", prelude, *flags))
    lib = module._bind(ctypes.CDLL(path))
    lib.kmanip_phase_read.argtypes = [ctypes.c_void_p]
    lib.kmanip_phase_read.restype = ctypes.c_int
    return lib


def cycles(module, lib, fn, steps, runs=3):
    """Mean cycles per step of each phase in the last of `runs` calls of
    fn, which launches the module's kernel (through `lib`)."""
    saved = module._library
    module._library = lambda: lib
    try:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    finally:
        module._library = saved
    out = np.zeros(N_PHASES, np.int64)
    rc = lib.kmanip_phase_read(out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"reading the phase counters failed: cudaError_t {rc}")
    return out / steps


def k3_phases(device, H=50):
    m = get_model("solo_arm")
    s0 = init_state(m, device=device)
    rng = np.random.RandomState(5)
    n, nu = 2 * m.nq, m.nu

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    x0 = torch.cat([s0.qpos, s0.qvel])
    cube0 = torch.cat([s0.cube_pos, s0.cube_quat, s0.cube_linvel, s0.cube_angvel])
    args = (x0, cube0, x0[None] + t(0.002 * rng.randn(H, n)),
            t(m.home_qpos[:nu] + 0.01 * rng.randn(H, nu)), t(0.003 * rng.randn(H, nu)),
            t(0.005 * rng.randn(H, nu, n)), t([1.0, 0.6, 0.3, 0.1, 0.03, 0.01]))
    lib = instrumented(rollout_feedback_cuda, "rollout_feedback")
    c = cycles(rollout_feedback_cuda, lib,
               lambda: rollout_feedback_cuda.rollout_feedback(m, *args), H)
    return named(c)


def named(c):
    return {name: c[i] for i, name in SUBSTEP_PHASES.items() if c[i] > 0}


def k1_phases(device):
    m = get_model("solo_arm")
    lib = instrumented(substep_cuda, "substep")
    out = {}
    for K, contact in ((256, True), (1500, False)):
        inputs = [torch.as_tensor(a, device=device)
                  for a in substep_cuda.random_inputs(m, K, seed=0)]
        c = cycles(substep_cuda, lib,
                   lambda: substep_cuda.substep_batched(m, 0.02, contact, True, *inputs), 1)
        out[(K, contact)] = named(c)
    return out


def k2_phases(device, K=256, H=50):
    m = get_model("solo_arm")
    s0 = init_state(m, device=device)
    rng = np.random.RandomState(0)
    U = torch.as_tensor((m.home_qpos[: m.nu] + 0.1 * rng.randn(K, H, m.nu)).astype(np.float32),
                        device=device)
    lib = instrumented(rollout_pick_cuda, "rollout_pick")
    return named(cycles(rollout_pick_cuda, lib,
                        lambda: rollout_pick_cuda.rollout_pick_costs(m, U, s0), H))


def k4_phases(device, widths=((50, 20, 10), (100, 40, 20))):
    lib = instrumented(riccati_cuda, "riccati")
    lam = torch.zeros((), device=device)
    out = {}
    for h, n, m in widths:
        prob = [torch.as_tensor(a, device=device) for a in riccati_cuda.random_problem(3, h, n, m)]
        c = cycles(riccati_cuda, lib,
                   lambda: riccati_cuda.riccati_sweep(*prob, 1e-6, lam_extra=lam), h)
        out[(h, n, m)] = dict(zip(K4_PHASES, c))
    return out


def k6_phases(device, K=256):
    m = get_model("solo_arm")
    q, v, _, cube = (torch.as_tensor(a, device=device)
                     for a in substep_cuda.random_inputs(m, K, seed=7))
    xp, xq, ax, _ = kinematics.rnea_terms(m, q, v)
    tips, tip_vel, _, _ = engine._tip_state(m, xp, xq, ax, v)
    args = tuple(a.contiguous() for a in (tips, tip_vel, cube[:, :3], cube[:, 3:7],
                                           cube[:, 7:10], cube[:, 10:]))
    # the timed thread: the first team's last lane, which sums the cube's force
    lib = instrumented(contacts_cuda, "contacts", ("-DKMANIP_PHASE_TID=31",))
    c = cycles(contacts_cuda, lib, lambda: contacts_cuda.contact_forces_batched(m, *args), 1)
    return dict(zip(K6_PHASES, c))


def line(phases):
    total = sum(phases.values())
    return ", ".join(f"{k} {v:.0f}" for k, v in phases.items()) + f"; sum {total:.0f}"


def main(argv=None):
    kernels = set((sys.argv[1:] if argv is None else argv) or ("K1", "K2", "K3", "K4", "K6"))
    if not torch.cuda.is_available():
        sys.exit("kernel_phases: no CUDA device")
    device = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; clock64 cycles per step, one thread of block 0")
    if "K1" in kernels:
        for (K, contact), phases in k1_phases(device).items():
            print(f"K1 solo K={K} contact={contact} (per launch): {line(phases)}")
    if "K2" in kernels:
        print(f"K2 solo K=256 H=50: {line(k2_phases(device))}")
    if "K3" in kernels:
        print(f"K3 solo B=6 H=50: {line(k3_phases(device))}")
    if "K4" in kernels:
        for widths, phases in k4_phases(device).items():
            print(f"K4 {widths}: {line(phases)}")
    if "K6" in kernels:
        print(f"K6 solo K=256 (per launch, lane 31 of block 0): {line(k6_phases(device))}")


if __name__ == "__main__":
    main()
