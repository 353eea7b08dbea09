"""The algorithm's work per rollout-substep and per pick-cost step, and the
published peaks of one NVIDIA H100, frozen for the benchmark.

The counts are a function of the robot's sizes only (joints, their kinds
and tree, fingertips, actuators). They were counted once by hand from the
substep's arithmetic: each float add, multiply, divide, square root, sine
or cosine is one operation; comparisons and selects are none; a clamp is
two. They count the algorithm's work and are never updated to follow how a
kernel does it: a change that does the same work in fewer instructions
shows as a larger roofline share, not as a smaller count.

`robot` is any object with `nq`, `nu`, `is_slide` (nq,), `ancestors`
(nq, nq) and `tip_parent` (T,).
"""

import numpy as np

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3
# bandwidth, at the 700 W power limit.
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def rnea_flops(robot) -> int:
    """FK, the velocity recursion, the loads at each COM and the backward
    pass of recursive Newton-Euler, for one rollout."""
    nq = robot.nq
    f = int(np.sum(np.where(np.asarray(robot.is_slide), 172, 188)))
    f += 183 * nq
    f += 17 * nq + 21 * (nq - 1)
    return f


def contact_flops(robot) -> int:
    """Fingertip spheres against the cube, the cube's 8 corners against the
    table, for one rollout."""
    return 39 + 185 * len(robot.tip_parent) + 12 + 8 * 110


def chol_flops(n: int, n_solves: int = 1) -> int:
    """A Cholesky factor of an n x n matrix, then `n_solves` solves with it."""
    factor = sum(2 * j + 2 + (n - 1 - j) * (2 * j + 1) for j in range(n))
    return factor + n_solves * 2 * n * n


def substep_flops(robot, contact: bool) -> int:
    """One substep of one rollout: RNEA, fingertips, contacts, actuation,
    the mass matrix by COM Jacobians, one solve and three constraint
    sweeps, integration and the cube."""
    nq = robot.nq
    anc = np.asarray(robot.ancestors, bool)
    f = rnea_flops(robot)
    f += 48 * len(robot.tip_parent)
    if contact:
        f += contact_flops(robot)
    f += 8 * nq
    f += sum(18 * int(anc[int(p)].sum()) for p in robot.tip_parent)
    for i in range(nq):
        a = int(anc[i].sum())
        f += 33 + 45 * a + 13 * a * (a + 1) // 2
    f += 3 * nq
    f += chol_flops(nq, n_solves=4)
    f += 3 * 25 * nq + 6 * nq + 120
    return f


def pick_cost_flops(robot) -> int:
    """The pick cost of one rollout at one control step."""
    return 2 * robot.nq + 3 * robot.nu + 16 + 44 + 250


def rollout_pick_work(robot, K: int, H: int, n_substeps: int, contact: bool):
    """(operations, bytes) of scoring K control sequences of H steps: every
    substep and every step's cost; the controls and the start state read
    once, the K totals written once (float32)."""
    flops = K * H * (n_substeps * substep_flops(robot, contact) + pick_cost_flops(robot))
    nbytes = 4 * (K * H * robot.nu + 2 * robot.nq + 13 + K)
    return flops, nbytes


def roofline_share(flops: float, nbytes: float, seconds: float):
    """(percent of the least time the card could take, the bound that sets
    it: "operations" or "bytes")."""
    t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 100.0 * max(t_ops, t_bytes) / seconds, ("operations" if t_ops >= t_bytes else "bytes")
