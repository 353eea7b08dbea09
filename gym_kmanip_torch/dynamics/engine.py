"""Forward dynamics step: PD actuators + bias + contacts, semi-implicit Euler.

Port of `gym_kmanip_tpu/dynamics/engine.py`. One 20 ms control step is
N_SUBSTEPS physics substeps of 2 ms. The actuators are MuJoCo position
servos, tau = kp * (ctrl - q) clamped to forcerange, with a small engine
damping and the XML frictionloss; limits and frictionloss are soft
constraint forces solved through the mass matrix.

`substep` dispatches by the device of the state: a CPU state runs the plain
PyTorch `_substep_torch`; any other state runs the hand-written CUDA kernel
(ops/substep_cuda.py), which raises for a device it cannot run on.
`substep_staged` is the same step as three kernels (FK + RNEA, contacts,
the SPD solve) with torch code between them.
"""

from functools import partial
from typing import Optional, Tuple

import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics import contacts
from gym_kmanip_torch.dynamics.state import SimState, StepAux
from gym_kmanip_torch.models import model_tensors, scene_tensors
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.ops import linalg
from gym_kmanip_torch.utils import rotations as rot

_CUBE_INV_MASS = 1.0 / k.CUBE_MASS
_CUBE_INV_INERTIA = 1.0 / k.CUBE_DIAG_INERTIA


def _tip_state(model: RobotModel, xpos, xquat, axis_w, qvel):
    """World fingertip positions (..., T, 3), velocities (..., T, 3),
    translational Jacobians (..., T, 3, nq) and radii (T,)."""
    t = model_tensors(model, qvel.device)
    pos, jac = [], []
    for i, tip in enumerate(model.fingertips):
        p = xpos[..., tip.parent, :] + rot.quat_rotate(
            xquat[..., tip.parent, :], t.tip_pos[i]
        )
        jp, _ = kin.point_jacobian(model, xpos, axis_w, p, tip.parent)
        pos.append(p)
        jac.append(jp)
    pos = torch.stack(pos, dim=-2)
    jac = torch.stack(jac, dim=-3)
    vel = (jac @ qvel[..., None, :, None])[..., 0]
    return pos, vel, jac, t.tip_radius


def _tips_from_frames(model: RobotModel, xpos, xquat):
    """World fingertip centers (..., T, 3) from joint frames."""
    t = model_tensors(model, xpos.device)
    return xpos[..., t.tip_parent, :] + rot.quat_rotate(
        xquat[..., t.tip_parent, :], t.tip_pos
    )


def constraint_qacc(model: RobotModel, qpos, qvel, qacc0, Mdiag, solve, dt):
    """Joint limits + dof frictionloss as a force-space dual Jacobi
    iteration, CONSTRAINT_ITERS sweeps reusing the substep's factor.

      limits:   aref = kappa*viol - beta*qvel, one-sided, impedance d = 0.95
      friction: regularized dry friction toward qvel = 0, |f| <= fl

    `solve(b)` solves M x = b with the substep's factorization."""
    t = model_tensors(model, qpos.device)
    viol_lo = t.jnt_lo - qpos
    viol_hi = qpos - t.jnt_hi
    aref_lo = k.LIMIT_KAPPA * viol_lo - k.LIMIT_BETA * qvel
    aref_hi = -k.LIMIT_KAPPA * viol_hi - k.LIMIT_BETA * qvel
    d = k.LIMIT_IMPEDANCE
    d_fr = k.FRICTION_IMPEDANCE
    zero = torch.zeros_like(qacc0)

    f_fric, f_lo, f_hi = zero, zero, zero
    qacc = qacc0
    for _ in range(k.CONSTRAINT_ITERS):
        f_fric = torch.clamp(
            f_fric
            + d_fr * Mdiag * (-k.FRICTION_BETA * qvel - qacc)
            - (1.0 - d_fr) * f_fric,
            -t.frictionloss, t.frictionloss,
        )
        f_lo = torch.where(
            viol_lo > 0,
            torch.clamp(f_lo + d * Mdiag * (aref_lo - qacc), min=0.0),
            zero,
        )
        f_hi = torch.where(
            viol_hi > 0,
            torch.clamp(f_hi + d * Mdiag * (aref_hi - qacc), max=0.0),
            zero,
        )
        qacc = qacc0 + solve(f_fric + f_lo + f_hi)
    return qacc


def substep(model: RobotModel, state: SimState, dt: float, contact: bool = True,
            implicit_actuation: bool = False):
    """One physics substep. Returns (new_state, (touch, xpos, xquat)), the
    frames being those of the state the substep advanced FROM.

    A state on the CPU runs `_substep_torch`; a state on another device
    runs the CUDA kernel, an unbatched state as a batch of one."""
    if state.qpos.device.type == "cpu":
        return _substep_torch(model, state, dt, contact, implicit_actuation)
    return _substep_kernel(model, state, dt, contact, implicit_actuation)


def _substep_kernel(model, state, dt, contact, implicit_actuation):
    from gym_kmanip_torch.ops.substep_cuda import substep_batched

    single = state.qpos.dim() == 1
    if single:
        state = SimState(*(x.unsqueeze(0) for x in state))
    cube13 = torch.cat(
        [state.cube_pos, state.cube_quat, state.cube_linvel, state.cube_angvel],
        dim=-1,
    )
    qo, vo, co, touch, xp, xq = substep_batched(
        model, dt, contact, implicit_actuation, state.qpos.contiguous(),
        state.qvel.contiguous(), state.ctrl.contiguous(), cube13,
    )
    new = SimState(
        qpos=qo, qvel=vo, ctrl=state.ctrl,
        cube_pos=co[..., :3], cube_quat=co[..., 3:7],
        cube_linvel=co[..., 7:10], cube_angvel=co[..., 10:13],
        time=state.time + dt,
    )
    if single:
        new = SimState(*(x.squeeze(0) for x in new))
        touch, xp, xq = touch[0], xp[0], xq[0]
    return new, (touch, xp, xq)


def _substep_torch(model: RobotModel, state: SimState, dt: float,
                   contact: bool = True, implicit_actuation: bool = False):
    """One physics substep in plain PyTorch (the twin of the JAX package's
    `_substep_jnp`), on any device and any leading batch dimensions. It
    launches no kernel on any device: the kernels' plain versions are built
    on it.

    `implicit_actuation` integrates the servo stiffness implicitly (adds
    dt^2 diag(kp) to M and dt kp v to the force): MPC rollouts at dt = 20 ms
    need it, the 2 ms plant does not."""
    return _substep_body(model, state, dt, contact, implicit_actuation, staged=False)


def substep_staged(model: RobotModel, state: SimState, dt: float, contact: bool = True,
                   implicit_actuation: bool = False):
    """One physics substep on the staged route, `substep`'s signature, so it
    serves as a rollout's `substep_fn`: the counterpart of the JAX
    package's `_substep_jnp(..., unrolled_solve=True)` under a batch. The
    frames and bias come from `kin.rnea_terms_fast` (K5 on the card), the
    contacts from `contacts.contact_forces_fast` (K6), and every solve with
    M, one for the unconstrained step and one per constraint sweep, from
    `linalg.batch_aware_cholesky_solve` (K7); the rest is the plain
    substep's torch code. On the CPU every stage runs its plain version."""
    return _substep_body(model, state, dt, contact, implicit_actuation, staged=True)


def _substep_body(model: RobotModel, state: SimState, dt: float, contact: bool,
                  implicit_actuation: bool, staged: bool):
    t = model_tensors(model, state.qpos.device)
    q, v = state.qpos, state.qvel
    nq, nu = model.nq, model.nu

    rnea_terms = kin.rnea_terms_fast if staged else kin.rnea_terms
    xpos, xquat, axis_w, tau_bias = rnea_terms(model, q, v)
    tip_pos, tip_vel, tip_jac, tip_rad = _tip_state(model, xpos, xquat, axis_w, v)

    if contact and staged and model.fingertips:
        con = contacts.contact_forces_fast(
            model, tip_pos, tip_vel, state.cube_pos, state.cube_quat,
            state.cube_linvel, state.cube_angvel,
        )
    elif contact:
        con = contacts.contact_forces(
            tip_pos, tip_vel, tip_rad, state.cube_pos, state.cube_quat,
            state.cube_linvel, state.cube_angvel,
        )
    else:
        con = contacts.ContactOut(
            force_cube=torch.zeros_like(state.cube_pos),
            torque_cube=torch.zeros_like(state.cube_pos),
            tip_forces=torch.zeros_like(tip_pos),
            touch_tip=torch.zeros(tip_pos.shape[:-1], dtype=torch.bool,
                                  device=q.device),
            touch_table=torch.zeros(q.shape[:-1], dtype=torch.bool, device=q.device),
        )

    # ---- robot ----
    tau_act = torch.clamp(t.kp * (state.ctrl - q[..., :nu]), t.force_lo, t.force_hi)
    tau_act = torch.cat([tau_act, torch.zeros_like(q[..., nu:])], dim=-1)
    tau_fric = -k.JOINT_DAMPING * v
    tau_contact = torch.sum(tip_jac * con.tip_forces[..., None], dim=(-3, -2))
    tau = tau_act + tau_fric + tau_contact - tau_bias

    eye = torch.eye(nq, dtype=q.dtype, device=q.device)
    M = kin.mass_matrix_from_frames(model, xpos, xquat, axis_w)
    M = M + dt * k.JOINT_DAMPING * eye
    if implicit_actuation:
        tau = tau - dt * t.kp_full * v
        M = M + dt * dt * torch.diag(t.kp_full)
    if staged:
        solve = partial(linalg.batch_aware_cholesky_solve, M)
    else:
        solve = partial(linalg.cholesky_substitute, linalg.cholesky_factor(M))
    qacc = solve(tau)
    qacc = constraint_qacc(model, q, v, qacc, torch.diagonal(M, dim1=-2, dim2=-1),
                           solve, dt)

    v_new = v + dt * qacc
    q_new = q + dt * v_new
    lo = t.jnt_lo - k.LIMIT_SAFETY_MARGIN
    hi = t.jnt_hi + k.LIMIT_SAFETY_MARGIN
    q_clamped = torch.clamp(q_new, lo, hi)
    v_new = torch.where(
        ((q_new > hi) & (v_new > 0)) | ((q_new < lo) & (v_new < 0)),
        torch.zeros_like(v_new), v_new,
    )

    # ---- cube (free body) ----
    g = scene_tensors(q.device).gravity
    linvel = state.cube_linvel + dt * (con.force_cube * _CUBE_INV_MASS + g)
    angvel = state.cube_angvel + dt * (con.torque_cube * _CUBE_INV_INERTIA)
    cap_l = dt * k.CUBE_FRICTIONLOSS * _CUBE_INV_MASS
    cap_a = dt * k.CUBE_FRICTIONLOSS * _CUBE_INV_INERTIA
    linvel = linvel + torch.clamp(-linvel, -cap_l, cap_l)
    angvel = angvel + torch.clamp(-angvel, -cap_a, cap_a)
    linvel = torch.clamp(linvel, -k.CUBE_MAX_LINVEL, k.CUBE_MAX_LINVEL)
    angvel = torch.clamp(angvel, -k.CUBE_MAX_ANGVEL, k.CUBE_MAX_ANGVEL)
    cube_pos = state.cube_pos + dt * linvel
    cube_quat = rot.quat_integrate(state.cube_quat, angvel, dt)

    new = SimState(
        qpos=q_clamped, qvel=v_new, ctrl=state.ctrl,
        cube_pos=cube_pos, cube_quat=cube_quat,
        cube_linvel=linvel, cube_angvel=angvel,
        time=state.time + dt,
    )
    return new, (con.touch_tip, xpos, xquat)


def control_step(model: RobotModel, state: SimState, ctrl: torch.Tensor,
                 qpos_force: Optional[torch.Tensor] = None
                 ) -> Tuple[SimState, StepAux]:
    """One 20 ms control step = N_SUBSTEPS physics substeps of 2 ms, then
    the diagnostics at the final state.

    `qpos_force` (the env's split-step parity input) belongs to the env
    slice and is not ported yet."""
    if qpos_force is not None:
        raise NotImplementedError("control_step(qpos_force=...) is not ported yet")
    state = state._replace(ctrl=ctrl.to(state.qpos.dtype))
    touch = None
    for _ in range(k.N_SUBSTEPS):
        state, (touch, _xp, _xq) = substep(model, state, k.PHYSICS_TIMESTEP)

    t = model_tensors(model, state.qpos.device)
    xpos, xquat, _ = kin.fk(model, state.qpos)
    site_pos, site_quat = kin.all_site_poses(model, xpos, xquat)
    _, _, touch_table = contacts.cube_table(
        state.cube_pos, state.cube_quat, state.cube_linvel, state.cube_angvel
    )
    aux = StepAux(
        touch_r=torch.any(touch & t.tip_right, dim=-1),
        touch_l=torch.any(touch & t.tip_left, dim=-1),
        touch_table=touch_table,
        site_pos=site_pos,
        site_quat=site_quat,
        qfrc_contact=torch.zeros_like(state.qvel),
        tip_pos=_tips_from_frames(model, xpos, xquat),
    )
    return state, aux
