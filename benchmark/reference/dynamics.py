"""The plain reference of the pick rollout: the articulated arm with PD
servos, penalty contacts between the fingertip spheres, the cube and the
table, semi-implicit Euler, and the cube-pick running cost.

Plain PyTorch on any device, every tensor carrying the rollout batch as
its leading dimensions; the kinematic tree is a Python loop over joints.
It follows the published semantics of the reference env's scene (MuJoCo's
position servos, its impedance form of penalty contacts, a dual Jacobi
pass for joint limits and dof friction) and imports nothing of the system
under test.

`Plain(robot, device, precision)` computes in IEEE float32 with
`precision="fp32"`. With `precision="tf32"` every matrix product and the
factorization take their operands rounded to TF32 (10 explicit mantissa
bits, as the tensor cores read them) and accumulate in float32: the
benchmark's control, the step below float32 that a change could be
tempted to take.
"""

from typing import NamedTuple

import numpy as np
import torch

from . import scene as sc


class State(NamedTuple):
    qpos: torch.Tensor  # (..., nq)
    qvel: torch.Tensor  # (..., nq)
    cube_pos: torch.Tensor  # (..., 3)
    cube_quat: torch.Tensor  # (..., 4) wxyz
    cube_linvel: torch.Tensor  # (..., 3)
    cube_angvel: torch.Tensor  # (..., 3)


class PickWeights(NamedTuple):
    w_vel: float = sc.REWARD_VEL_PENALTY
    w_grip_dist: float = sc.REWARD_GRIP_DIST
    w_touch: float = sc.REWARD_TOUCH_CUBE
    w_lift: float = sc.REWARD_LIFT_CUBE
    w_ctrl: float = 1e-3
    use_right: bool = True
    use_left: bool = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits, to nearest with
    ties away from zero (the tensor cores' conversion)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# ---- rotations (wxyz) ----

def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    w, u = q[..., :1], q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                     2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                     2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q, omega, dt):
    """q advanced by the world angular velocity omega over dt, with the
    small-angle Taylor branch, normalized."""
    rot = omega * dt
    sq = torch.sum(rot * rot, dim=-1, keepdim=True)
    small = sq < 1e-14
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    scale = torch.where(small, 0.5 - sq / 48.0, torch.sin(0.5 * angle) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(0.5 * angle))
    out = quat_mul(torch.cat([w, scale * rot], dim=-1), q)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)


class Plain:
    """The plain rollout of one robot on one device."""

    def __init__(self, robot, device, precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision is fp32 or tf32, not {precision}")
        self.robot = robot
        self.device = torch.device(device)
        self.tf32 = precision == "tf32"

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        r = robot
        kp_full = np.zeros(r.nq)
        kp_full[:r.nu] = r.kp
        self.jnt_pos, self.jnt_quat = f32(r.jnt_pos), f32(r.jnt_quat)
        self.is_slide = torch.as_tensor(r.is_slide, device=self.device)
        self.jnt_lo, self.jnt_hi = f32(r.jnt_range[:, 0]), f32(r.jnt_range[:, 1])
        self.frictionloss, self.armature = f32(r.frictionloss), f32(r.armature)
        self.kp, self.kp_full = f32(r.kp), f32(kp_full)
        self.force_lo, self.force_hi = f32(r.force_range[:, 0]), f32(r.force_range[:, 1])
        self.ctrl_lo, self.ctrl_hi = f32(r.ctrl_range[:, 0]), f32(r.ctrl_range[:, 1])
        self.body_mass, self.body_com = f32(r.body_mass), f32(r.body_com)
        self.body_inertia, self.ancestors = f32(r.body_inertia), f32(r.ancestors)
        self.site_parent = torch.as_tensor(r.site_parent, dtype=torch.long, device=self.device)
        self.site_pos = f32(r.site_pos)
        self.tip_pos, self.tip_radius = f32(r.tip_pos), f32(r.tip_radius)
        self.tip_right = torch.as_tensor([s == "r" for s in r.tip_side], device=self.device)
        self.tip_left = torch.as_tensor([s == "l" for s in r.tip_side], device=self.device)
        self.gravity = torch.tensor(sc.GRAVITY, dtype=torch.float32, device=self.device)
        self.ez = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        signs = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
        self.cube_corners = torch.tensor(signs, device=self.device) * sc.CUBE_HALF_SIZE

    # ---- the precision of products and factorizations ----

    def _in(self, x):
        return round_tf32(x) if self.tf32 else x

    def mm(self, a, b):
        return self._in(a) @ self._in(b)

    def einsum(self, eq, *ops):
        return torch.einsum(eq, *(self._in(x) for x in ops))

    # ---- kinematics ----

    def rnea_terms(self, qpos, qvel):
        """Frames (xpos, xquat, axis_w) and the bias forces C(q,v)v + g(q)
        by recursive Newton-Euler with qacc = 0 (gravity as a base
        acceleration -g)."""
        r = self.robot
        z3 = qpos.new_zeros(qpos.shape[:-1] + (3,))
        ident = qpos.new_zeros(qpos.shape[:-1] + (4,))
        ident[..., 0] = 1.0
        up_g = z3 - self.gravity
        x, q, axis, w, v, alpha, a = [], [], [], [], [], [], []
        for i in range(r.nq):
            par = int(r.parent[i])
            if par < 0:
                xp, qp, wp, vp, alp, ap = z3, ident, z3, z3, z3, up_g
            else:
                xp, qp, wp, vp, alp, ap = x[par], q[par], w[par], v[par], alpha[par], a[par]
            rr = quat_rotate(qp, self.jnt_pos[i])
            xi = xp + rr
            qi = quat_mul(qp, self.jnt_quat[i])
            qd = qvel[..., i, None]
            if not r.is_slide[i]:
                half = 0.5 * qpos[..., i]
                zero = torch.zeros_like(half)
                qi = quat_mul(qi, torch.stack([torch.cos(half), zero, zero, torch.sin(half)], -1))
                ax = quat_rotate(qi, self.ez)
                vi = vp + cross(wp, rr)
                ai = ap + cross(alp, rr) + cross(wp, cross(wp, rr))
                wi = wp + ax * qd
                ali = alp + cross(wp, ax * qd)
            else:  # slide along local z; the joint origin rides the slide
                ax = quat_rotate(qi, self.ez)
                r_eff = rr + ax * qpos[..., i, None]
                xi = xi + ax * qpos[..., i, None]
                wi, ali = wp, alp
                vi = vp + cross(wp, r_eff) + ax * qd
                ai = ap + cross(alp, r_eff) + cross(wp, cross(wp, r_eff)) + 2.0 * cross(wp, ax * qd)
            x.append(xi)
            q.append(qi)
            axis.append(ax)
            w.append(wi)
            v.append(vi)
            alpha.append(ali)
            a.append(ai)

        f_net, n_net, c_off = [], [], []
        for i in range(r.nq):
            c = quat_rotate(q[i], self.body_com[i])
            a_com = a[i] + cross(alpha[i], c) + cross(w[i], cross(w[i], c))
            R = quat_to_mat(q[i])
            Iw = self.mm(R, self.body_inertia[i][:, None] * R.transpose(-1, -2))
            f_net.append(self.body_mass[i] * a_com)
            n_net.append(self.mm(Iw, alpha[i][..., None])[..., 0]
                         + cross(w[i], self.mm(Iw, w[i][..., None])[..., 0]))
            c_off.append(c)

        F, N, tau = [None] * r.nq, [None] * r.nq, [None] * r.nq
        for i in range(r.nq - 1, -1, -1):
            Fi = f_net[i]
            Ni = n_net[i] + cross(c_off[i], f_net[i])
            for ch in range(i + 1, r.nq):
                if int(r.parent[ch]) == i:
                    Fi = Fi + F[ch]
                    Ni = Ni + N[ch] + cross(x[ch] - x[i], F[ch])
            F[i], N[i] = Fi, Ni
            tau[i] = torch.sum(axis[i] * (Fi if r.is_slide[i] else Ni), -1)
        return (torch.stack(x, -2), torch.stack(q, -2), torch.stack(axis, -2),
                torch.stack(tau, -1))

    def point_jacobian(self, xpos, axis_w, point, joint):
        """Translational Jacobian (..., 3, nq) of a world point on `joint`'s body."""
        anc = self.ancestors[joint][:, None]
        lever = cross(axis_w, point[..., None, :] - xpos)
        return (anc * torch.where(self.is_slide[:, None], axis_w, lever)).transpose(-1, -2)

    def mass_matrix(self, xpos, xquat, axis_w):
        """M(q) = sum_i m_i Jv_i^T Jv_i + Jw_i^T (R_i I_i R_i^T) Jw_i + armature."""
        com_w = xpos + quat_rotate(xquat, self.body_com)
        anc = self.ancestors[..., None]
        slide = self.is_slide[None, :, None]
        diff = com_w[..., :, None, :] - xpos[..., None, :, :]
        lever = cross(axis_w[..., None, :, :], diff)
        jv = (anc * torch.where(slide, axis_w[..., None, :, :], lever)).transpose(-1, -2)
        jw = (anc * (~slide).to(xpos.dtype) * axis_w[..., None, :, :]).transpose(-1, -2)
        R = quat_to_mat(xquat)
        Iw = self.einsum("...iab,ib,...icb->...iac", R, self.body_inertia, R)
        M = self.einsum("...iaj,i,...iak->...jk", jv, self.body_mass, jv) + self.einsum(
            "...iaj,...iab,...ibk->...jk", jw, Iw, jw)
        return M + torch.diag(self.armature)

    def site_pos_all(self, xpos, xquat):
        pp = xpos[..., self.site_parent, :]
        pq = xquat[..., self.site_parent, :]
        return pp + quat_rotate(pq, self.site_pos)

    # ---- contacts ----

    @staticmethod
    def _normal_force(pen, vn, a0, m_eff):
        aref = sc.CONTACT_KAPPA * pen - sc.CONTACT_BETA * vn
        return torch.where(pen > 0, m_eff * torch.clamp(aref - a0, min=0.0), torch.zeros_like(pen))

    @staticmethod
    def _friction(fn, vt):
        speed = torch.sqrt(torch.sum(vt * vt, dim=-1, keepdim=True) + sc.CONTACT_SLIP_VEL**2)
        return -sc.CONTACT_FRICTION_MU * fn[..., None] * vt / speed

    def cube_table(self, s: State, ext_force=None, ext_torque=None):
        """The cube's corners against the tabletop (the floor off the table):
        (force, torque, touching)."""
        if ext_force is None:
            ext_force = sc.CUBE_MASS * self.gravity
        if ext_torque is None:
            ext_torque = torch.zeros_like(s.cube_pos)
        R = quat_to_mat(s.cube_quat)
        corners_w = s.cube_pos[..., None, :] + self.mm(self.cube_corners, R.transpose(-1, -2))
        arm = corners_w - s.cube_pos[..., None, :]
        v_corner = s.cube_linvel[..., None, :] + cross(s.cube_angvel[..., None, :], arm)
        over = ((torch.abs(corners_w[..., 0] - sc.TABLE_POS[0]) < sc.TABLE_HALF_X)
                & (torch.abs(corners_w[..., 1] - sc.TABLE_POS[1]) < sc.TABLE_HALF_Y))
        plane_z = torch.where(over, torch.full_like(corners_w[..., 2], sc.TABLE_TOP_Z),
                              torch.zeros_like(corners_w[..., 2]))
        pen = plane_z - corners_w[..., 2]
        alpha = ext_torque / sc.CUBE_DIAG_INERTIA
        w = s.cube_angvel[..., None, :]
        a_corner = ((ext_force / sc.CUBE_MASS)[..., None, :] + cross(alpha[..., None, :], arm)
                    + cross(w, cross(w, arm)))
        n_act = torch.clamp(torch.sum((pen > 0).to(pen.dtype), dim=-1), min=1.0)
        fn = self._normal_force(pen, v_corner[..., 2], a_corner[..., 2],
                                (sc.CUBE_MASS / n_act)[..., None])
        vt = torch.cat([v_corner[..., :2], torch.zeros_like(v_corner[..., 2:])], dim=-1)
        ft = self._friction(fn, vt)
        f = torch.cat([ft[..., :2], ft[..., 2:] + fn[..., None]], dim=-1)
        return (torch.sum(f, dim=-2), torch.sum(cross(arm, f), dim=-2),
                torch.any((pen > 0) & over, dim=-1))

    @staticmethod
    def _sphere_box(center, radius, half):
        """(penetration, normal from the box toward the center) in the box frame."""
        clamped = torch.clamp(center, -half, half)
        delta = center - clamped
        sq = torch.sum(delta * delta, dim=-1)
        outside = sq > 1e-18
        dist = torch.sqrt(torch.where(outside, sq, torch.ones_like(sq)))
        n_out = delta / dist[..., None]
        face_dist = half - torch.abs(center)
        axis = torch.argmin(face_dist, dim=-1, keepdim=True)
        sign = torch.sign(torch.gather(center, -1, axis) + 1e-12)
        n_in = torch.zeros_like(center).scatter(-1, axis, sign)
        pen = torch.where(outside, radius - dist, radius + torch.gather(face_dist, -1, axis)[..., 0])
        return pen, torch.where(outside[..., None], n_out, n_in)

    def contacts(self, tip_pos, tip_vel, s: State):
        """Fingertips against the cube first, their force on the cube feeding
        the table contact: (force_cube, torque_cube, tip_forces, touch_tip)."""
        R = quat_to_mat(s.cube_quat)[..., None, :, :]
        cp = s.cube_pos[..., None, :]
        local = self.mm((tip_pos - cp)[..., None, :], R)[..., 0, :]
        pen, n_local = self._sphere_box(local, self.tip_radius, sc.CUBE_HALF_SIZE)
        n = self.mm(R, n_local[..., None])[..., 0]
        cpoint = tip_pos - n * (self.tip_radius - torch.clamp(pen, min=0.0) * 0.5)[..., None]
        arm = cpoint - cp
        v_rel = tip_vel - (s.cube_linvel[..., None, :] + cross(s.cube_angvel[..., None, :], arm))
        vn = torch.sum(v_rel * n, dim=-1)
        a0 = -torch.sum(self.gravity * n, dim=-1)
        fn = self._normal_force(pen, vn, a0, sc.CUBE_MASS)
        fr = self._friction(fn, v_rel - vn[..., None] * n)
        f_tips = fn[..., None] * n + fr
        f_cubes = -fn[..., None] * n - fr
        f_cube = torch.sum(f_cubes, dim=-2)
        t_cube = torch.sum(cross(arm, f_cubes), dim=-2)
        f_table, t_table, _ = self.cube_table(s, ext_force=sc.CUBE_MASS * self.gravity + f_cube,
                                              ext_torque=t_cube)
        return f_table + f_cube, t_table + t_cube, f_tips, pen > 0

    # ---- one substep ----

    def substep(self, s: State, ctrl, dt: float, contact: bool = True, implicit: bool = True):
        """One substep of dt: (new state, touch_tip, xpos, xquat), the frames
        and touches those of the state it advanced from."""
        r = self.robot
        q, v = s.qpos, s.qvel
        xpos, xquat, axis_w, tau_bias = self.rnea_terms(q, v)
        tips, jacs = [], []
        for i in range(len(r.tip_parent)):
            par = int(r.tip_parent[i])
            p = xpos[..., par, :] + quat_rotate(xquat[..., par, :], self.tip_pos[i])
            tips.append(p)
            jacs.append(self.point_jacobian(xpos, axis_w, p, par))
        tip_pos = torch.stack(tips, dim=-2)
        tip_jac = torch.stack(jacs, dim=-3)
        tip_vel = self.mm(tip_jac, v[..., None, :, None])[..., 0]
        if contact:
            force_cube, torque_cube, tip_forces, touch = self.contacts(tip_pos, tip_vel, s)
        else:
            force_cube = torque_cube = torch.zeros_like(s.cube_pos)
            tip_forces = torch.zeros_like(tip_pos)
            touch = torch.zeros(tip_pos.shape[:-1], dtype=torch.bool, device=q.device)

        tau_act = torch.clamp(self.kp * (ctrl - q[..., :r.nu]), self.force_lo, self.force_hi)
        tau_act = torch.cat([tau_act, torch.zeros_like(q[..., r.nu:])], dim=-1)
        tau_contact = torch.sum(tip_jac * tip_forces[..., None], dim=(-3, -2))
        tau = tau_act + (-sc.JOINT_DAMPING * v) + tau_contact - tau_bias
        M = self.mass_matrix(xpos, xquat, axis_w)
        M = M + dt * sc.JOINT_DAMPING * torch.eye(r.nq, dtype=q.dtype, device=q.device)
        if implicit:
            tau = tau - dt * self.kp_full * v
            M = M + dt * dt * torch.diag(self.kp_full)
        L, _ = torch.linalg.cholesky_ex(self._in(M))

        def solve(b):
            return torch.cholesky_solve(self._in(b).unsqueeze(-1), L).squeeze(-1)

        qacc = self._constraints(q, v, solve(tau), torch.diagonal(M, dim1=-2, dim2=-1), solve)
        v_new = v + dt * qacc
        q_new = q + dt * v_new
        lo = self.jnt_lo - sc.LIMIT_SAFETY_MARGIN
        hi = self.jnt_hi + sc.LIMIT_SAFETY_MARGIN
        q_clamped = torch.clamp(q_new, lo, hi)
        v_new = torch.where(((q_new > hi) & (v_new > 0)) | ((q_new < lo) & (v_new < 0)),
                            torch.zeros_like(v_new), v_new)

        linvel = s.cube_linvel + dt * (force_cube * (1.0 / sc.CUBE_MASS) + self.gravity)
        angvel = s.cube_angvel + dt * (torque_cube * (1.0 / sc.CUBE_DIAG_INERTIA))
        cap_l = dt * sc.CUBE_FRICTIONLOSS * (1.0 / sc.CUBE_MASS)
        cap_a = dt * sc.CUBE_FRICTIONLOSS * (1.0 / sc.CUBE_DIAG_INERTIA)
        linvel = linvel + torch.clamp(-linvel, -cap_l, cap_l)
        angvel = angvel + torch.clamp(-angvel, -cap_a, cap_a)
        linvel = torch.clamp(linvel, -sc.CUBE_MAX_LINVEL, sc.CUBE_MAX_LINVEL)
        angvel = torch.clamp(angvel, -sc.CUBE_MAX_ANGVEL, sc.CUBE_MAX_ANGVEL)
        new = State(q_clamped, v_new, s.cube_pos + dt * linvel,
                    quat_integrate(s.cube_quat, angvel, dt), linvel, angvel)
        return new, touch, xpos, xquat

    def _constraints(self, q, v, qacc0, Mdiag, solve):
        """Joint limits and dof friction as CONSTRAINT_ITERS sweeps of a
        force-space dual Jacobi iteration on the substep's factor."""
        viol_lo, viol_hi = self.jnt_lo - q, q - self.jnt_hi
        aref_lo = sc.LIMIT_KAPPA * viol_lo - sc.LIMIT_BETA * v
        aref_hi = -sc.LIMIT_KAPPA * viol_hi - sc.LIMIT_BETA * v
        d, d_fr = sc.LIMIT_IMPEDANCE, sc.FRICTION_IMPEDANCE
        zero = torch.zeros_like(qacc0)
        f_fric, f_lo, f_hi, qacc = zero, zero, zero, qacc0
        for _ in range(sc.CONSTRAINT_ITERS):
            f_fric = torch.clamp(
                f_fric + d_fr * Mdiag * (-sc.FRICTION_BETA * v - qacc) - (1.0 - d_fr) * f_fric,
                -self.frictionloss, self.frictionloss)
            f_lo = torch.where(viol_lo > 0, torch.clamp(f_lo + d * Mdiag * (aref_lo - qacc), min=0.0),
                               zero)
            f_hi = torch.where(viol_hi > 0, torch.clamp(f_hi + d * Mdiag * (aref_hi - qacc), max=0.0),
                               zero)
            qacc = qacc0 + solve(f_fric + f_lo + f_hi)
        return qacc

    # ---- the rollout and its cost ----

    def pick_cost(self, s: State, touch, xpos, xquat, ctrl, wts: PickWeights, contact: bool):
        """The step's cost: velocity penalty, inverse gripper distance, touch
        and lift bonuses (negated) and control effort; the sites and touches
        from the last substep's frames, the table touch at the new state."""
        r = self.robot
        site_pos = self.site_pos_all(xpos, xquat)
        if contact:
            _, _, touch_table = self.cube_table(s)
        else:
            touch_table = torch.zeros(s.qpos.shape[:-1], dtype=torch.bool, device=s.qpos.device)
        qvel_full = torch.cat([s.qvel, s.cube_linvel, s.cube_angvel], dim=-1)
        c = wts.w_vel * torch.sqrt(torch.clamp(torch.sum(qvel_full * qvel_full, dim=-1), min=1e-16))
        for use, site in ((wts.use_right, "eer_site"), (wts.use_left, "eel_site")):
            if use:
                i = r.site_index(site)
                dist = torch.linalg.vector_norm(s.cube_pos - site_pos[..., i, :], dim=-1)
                c = c - wts.w_grip_dist / (dist + sc.EPSILON)
        touched = torch.any(touch & self.tip_right, dim=-1) | torch.any(touch & self.tip_left, dim=-1)
        c = c - torch.where(touched, wts.w_touch, 0.0)
        c = c - torch.where(touched & ~touch_table, wts.w_lift, 0.0)
        return c + wts.w_ctrl * torch.sum((ctrl - s.qpos[..., :r.nu]) ** 2, dim=-1)

    def rollout_costs(self, s0: State, ctrl_seq, wts: PickWeights, n_substeps: int, dt: float,
                      contact: bool = True):
        """Total pick cost (B,) of control sequences (B, H, nu) from start
        states (B, ...) with implicit actuation."""
        s = State(*(x.contiguous() for x in s0))
        total = None
        for ctrl in ctrl_seq.transpose(0, 1).contiguous():
            for _ in range(n_substeps):
                s, touch, xpos, xquat = self.substep(s, ctrl, dt, contact)
            c = self.pick_cost(s, touch, xpos, xquat, ctrl, wts, contact)
            total = c if total is None else total + c
        return total
