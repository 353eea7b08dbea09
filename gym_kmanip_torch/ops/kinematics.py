"""Forward kinematics, Jacobians, RNEA bias forces and the mass matrix.

Port of `gym_kmanip_tpu/ops/kinematics.py`. The kinematic tree is static
(parents have lower indices), so each recursion is a Python loop over the
joints; every tensor carries the rollout batch as leading dimensions.
"""

from typing import Tuple

import torch

from gym_kmanip_torch.models import model_tensors, scene_tensors
from gym_kmanip_torch.models.spec import HINGE, RobotModel
from gym_kmanip_torch.utils import rotations as rot
from gym_kmanip_torch.utils.rotations import cross


def _hinge_quat(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about local z by `angle` (...,) -> (..., 4)."""
    half = 0.5 * angle
    z = torch.zeros_like(half)
    return torch.stack([torch.cos(half), z, z, torch.sin(half)], dim=-1)


def _root_frame(qpos: torch.Tensor):
    z3 = qpos.new_zeros(qpos.shape[:-1] + (3,))
    ident = qpos.new_zeros(qpos.shape[:-1] + (4,))
    ident[..., 0] = 1.0
    return z3, ident


def fk(model: RobotModel, qpos: torch.Tensor
       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward kinematics: qpos (..., nq) -> xpos (..., nq, 3), xquat
    (..., nq, 4), axis_w (..., nq, 3) (world z of each joint frame)."""
    t = model_tensors(model, qpos.device)
    ez = scene_tensors(qpos.device).ez
    x0, q0 = _root_frame(qpos)
    xpos, xquat = [], []
    for i in range(model.nq):
        par = int(model.parent[i])
        p_par, q_par = (x0, q0) if par < 0 else (xpos[par], xquat[par])
        p = p_par + rot.quat_rotate(q_par, t.jnt_pos[i])
        q = rot.quat_mul(q_par, t.jnt_quat[i])
        if int(model.jnt_type[i]) == HINGE:
            q = rot.quat_mul(q, _hinge_quat(qpos[..., i]))
        else:  # SLIDE: translate along local z
            p = p + rot.quat_rotate(q, ez * qpos[..., i, None])
        xpos.append(p)
        xquat.append(q)
    xpos = torch.stack(xpos, dim=-2)
    xquat = torch.stack(xquat, dim=-2)
    return xpos, xquat, rot.quat_rotate(xquat, ez)


def site_pose(model: RobotModel, xpos, xquat, site_name: str):
    """World pose (pos (..., 3), quat (..., 4)) of a named site."""
    t = model_tensors(model, xpos.device)
    i = model.site_index(site_name)
    par = model.sites[i].parent
    pq = xquat[..., par, :]
    return (xpos[..., par, :] + rot.quat_rotate(pq, t.site_pos[i]),
            rot.quat_mul(pq, t.site_quat[i]))


def all_site_poses(model: RobotModel, xpos, xquat):
    """World poses of all sites: ((..., S, 3), (..., S, 4)), in
    `model.sites` order."""
    t = model_tensors(model, xpos.device)
    pp = xpos[..., t.site_parent, :]
    pq = xquat[..., t.site_parent, :]
    return pp + rot.quat_rotate(pq, t.site_pos), rot.quat_mul(pq, t.site_quat)


def point_jacobian(model: RobotModel, xpos, axis_w, point, attach_joint: int):
    """Translational and rotational Jacobians ((..., 3, nq) each) of a world
    point (..., 3) rigidly attached to `attach_joint`'s body."""
    t = model_tensors(model, xpos.device)
    anc = t.ancestors[attach_joint][:, None]  # (nq, 1)
    slide = t.is_slide[:, None]
    lever = cross(axis_w, point[..., None, :] - xpos)  # (..., nq, 3)
    jacp = anc * torch.where(slide, axis_w, lever)
    jacr = anc * (~slide).to(axis_w.dtype) * axis_w
    return jacp.transpose(-1, -2), jacr.transpose(-1, -2)


def body_jacobians(model: RobotModel, xpos, xquat, axis_w):
    """COM world positions (..., nq, 3) and the translational / rotational
    COM Jacobians (..., nq, 3, nq) of every body."""
    t = model_tensors(model, xpos.device)
    com_w = xpos + rot.quat_rotate(xquat, t.body_com)
    anc = t.ancestors[..., None]  # (nbody, njnt, 1)
    slide = t.is_slide[None, :, None]
    diff = com_w[..., :, None, :] - xpos[..., None, :, :]  # (..., nbody, njnt, 3)
    lever = cross(axis_w[..., None, :, :], diff)
    jv = anc * torch.where(slide, axis_w[..., None, :, :], lever)
    jw = anc * (~slide).to(xpos.dtype) * axis_w[..., None, :, :]
    return com_w, jv.transpose(-1, -2), jw.transpose(-1, -2)


def mass_matrix_from_frames(model: RobotModel, xpos, xquat, axis_w) -> torch.Tensor:
    """Joint-space inertia M(q) (..., nq, nq) from world frames:
    sum_i m_i Jv_i^T Jv_i + Jw_i^T (R_i I_i R_i^T) Jw_i + armature."""
    t = model_tensors(model, xpos.device)
    _, jv, jw = body_jacobians(model, xpos, xquat, axis_w)
    R = rot.quat_to_mat(xquat)
    Iw = torch.einsum("...iab,ib,...icb->...iac", R, t.body_inertia, R)
    M = torch.einsum("...iaj,i,...iak->...jk", jv, t.body_mass, jv) + torch.einsum(
        "...iaj,...iab,...ibk->...jk", jw, Iw, jw
    )
    return M + torch.diag(t.armature)


def rnea_terms_fast(model: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor):
    """`rnea_terms` through the FK + RNEA kernel (ops/rnea_cuda, K5) on the
    card: the leading dimensions broadcast and flatten into its batch (an
    unbatched state is a batch of one), one launch per call. Tensors on
    the CPU run `rnea_terms`; any other device raises. The JAX package's
    seam of the same name sends a vmapped batch on the TPU to its Pallas
    kernel."""
    if qpos.device.type == "cpu":
        return rnea_terms(model, qpos, qvel)
    from gym_kmanip_torch.ops.rnea_cuda import rnea_terms_batched

    nq = model.nq
    batch = torch.broadcast_shapes(qpos.shape[:-1], qvel.shape[:-1])
    out = rnea_terms_batched(model, qpos.expand(batch + (nq,)).reshape(-1, nq).contiguous(),
                             qvel.expand(batch + (nq,)).reshape(-1, nq).contiguous())
    return tuple(x.reshape(batch + x.shape[1:]) for x in out)


def rnea_terms(model: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor):
    """One forward pass: (xpos, xquat, axis_w, qfrc_bias).

    qfrc_bias = C(q,v)v + g(q) by recursive Newton-Euler with qacc = 0;
    gravity enters as a fictitious base acceleration -g."""
    t = model_tensors(model, qpos.device)
    scene = scene_tensors(qpos.device)
    ez = scene.ez
    z3, ident = _root_frame(qpos)
    up_g = z3 - scene.gravity  # the base "accelerates" at -g

    x, q, axis, w, v, alpha, a = [], [], [], [], [], [], []
    for i in range(model.nq):
        par = int(model.parent[i])
        if par < 0:
            xp, qp, wp, vp, alp, ap = z3, ident, z3, z3, z3, up_g
        else:
            xp, qp = x[par], q[par]
            wp, vp, alp, ap = w[par], v[par], alpha[par], a[par]
        r = rot.quat_rotate(qp, t.jnt_pos[i])
        xi = xp + r
        qi = rot.quat_mul(qp, t.jnt_quat[i])
        qd = qvel[..., i, None]
        if int(model.jnt_type[i]) == HINGE:
            qi = rot.quat_mul(qi, _hinge_quat(qpos[..., i]))
            ax = rot.quat_rotate(qi, ez)
            vi = vp + cross(wp, r)
            ai = ap + cross(alp, r) + cross(wp, cross(wp, r))
            wi = wp + ax * qd
            ali = alp + cross(wp, ax * qd)
        else:  # SLIDE along local z; the joint origin rides the slide
            ax = rot.quat_rotate(qi, ez)
            r_eff = r + ax * qpos[..., i, None]
            xi = xi + ax * qpos[..., i, None]
            wi, ali = wp, alp
            vi = vp + cross(wp, r_eff) + ax * qd
            ai = (
                ap
                + cross(alp, r_eff)
                + cross(wp, cross(wp, r_eff))
                + 2.0 * cross(wp, ax * qd)
            )
        x.append(xi)
        q.append(qi)
        axis.append(ax)
        w.append(wi)
        v.append(vi)
        alpha.append(ali)
        a.append(ai)

    # body-frame inertial loads at each COM
    f_net, n_net, c_off = [], [], []
    for i in range(model.nq):
        c = rot.quat_rotate(q[i], t.body_com[i])
        a_com = a[i] + cross(alpha[i], c) + cross(w[i], cross(w[i], c))
        R = rot.quat_to_mat(q[i])
        Iw = R @ (t.body_inertia[i][:, None] * R.transpose(-1, -2))
        f_net.append(t.body_mass[i] * a_com)
        n_net.append((Iw @ alpha[i][..., None])[..., 0]
                     + cross(w[i], (Iw @ w[i][..., None])[..., 0]))
        c_off.append(c)

    # backward pass: accumulate wrenches to parents
    F = [None] * model.nq
    N = [None] * model.nq
    tau = [None] * model.nq
    for i in range(model.nq - 1, -1, -1):
        Fi = f_net[i]
        Ni = n_net[i] + cross(c_off[i], f_net[i])
        for ch in range(i + 1, model.nq):
            if int(model.parent[ch]) == i:
                Fi = Fi + F[ch]
                Ni = Ni + N[ch] + cross(x[ch] - x[i], F[ch])
        F[i], N[i] = Fi, Ni
        tau[i] = torch.sum(axis[i] * (Ni if int(model.jnt_type[i]) == HINGE else Fi), -1)
    return (torch.stack(x, -2), torch.stack(q, -2), torch.stack(axis, -2),
            torch.stack(tau, -1))
