"""Penalty contacts: fingertip spheres vs the cube box, cube corners vs the
table.

Port of `gym_kmanip_tpu/dynamics/contacts.py`. The contact set is static
(8 cube corners vs the table plane, every fingertip sphere vs the cube
box), activation is by max(0, penetration) gating, and the normal force
follows MuJoCo's impedance form:

  aref = kappa * pen - beta * v_n
  f_n  = m_eff * max(0, aref - a0_n)
  f_t  = -mu * f_n * v_t / sqrt(|v_t|^2 + v_slip^2)

Fingertip pairs are evaluated first and their force on the cube feeds the
table contact's a0 (one Gauss-Seidel pass). Every tensor carries the batch
as leading dimensions.
"""

from typing import NamedTuple, Tuple

import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.models import model_tensors, scene_tensors
from gym_kmanip_torch.utils import rotations as rot
from gym_kmanip_torch.utils.rotations import cross


class ContactOut(NamedTuple):
    force_cube: torch.Tensor  # (..., 3) net world force on the cube
    torque_cube: torch.Tensor  # (..., 3) net world torque about the cube COM
    tip_forces: torch.Tensor  # (..., T, 3) world force on each fingertip
    touch_tip: torch.Tensor  # (..., T) bool fingertip-cube contact
    touch_table: torch.Tensor  # (...) bool cube-table contact


def _normal_force(pen, vn, a0, m_eff):
    """MuJoCo-impedance normal force, active only in penetration."""
    aref = k.CONTACT_KAPPA * pen - k.CONTACT_BETA * vn
    return torch.where(pen > 0, m_eff * torch.clamp(aref - a0, min=0.0),
                       torch.zeros_like(pen))


def _friction(fn, vt):
    """Smooth Coulomb friction force (world); vt (..., 3)."""
    speed = torch.sqrt(torch.sum(vt * vt, dim=-1, keepdim=True) + k.CONTACT_SLIP_VEL**2)
    return -k.CONTACT_FRICTION_MU * fn[..., None] * vt / speed


def _over_table(p):
    return (torch.abs(p[..., 0] - k.TABLE_POS[0]) < k.TABLE_HALF_X) & (
        torch.abs(p[..., 1] - k.TABLE_POS[1]) < k.TABLE_HALF_Y
    )


def _gravity(like: torch.Tensor) -> torch.Tensor:
    return scene_tensors(like.device).gravity


def cube_table(cube_pos, cube_quat, cube_linvel, cube_angvel,
               ext_force=None, ext_torque=None):
    """Corner-vs-plane contact of the cube with the tabletop (or the floor
    at z=0 off the table). `ext_force`/`ext_torque` are the net non-table
    force and torque on the cube (default: gravity only). Returns (force,
    torque, touching) on / about the cube COM."""
    if ext_force is None:
        ext_force = k.CUBE_MASS * _gravity(cube_pos)
    if ext_torque is None:
        ext_torque = torch.zeros_like(cube_pos)

    R = rot.quat_to_mat(cube_quat)
    corners = scene_tensors(cube_pos.device).cube_corners
    corners_w = cube_pos[..., None, :] + corners @ R.transpose(-1, -2)  # (..., 8, 3)
    arm = corners_w - cube_pos[..., None, :]
    v_corner = cube_linvel[..., None, :] + cross(cube_angvel[..., None, :], arm)

    over = _over_table(corners_w)
    plane_z = torch.where(over, torch.full_like(corners_w[..., 2], k.TABLE_TOP_Z),
                          torch.zeros_like(corners_w[..., 2]))
    pen = plane_z - corners_w[..., 2]  # (..., 8)
    vn = v_corner[..., 2]

    alpha = ext_torque / k.CUBE_DIAG_INERTIA
    w = cube_angvel[..., None, :]
    a_corner = (
        (ext_force / k.CUBE_MASS)[..., None, :]
        + cross(alpha[..., None, :], arm)
        + cross(w, cross(w, arm))
    )
    n_act = torch.clamp(torch.sum((pen > 0).to(pen.dtype), dim=-1), min=1.0)
    fn = _normal_force(pen, vn, a_corner[..., 2], (k.CUBE_MASS / n_act)[..., None])
    vt = torch.cat([v_corner[..., :2], torch.zeros_like(v_corner[..., 2:])], dim=-1)
    ft = _friction(fn, vt)
    f = torch.cat([ft[..., :2], ft[..., 2:] + fn[..., None]], dim=-1)  # (..., 8, 3)

    force = torch.sum(f, dim=-2)
    torque = torch.sum(cross(arm, f), dim=-2)
    touching = torch.any((pen > 0) & over, dim=-1)
    return force, torque, touching


def sphere_box(center_local, radius, half: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere vs origin-centered box in the box frame.

    Returns (pen, normal_local): penetration depth (> 0 touching) and the
    normal from the box surface toward the sphere center. A center inside
    the box exits through the face with the least remaining distance; the
    first such face wins a tie, as `jnp.argmin` does."""
    clamped = torch.clamp(center_local, -half, half)
    delta = center_local - clamped
    sq = torch.sum(delta * delta, dim=-1)
    outside = sq > 1e-18
    dist = torch.sqrt(torch.where(outside, sq, torch.ones_like(sq)))

    n_out = delta / dist[..., None]
    pen_out = radius - dist

    face_dist = half - torch.abs(center_local)
    axis = torch.argmin(face_dist, dim=-1, keepdim=True)
    sign = torch.sign(torch.gather(center_local, -1, axis) + 1e-12)
    n_in = torch.zeros_like(center_local).scatter(-1, axis, sign)
    pen_in = radius + torch.gather(face_dist, -1, axis)[..., 0]

    pen = torch.where(outside, pen_out, pen_in)
    normal = torch.where(outside[..., None], n_out, n_in)
    return pen, normal


def fingertips_cube_table(tip_pos, tip_vel, tip_radius, cube_pos, cube_quat,
                          cube_linvel, cube_angvel):
    """Fingertip spheres (..., T, 3) vs the cube box. Returns (tip_forces
    (..., T, 3), cube_force (..., 3), cube_torque (..., 3), touch (..., T)).

    No fingertip-table force: the reference ships no finger collision
    geoms, so its grippers pass through the tabletop."""
    R = rot.quat_to_mat(cube_quat)[..., None, :, :]  # (..., 1, 3, 3)
    cp = cube_pos[..., None, :]
    local = ((tip_pos - cp)[..., None, :] @ R)[..., 0, :]  # R^T (p - c)
    pen, n_local = sphere_box(local, tip_radius, k.CUBE_HALF_SIZE)
    n = (R @ n_local[..., None])[..., 0]  # world, cube -> tip
    cpoint = tip_pos - n * (tip_radius - torch.clamp(pen, min=0.0) * 0.5)[..., None]
    arm = cpoint - cp
    v_cube_pt = cube_linvel[..., None, :] + cross(cube_angvel[..., None, :], arm)
    v_rel = tip_vel - v_cube_pt
    vn = torch.sum(v_rel * n, dim=-1)
    a0 = -torch.sum(_gravity(n) * n, dim=-1)
    fn = _normal_force(pen, vn, a0, k.CUBE_MASS)
    vt = v_rel - vn[..., None] * n
    fr = _friction(fn, vt)
    f_tips = fn[..., None] * n + fr
    f_cubes = -fn[..., None] * n - fr
    cube_force = torch.sum(f_cubes, dim=-2)
    cube_torque = torch.sum(cross(arm, f_cubes), dim=-2)
    return f_tips, cube_force, cube_torque, pen > 0


def contact_forces_fast(model, tip_pos, tip_vel, cube_pos, cube_quat, cube_linvel,
                        cube_angvel) -> ContactOut:
    """`contact_forces` with the model's fingertip radii, through the
    contact kernel (ops/contacts_cuda, K6) on the card: the leading
    dimensions broadcast and flatten into its batch (an unbatched state is
    a batch of one), one launch per call. Tensors on the CPU run
    `contact_forces`; any other device raises. The JAX package's seam of
    the same name sends a vmapped batch on the TPU to its Pallas kernel."""
    if tip_pos.device.type == "cpu":
        radius = model_tensors(model, tip_pos.device).tip_radius
        return contact_forces(tip_pos, tip_vel, radius, cube_pos, cube_quat, cube_linvel,
                              cube_angvel)
    from gym_kmanip_torch.ops.contacts_cuda import contact_forces_batched

    T = len(model.fingertips)
    batch = torch.broadcast_shapes(tip_pos.shape[:-2], tip_vel.shape[:-2], cube_pos.shape[:-1],
                                   cube_quat.shape[:-1], cube_linvel.shape[:-1],
                                   cube_angvel.shape[:-1])

    def flat(x, shape):
        return x.expand(batch + shape).reshape((-1,) + shape).contiguous()

    out = contact_forces_batched(
        model, flat(tip_pos, (T, 3)), flat(tip_vel, (T, 3)), flat(cube_pos, (3,)),
        flat(cube_quat, (4,)), flat(cube_linvel, (3,)), flat(cube_angvel, (3,)))
    return ContactOut(*(x.reshape(batch + x.shape[1:]) for x in out))


def contact_forces(tip_pos, tip_vel, tip_radius, cube_pos, cube_quat,
                   cube_linvel, cube_angvel) -> ContactOut:
    """All contact forces for one batch of world states, fingertips first."""
    f_tips, f_cube, t_cube, touch = fingertips_cube_table(
        tip_pos, tip_vel, tip_radius, cube_pos, cube_quat, cube_linvel, cube_angvel
    )
    g_force = k.CUBE_MASS * _gravity(cube_pos)
    f_table, t_table, touch_table = cube_table(
        cube_pos, cube_quat, cube_linvel, cube_angvel,
        ext_force=g_force + f_cube, ext_torque=t_cube,
    )
    return ContactOut(
        force_cube=f_table + f_cube,
        torque_cube=t_table + t_cube,
        tip_forces=f_tips,
        touch_tip=touch,
        touch_table=touch_table,
    )
