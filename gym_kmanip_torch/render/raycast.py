"""Camera rendering: a batched raycaster in plain PyTorch.

Port of `gym_kmanip_tpu/render/raycast.py`, which is plain `jnp` (no Pallas
kernel): the same scene approximation (floor plane, tabletop box, the free
cube as an oriented box, robot links as capsules along the kinematic tree
with joint spheres at the frames, fingertip spheres and finger slabs,
triangle meshes where a model has them), one ray per pixel, closest hit
over every primitive, Lambertian shading under the scene's three
directional lights, and the truncating cast to uint8.

The JAX package vmaps `render_camera` over states; here every state field
carries the batch as leading dimensions, and one call renders the whole
batch: the hit matrix is (B, P, n_prim) for B states of P = h * w rays,
with no Python loop over the batch. Its largest intermediates are
(B, P, n_prim, 3) float32: ~90 MB for one 480 x 640 frame of the solo arm
(~26 primitives), ~60 MB for the K = 64 rollout states of a vision MPPI
step at 48 x 64 and ~20 MB for N = 64 vec envs at 32 x 32, so no chunking
is needed on the card. No primitive uses a matmul: every product is an
elementwise multiply and sum, so the frames do not depend on the TF32
setting.
"""

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.models import canonical_device, model_tensors
from gym_kmanip_torch.models.spec import RobotModel, _mass_class
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.utils import rotations as rot

_BIG = 1e9

# directional lights (scene.xml:5-7: three directional lights over the table)
_LIGHT_DIRS = np.array(
    [[-0.3, -0.3, -1.0], [0.5, -0.2, -0.8], [0.0, 0.5, -0.9]], dtype=np.float32
)
_LIGHT_DIRS /= np.linalg.norm(_LIGHT_DIRS, axis=1, keepdims=True)
_LIGHT_W = np.array([0.5, 0.3, 0.25], dtype=np.float32)
_AMBIENT = 0.35

_SKY = np.array([0.45, 0.62, 0.82], dtype=np.float32)
_FLOOR_A = np.array([0.45, 0.45, 0.45], dtype=np.float32)
_FLOOR_B = np.array([0.35, 0.35, 0.38], dtype=np.float32)
_TABLE_COLOR = np.array([0.55, 0.42, 0.28], dtype=np.float32)
_CUBE_COLOR = np.array([0.85, 0.18, 0.15], dtype=np.float32)
_LINK_COLOR = np.array([0.55, 0.57, 0.60], dtype=np.float32)
_TIP_COLOR = np.array([0.25, 0.25, 0.28], dtype=np.float32)

_LINK_RADIUS = 0.035
# gripper finger slabs (parent jaw frame -> fingertip): square cross-section
_FINGER_HALF_W = 0.007
# capsule radius per actuator class (visual approximation of the link
# bodies between consecutive joint frames)
_CAPSULE_RADIUS = {"x8": 0.045, "x6": 0.038, "x4": 0.030, "slider": 0.012,
                   "head": 0.035}

_TABLE_CENTER = np.array(
    [k.TABLE_POS[0], k.TABLE_POS[1], (k.TABLE_TOP_Z + 0.5) / 2.0], dtype=np.float32
)
_TABLE_HALF = np.array(
    [k.TABLE_HALF_X, k.TABLE_HALF_Y, (k.TABLE_TOP_Z - 0.5) / 2.0], dtype=np.float32
)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


# ---- primitives: rays o, d (..., P, 3); o may be (..., 1, 3) ----


def _sphere_t(o, d, centers, radii):
    """Distance along each ray to each sphere: centers (..., S, 3), radii
    (..., S) -> t (..., P, S), _BIG on a miss."""
    oc = o[..., :, None, :] - centers[..., None, :, :]
    b = _dot(oc, d[..., :, None, :])
    c = _dot(oc, oc) - radii[..., None, :] ** 2
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    return torch.where((disc > 0) & (t > 1e-4), t, _BIG)


def _ray_spheres(o, d, centers, radii):
    """Ray-sphere: (t (..., P, S), normal (..., P, S, 3))."""
    t = _sphere_t(o, d, centers, radii)
    hitp = o[..., :, None, :] + t[..., None] * d[..., :, None, :]
    n = (hitp - centers[..., None, :, :]) / torch.clamp_min(radii[..., None, :, None], 1e-9)
    return t, n


def _ray_capsules(o, d, pa, pb, radii):
    """Ray-capsule (cylinder body and spherical caps): segment ends pa, pb
    (..., C, 3), radii (..., C) -> (t (..., P, C), normal (..., P, C, 3))."""
    ba = pb - pa
    oa = o[..., :, None, :] - pa[..., None, :, :]
    baba = torch.clamp_min(_dot(ba, ba), 1e-12)[..., None, :]
    bard = _dot(ba[..., None, :, :], d[..., :, None, :])
    baoa = _dot(ba[..., None, :, :], oa)
    rdoa = _dot(d[..., :, None, :], oa)
    oaoa = _dot(oa, oa)
    a2 = baba - bard * bard
    b2 = baba * rdoa - baoa * bard
    c2 = baba * oaoa - baoa * baoa - radii[..., None, :] ** 2 * baba
    h = b2 * b2 - a2 * c2
    a2s = torch.where(torch.abs(a2) < 1e-9, 1e-9, a2)
    t_cyl = (-b2 - torch.sqrt(torch.clamp_min(h, 0.0))) / a2s
    y = baoa + t_cyl * bard  # axial coordinate times baba
    body_ok = (h > 0) & (t_cyl > 1e-4) & (y > 0) & (y < baba)
    t_cyl = torch.where(body_ok, t_cyl, _BIG)
    t = torch.minimum(t_cyl, torch.minimum(_sphere_t(o, d, pa, radii),
                                           _sphere_t(o, d, pb, radii)))
    hitp = o[..., :, None, :] + t[..., None] * d[..., :, None, :]
    # normal: from the closest point on the segment axis
    s = torch.clamp(_dot(ba[..., None, :, :], hitp - pa[..., None, :, :]) / baba, 0.0, 1.0)
    axis_pt = pa[..., None, :, :] + s[..., None] * ba[..., None, :, :]
    n = (hitp - axis_pt) / torch.clamp_min(radii[..., None, :, None], 1e-9)
    return t, n


def _to_frame(v, R):
    """v (..., P, 3) in the world -> the frame whose axes are R's columns
    (v @ R), by elementwise products."""
    return torch.sum(v[..., :, :, None] * R[..., None, :, :], dim=-2)


def _ray_box(o, d, center, R, half):
    """Ray-OBB by the slab method in the box frame: center (..., 3), R
    (..., 3, 3) (columns: the box axes in the world), half (..., 3) ->
    (t (..., P), world normal (..., P, 3))."""
    ol = _to_frame(o - center[..., None, :], R)
    dl = _to_frame(d, R)
    inv = 1.0 / torch.where(torch.abs(dl) < 1e-9, torch.sign(dl) * 1e-9 + 1e-12, dl)
    t1 = (-half[..., None, :] - ol) * inv
    t2 = (half[..., None, :] - ol) * inv
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    t_near = torch.amax(tmin, dim=-1)
    t_far = torch.amin(tmax, dim=-1)
    hit = (t_near < t_far) & (t_far > 1e-4) & (t_near > 1e-4)
    t = torch.where(hit, t_near, _BIG)
    # normal: the axis of the largest tmin, against the ray
    axis = torch.argmax(tmin, dim=-1, keepdim=True)
    sign = -torch.sign(torch.take_along_dim(dl, axis, dim=-1))
    n_local = torch.zeros_like(dl).scatter_(-1, axis, 1.0) * sign
    return t, torch.sum(n_local[..., :, None, :] * R[..., None, :, :], dim=-1)


def _ray_triangles(o, d, tris):
    """Batched Moller-Trumbore: tris (..., T, 3, 3) in the world ->
    (t (..., P, T), normal (..., P, T, 3)), misses at _BIG, the geometric
    normal turned to face the camera (double-sided shading)."""
    v0 = tris[..., 0, :]
    e1 = tris[..., 1, :] - v0
    e2 = tris[..., 2, :] - v0
    dd = d[..., :, None, :]
    pvec = rot.cross(dd, e2[..., None, :, :])
    det = _dot(pvec, e1[..., None, :, :])
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tvec = o[..., :, None, :] - v0[..., None, :, :]
    u = _dot(tvec, pvec) * inv
    qvec = rot.cross(tvec, e1[..., None, :, :])
    v = _dot(dd, qvec) * inv
    t = _dot(e2[..., None, :, :], qvec) * inv
    hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6) & (torch.abs(det) > 1e-12)
    t = torch.where(hit, t, _BIG)
    n = rot.cross(e1, e2)[..., None, :, :]
    n = n / (_norm(n, keepdim=True) + 1e-12)
    n = torch.where(_dot(n, dd)[..., None] > 0, -n, n)
    return t, n.expand(t.shape + (3,))


def _ray_floor(o, d):
    """Distance along each ray to the floor plane z = 0 -> (..., P)."""
    dz = d[..., 2]
    t = -o[..., 2] / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    return torch.where((t > 1e-4) & (dz < 0), t, _BIG)


def _shade(n, base_color, lights):
    """Lambertian under the fixed directional lights: n (..., 3)."""
    diff = 0.0
    for i in range(len(_LIGHT_W)):
        diff = diff + float(_LIGHT_W[i]) * torch.clamp_min(_dot(n, lights[i]), 0.0)
    return base_color * torch.clamp(_AMBIENT + diff, 0.0, 1.0)[..., None]


def _look_at(cam_pos, target, consts):
    """Camera axes (right, up, forward), each (..., 3)."""
    fwd = target - cam_pos
    fwd = fwd / torch.clamp_min(_norm(fwd, keepdim=True), 1e-9)
    right = rot.cross(fwd, consts.ez)
    rn = _norm(right, keepdim=True)
    right = torch.where(rn > 1e-6, right / torch.clamp_min(rn, 1e-9), consts.ex)
    return right, rot.cross(right, fwd), fwd


def _linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    """jnp.linspace's float32 formula: start (1 - i / (n - 1)) + stop i /
    (n - 1), and the last point exactly at stop."""
    if n == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


# ---- the scene's and each camera's constants, once per device ----


class _SceneConsts(NamedTuple):
    lights: torch.Tensor  # (3, 3): -light direction per row
    ez: torch.Tensor
    ex: torch.Tensor
    sky: torch.Tensor
    floor_a: torch.Tensor
    floor_b: torch.Tensor
    table_center: torch.Tensor
    table_R: torch.Tensor
    table_half: torch.Tensor
    cube_half: torch.Tensor
    finger_x: torch.Tensor  # the finger frame's helper axes
    finger_y: torch.Tensor


@functools.lru_cache(maxsize=None)
def _scene_consts(device: torch.device) -> _SceneConsts:
    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return _SceneConsts(
        lights=f32(-_LIGHT_DIRS), ez=f32([0.0, 0.0, 1.0]), ex=f32([1.0, 0.0, 0.0]),
        sky=f32(_SKY), floor_a=f32(_FLOOR_A), floor_b=f32(_FLOOR_B),
        table_center=f32(_TABLE_CENTER), table_R=f32(np.eye(3)), table_half=f32(_TABLE_HALF),
        cube_half=f32(np.full(3, k.CUBE_HALF_SIZE)),
        finger_x=f32([1.0, 0.0, 0.0]), finger_y=f32([0.0, 1.0, 0.0]),
    )


class _CamConsts(NamedTuple):
    pos: torch.Tensor  # (3,) in the parent frame or the world
    target_world: Optional[torch.Tensor]
    half_h: float
    cap_parent: torch.Tensor  # (C,) long
    cap_child: torch.Tensor  # (C,) long
    cap_radii: torch.Tensor  # (C,)
    cap_mask: Optional[torch.Tensor]  # (C,) bool: the mount body's capsule
    sph_radii: torch.Tensor  # (S,) joint spheres, then fingertips
    tip_radius: torch.Tensor  # (F,)
    mesh_tris: Tuple[Tuple[int, torch.Tensor], ...]  # (parent, (T, 3, 3))
    colors: torch.Tensor  # (n_prim, 3) base colour of each primitive, the floor last


def _cam_consts(model: RobotModel, cam_name: str, device: torch.device) -> _CamConsts:
    key = ("render", cam_name, str(device))
    c = model.cache.get(key)
    if c is not None:
        return c
    cam = model.camera(cam_name)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    tips = model.fingertips
    cap_pairs = [(int(model.parent[i]), i) for i in range(model.nq) if int(model.parent[i]) >= 0]
    sph_radii = np.concatenate([np.full(model.nq, _LINK_RADIUS), [t.radius for t in tips]])
    cap_mask = None
    # body-mounted cameras (the grip cameras ride the wrist body): the mount
    # body's own joint sphere and the link capsule ENDING at it are left
    # out; the visual capsules are fatter than the real meshes the camera
    # sits outside of, so the whole frame would be the inside of the wrist
    # link. The jaw capsules and tips stay visible.
    if cam.parent >= 0:
        sph_radii[cam.parent] = 0.0
        mask = np.asarray([i == cam.parent for _, i in cap_pairs], dtype=bool)
        if mask.any():
            cap_mask = torch.as_tensor(mask, device=device)
    n_tris = sum(len(mg.tris) for mg in model.meshes)
    colors = np.concatenate([
        np.tile(_LINK_COLOR, (len(cap_pairs), 1)),
        np.tile(_TIP_COLOR, (len(tips), 1)),
        np.tile(_LINK_COLOR, (n_tris, 1)),
        np.tile(_LINK_COLOR, (model.nq, 1)),
        np.tile(_TIP_COLOR, (len(tips), 1)),
        [_CUBE_COLOR, _TABLE_COLOR, np.zeros(3)],
    ])
    c = _CamConsts(
        pos=f32(cam.pos),
        target_world=None if cam.target_site is not None else f32(cam.target_world),
        half_h=float(np.tan(np.float32(np.deg2rad(cam.fovy) / 2.0))),
        cap_parent=torch.as_tensor([p for p, _ in cap_pairs], dtype=torch.long, device=device),
        cap_child=torch.as_tensor([i for _, i in cap_pairs], dtype=torch.long, device=device),
        cap_radii=f32([_CAPSULE_RADIUS[_mass_class(model.joint_names[i])]
                       for _, i in cap_pairs]),
        cap_mask=cap_mask,
        sph_radii=f32(sph_radii),
        tip_radius=f32([t.radius for t in tips]),
        mesh_tris=tuple((int(mg.parent), f32(mg.tris)) for mg in model.meshes),
        colors=f32(colors),
    )
    model.cache[key] = c
    return c


def render_camera(model: RobotModel, cam_name: str, qpos: torch.Tensor,
                  cube_pos: torch.Tensor, cube_quat: torch.Tensor, height: int,
                  width: int) -> torch.Tensor:
    """Render camera `cam_name` at each state: qpos (..., nq), cube_pos
    (..., 3), cube_quat (..., 4) -> (..., height, width, 3) uint8, on the
    states' device.

    World cameras sit at fixed positions looking at their target; the grip
    cameras ride the gripper body looking at the EE site (the MJCF camera
    specs)."""
    device = canonical_device(qpos.device)
    sc = _scene_consts(device)
    cc = _cam_consts(model, cam_name, device)
    cam = model.camera(cam_name)
    mt = model_tensors(model, device)
    batch = qpos.shape[:-1]
    qpos = qpos.reshape(-1, model.nq).float()
    cube_pos = cube_pos.reshape(-1, 3).float()
    cube_quat = cube_quat.reshape(-1, 4).float()
    xpos, xquat, _ = kin.fk(model, qpos)  # (B, nq, 3), (B, nq, 4)

    if cam.parent < 0:
        cam_pos = cc.pos.expand(qpos.shape[0], 3)
    else:
        cam_pos = xpos[:, cam.parent] + rot.quat_rotate(xquat[:, cam.parent], cc.pos)
    if cam.target_site is not None:
        target, _ = kin.site_pose(model, xpos, xquat, cam.target_site)
    else:
        target = cc.target_world.expand(qpos.shape[0], 3)
    right, up, fwd = _look_at(cam_pos, target, sc)
    half_w = cc.half_h * (width / height)
    ys = _linspace(cc.half_h, -cc.half_h, height, device)
    xs = _linspace(-half_w, half_w, width, device)
    gy = ys[:, None].expand(height, width).reshape(-1, 1)
    gx = xs[None, :].expand(height, width).reshape(-1, 1)
    d = fwd[:, None, :] + gx * right[:, None, :] + gy * up[:, None, :]  # (B, P, 3)
    d = d / _norm(d, keepdim=True)
    o = cam_pos[:, None, :]  # (B, 1, 3): every ray of a frame starts at its camera

    # ---- the primitives, in the JAX version's order (its argmin takes the
    # first index on a tie, as torch.argmin does, so the order decides ties)
    ts, ns = [], []
    if len(cc.cap_radii):
        # link capsules along the kinematic tree (child joint frame -> parent
        # joint frame), radius by actuator class
        t_cap, n_cap = _ray_capsules(o, d, xpos[:, cc.cap_parent], xpos[:, cc.cap_child],
                                     cc.cap_radii)
        if cc.cap_mask is not None:
            t_cap = torch.where(cc.cap_mask, _BIG, t_cap)
        ts.append(t_cap)
        ns.append(n_cap)
    tips = None
    if model.fingertips:
        p_par = xpos[:, mt.tip_parent]  # (B, F, 3)
        tips = p_par + rot.quat_rotate(xquat[:, mt.tip_parent], mt.tip_pos)
        # gripper fingers as thin oriented boxes spanning the parent jaw frame
        # -> the fingertip, extended by the tip radius past the tip end only
        w = tips - p_par
        L = torch.clamp_min(_norm(w), 1e-6)
        u = w / L[..., None]
        a = torch.where(torch.abs(u[..., :1]) < 0.9, sc.finger_x, sc.finger_y)
        xax = rot.cross(a, u)
        xax = xax / torch.clamp_min(_norm(xax, keepdim=True), 1e-9)
        yax = rot.cross(u, xax)
        Rf = torch.stack([xax, yax, u], dim=-1)  # (B, F, 3, 3), columns = axes
        cen = (p_par + tips) / 2.0 + (cc.tip_radius[:, None] / 2.0) * u
        half = torch.stack([torch.full_like(L, _FINGER_HALF_W), torch.full_like(L, _FINGER_HALF_W),
                            (L + cc.tip_radius) / 2.0], dim=-1)
        t_f, n_f = _ray_box(o[:, None], d[:, None], cen, Rf, half)  # (B, F, P)
        ts.append(t_f.transpose(1, 2))
        ns.append(n_f.transpose(1, 2))
    if cc.mesh_tris:
        # triangle-mesh geoms (imported robots with their meshes; the
        # built-in robots have none)
        world = []
        for parent, tris in cc.mesh_tris:
            if parent >= 0:
                R = rot.quat_to_mat(xquat[:, parent])  # (B, 3, 3)
                tris = (torch.sum(tris[None, :, :, None, :] * R[:, None, None, :, :], dim=-1)
                        + xpos[:, parent][:, None, None, :])
            else:
                tris = tris.expand((qpos.shape[0],) + tris.shape)
            world.append(tris)
        t_mesh, n_mesh = _ray_triangles(o, d, torch.cat(world, dim=1))
        ts.append(t_mesh)
        ns.append(n_mesh)
    centers = xpos if tips is None else torch.cat([xpos, tips], dim=1)
    t_sph, n_sph = _ray_spheres(o, d, centers, cc.sph_radii)
    t_cube, n_cube = _ray_box(o, d, cube_pos, rot.quat_to_mat(cube_quat),
                              sc.cube_half.expand(cube_pos.shape))
    t_table, n_table = _ray_box(o, d, sc.table_center, sc.table_R, sc.table_half)
    t_floor = _ray_floor(o, d)
    ts += [t_sph, t_cube[..., None], t_table[..., None], t_floor[..., None]]
    ns += [n_sph, n_cube[..., None, :], n_table[..., None, :],
           torch.zeros_like(n_table)[..., None, :]]  # the floor's, unused: it is not shaded

    # closest hit, its normal and base colour, then one shading per pixel
    t_all = torch.cat(ts, dim=-1)  # (B, P, n_prim)
    idx = torch.argmin(t_all, dim=-1, keepdim=True)
    t_best = torch.take_along_dim(t_all, idx, dim=-1)[..., 0]
    normal = torch.take_along_dim(torch.cat(ns, dim=-2), idx[..., None], dim=-2)[..., 0, :]
    idx = idx[..., 0]
    color = _shade(normal, cc.colors[idx], sc.lights)
    hitp = o + t_floor[..., None] * d
    checker = torch.remainder(torch.floor(hitp[..., 0] * 2) + torch.floor(hitp[..., 1] * 2), 2.0)
    c_floor = checker[..., None] * sc.floor_a + (1 - checker[..., None]) * sc.floor_b
    color = torch.where((idx == t_all.shape[-1] - 1)[..., None], c_floor, color)
    color = torch.where((t_best >= _BIG)[..., None], sc.sky, color)
    img = torch.clamp(color * 255.0, 0, 255).to(torch.uint8)  # truncating, as astype
    return img.reshape(batch + (height, width, 3))


def render_chunked(model: RobotModel, cam_name: str, qpos: torch.Tensor,
                   cube_pos: torch.Tensor, cube_quat: torch.Tensor, height: int,
                   width: int, chunk: int = 128) -> torch.Tensor:
    """`render_camera` of N states (qpos (N, nq), cube_pos (N, 3),
    cube_quat (N, 4)) in chunks of `chunk` states -> (N, height, width, 3)
    uint8: a (chunk, P, n_prim) hit matrix instead of an (N, P, n_prim) one."""
    return torch.cat([render_camera(model, cam_name, qpos[i:i + chunk], cube_pos[i:i + chunk],
                                    cube_quat[i:i + chunk], height, width)
                      for i in range(0, qpos.shape[0], chunk)])


def make_render_fn(model: RobotModel, cam_name: str, height: int, width: int):
    """The renderer of one camera at one size: (qpos, cube_pos, cube_quat)
    -> (..., height, width, 3) uint8."""
    return functools.partial(render_camera, model, cam_name, height=height, width=width)
