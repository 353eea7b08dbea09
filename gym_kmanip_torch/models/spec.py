"""Static robot model specification (numpy only).

Port of `gym_kmanip_tpu/models/spec.py`. A robot is a frozen dataclass of
float64 numpy arrays, the same fields as the JAX package's `RobotModel`.
Conventions: quaternions are wxyz; every joint sits at the origin of its
body frame with axis +z; `jnt_pos`/`jnt_quat` are the composed transform
from the parent joint's frame (or the world, for roots) to this joint's.

The tensors built from a model for one device are cached on the model
itself (`RobotModel.cache`), so they are made once per (model, device).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from numpy.typing import NDArray

from gym_kmanip_torch.utils import rotations as rot

HINGE = 0
SLIDE = 1

# engineering estimates per actuator class (the reference ships no inertials)
_MASS_BY_CLASS = {"x8": 0.8, "x6": 0.5, "x4": 0.3, "slider": 0.06, "head": 0.3}
_ARMATURE_BY_CLASS = {"x8": 0.05, "x6": 0.02, "x4": 0.01, "slider": 0.005, "head": 0.01}
_GYRATION_RADIUS = 0.06  # m, for the diagonal inertia estimate I = m r^2


@dataclass(frozen=True)
class SiteSpec:
    name: str
    parent: int  # joint index the site body hangs off
    pos: NDArray  # (3,) offset in parent joint frame
    quat: NDArray  # (4,) wxyz


@dataclass(frozen=True)
class CameraSpec:
    name: str
    parent: int  # joint index, or -1 for world-fixed
    pos: NDArray  # (3,) in parent frame
    fovy: float
    target_site: Optional[str]
    target_world: Optional[NDArray]


@dataclass(frozen=True)
class FingertipSpec:
    """Collision sphere standing in for the gripper finger mesh geometry."""

    parent: int  # joint index (a gripper slider)
    pos: NDArray  # (3,) in parent joint frame
    radius: float
    side: str  # "r" or "l"


@dataclass(frozen=True)
class MeshGeomSpec:
    """Triangle-mesh visual geom, pre-transformed into its parent joint frame."""

    name: str
    parent: int
    tris: NDArray  # (T, 3, 3) float32


@dataclass(frozen=True)
class RobotModel:
    """Static articulated-robot description (numpy)."""

    name: str
    nq: int  # robot joints (excludes the free cube)
    nu: int  # actuators; actuator i drives joint i
    joint_names: Tuple[str, ...]
    parent: NDArray  # (nq,) int32, -1 for roots
    jnt_pos: NDArray  # (nq,3)
    jnt_quat: NDArray  # (nq,4)
    jnt_type: NDArray  # (nq,) HINGE|SLIDE
    jnt_range: NDArray  # (nq,2)
    jnt_frictionloss: NDArray  # (nq,)
    armature: NDArray  # (nq,)
    actuator_kp: NDArray  # (nu,)
    actuator_kv: NDArray  # (nu,)
    ctrl_range: NDArray  # (nu,2)
    force_range: NDArray  # (nu,2)
    body_mass: NDArray  # (nq,)
    body_com: NDArray  # (nq,3)
    body_inertia: NDArray  # (nq,3) diagonal
    sites: Tuple[SiteSpec, ...]
    cameras: Tuple[CameraSpec, ...]
    fingertips: Tuple[FingertipSpec, ...]
    ancestors: NDArray  # (nq,nq) bool: ancestors[i,j] == joint j moves joint i
    home_qpos: NDArray  # (nq,)
    mocap_pos0: NDArray  # (n_mocap,3)
    mocap_quat0: NDArray  # (n_mocap,4)
    meshes: Tuple[MeshGeomSpec, ...] = ()
    # per-device tensors derived from the fields above (not part of the spec)
    cache: Dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def site(self, name: str) -> SiteSpec:
        for s in self.sites:
            if s.name == name:
                return s
        raise KeyError(name)

    def site_index(self, name: str) -> int:
        for i, s in enumerate(self.sites):
            if s.name == name:
                return i
        raise KeyError(name)

    def camera(self, name: str) -> CameraSpec:
        for c in self.cameras:
            if c.name == name:
                return c
        raise KeyError(name)


_F32 = np.float32


def _quat_mul_f32(a: NDArray, b: NDArray) -> NDArray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dtype=_F32)


def _cross_f32(a: NDArray, b: NDArray) -> NDArray:
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], dtype=_F32)


def _quat_rotate_f32(q: NDArray, v: NDArray) -> NDArray:
    uv = _cross_f32(q[1:], v)
    return v + _F32(2.0) * (q[:1] * uv + _cross_f32(q[1:], uv))


def _normalized_f32(q: NDArray) -> NDArray:
    """q / |q| in float32, the squares summed in order."""
    sq = q * q
    return q / np.sqrt(((sq[0] + sq[1]) + sq[2]) + sq[3])


def _compose(frames: List[Tuple[NDArray, NDArray]]) -> Tuple[NDArray, NDArray]:
    """Compose a chain of (pos, quat) frames into one transform.

    The robots' tables (models/_chains.py) are composed with float32
    quaternion products, each frame's quaternion normalized in float64
    first and the positions summed in float64, as the shipped assets hold
    them. Every step is one IEEE float32 or float64 operation in a fixed
    order, so the result is the same on every host."""
    pos = np.zeros(3)
    quat = np.array([1.0, 0.0, 0.0, 0.0], dtype=_F32)
    for p, q in frames:
        q = np.asarray(q, dtype=np.float64)
        q = (q / np.linalg.norm(q)).astype(_F32)
        pos = pos + _quat_rotate_f32(quat, np.asarray(p, dtype=np.float64).astype(_F32))
        quat = _quat_mul_f32(quat, q)
    return pos, _normalized_f32(quat)


def quat_from_euler_xyz_np(e) -> NDArray:
    """MJCF <body euler> (extrinsic xyz) -> wxyz quat."""
    return rot.euler_xyz_to_quat_np(e)


def quat_from_euler_xyz_f32(e) -> NDArray:
    """`quat_from_euler_xyz_np` in float32, the arithmetic of the robots'
    tables: the angles rounded to float32, each half angle's cosine and
    sine rounded from float64."""
    half = _F32(0.5) * np.asarray(np.asarray(e, dtype=np.float64), dtype=_F32)
    c = np.cos(half.astype(np.float64)).astype(_F32)
    s = np.sin(half.astype(np.float64)).astype(_F32)
    z = _F32(0.0)
    qx = np.array([c[0], s[0], z, z], dtype=_F32)
    qy = np.array([c[1], z, s[1], z], dtype=_F32)
    qz = np.array([c[2], z, z, s[2]], dtype=_F32)
    return _quat_mul_f32(qz, _quat_mul_f32(qy, qx))


def _mass_class(name: str) -> str:
    if "slider" in name:
        return "slider"
    if name.startswith("joint_head"):
        return "head"
    for c in ("x8", "x6", "x4"):
        if f"_{c}_" in name:
            return c
    return "x4"


def build_model(
    name: str,
    joints: List[dict],
    sites: List[dict],
    cameras: List[dict],
    fingertips: List[dict],
    actuators: List[dict],
    home_qpos: NDArray,
    mocap_pos0: NDArray,
    mocap_quat0: NDArray,
    meshes: Tuple = (),
) -> RobotModel:
    """Assemble a RobotModel from per-joint dict records.

    Each joint record: {name, parent, type, range, frictionloss?} plus
    either a precomposed `pos`/`quat` or `frames`, the chain of body
    transforms from the parent joint's body down to this joint's body.
    """
    nq = len(joints)
    parent = np.array([j["parent"] for j in joints], dtype=np.int32)
    jnt_pos = np.zeros((nq, 3))
    jnt_quat = np.zeros((nq, 4))
    for i, j in enumerate(joints):
        if "pos" in j and "quat" in j:
            p, q = j["pos"], j["quat"]
        else:
            p, q = _compose(j["frames"])
        jnt_pos[i] = p
        jnt_quat[i] = q
    jnt_type = np.array(
        [SLIDE if j.get("type") == "slide" else HINGE for j in joints], dtype=np.int32
    )
    jnt_range = np.array([j["range"] for j in joints])
    jnt_frictionloss = np.array([j.get("frictionloss", 0.0) for j in joints])

    ancestors = np.zeros((nq, nq), dtype=bool)
    for i in range(nq):
        a = i
        while a >= 0:
            ancestors[i, a] = True
            a = int(parent[a])

    joint_names = tuple(j["name"] for j in joints)
    cls = [_mass_class(n) for n in joint_names]
    body_mass = np.array(
        [j.get("mass", _MASS_BY_CLASS[c]) for j, c in zip(joints, cls)]
    )
    armature = np.array(
        [j.get("armature", _ARMATURE_BY_CLASS[c]) for j, c in zip(joints, cls)]
    )
    est_com = np.tile(np.array([0.0, 0.0, -0.05]), (nq, 1))
    est_com[jnt_type == SLIDE] = np.array([0.0, 0.0, -0.02])
    body_com = np.array(
        [np.asarray(j.get("com", est_com[i]), dtype=np.float64)
         for i, j in enumerate(joints)]
    )
    body_inertia = np.array(
        [np.asarray(
            j.get("inertia", body_mass[i] * _GYRATION_RADIUS**2 * np.ones(3)),
            dtype=np.float64,
        ) for i, j in enumerate(joints)]
    )

    actuator_kp = np.array([a["kp"] for a in actuators])
    actuator_kv = np.array([a.get("kv", 0.0) for a in actuators])
    ctrl_range = np.array([a["ctrlrange"] for a in actuators])
    force_range = np.array(
        [a.get("forcerange", (-np.inf, np.inf)) for a in actuators]
    )

    site_specs = tuple(
        SiteSpec(
            s["name"],
            s["parent"],
            np.asarray(s["pos"], dtype=np.float64),
            np.asarray(s.get("quat", (1.0, 0, 0, 0)), dtype=np.float64),
        )
        for s in sites
    )
    cam_specs = tuple(
        CameraSpec(
            c["name"],
            c.get("parent", -1),
            np.asarray(c["pos"], dtype=np.float64),
            float(c["fovy"]),
            c.get("target_site"),
            np.asarray(c["target_world"], dtype=np.float64)
            if c.get("target_world") is not None
            else None,
        )
        for c in cameras
    )
    tip_specs = tuple(
        FingertipSpec(
            f["parent"],
            np.asarray(f["pos"], dtype=np.float64),
            float(f.get("radius", 0.008)),
            f["side"],
        )
        for f in fingertips
    )

    return RobotModel(
        name=name,
        nq=nq,
        nu=len(actuators),
        joint_names=joint_names,
        parent=parent,
        jnt_pos=jnt_pos,
        jnt_quat=jnt_quat,
        jnt_type=jnt_type,
        jnt_range=jnt_range,
        jnt_frictionloss=jnt_frictionloss,
        armature=armature,
        actuator_kp=actuator_kp,
        actuator_kv=actuator_kv,
        ctrl_range=ctrl_range,
        force_range=force_range,
        body_mass=body_mass,
        body_com=body_com,
        body_inertia=body_inertia,
        sites=site_specs,
        cameras=cam_specs,
        fingertips=tip_specs,
        ancestors=ancestors,
        home_qpos=np.asarray(home_qpos, dtype=np.float64),
        mocap_pos0=np.asarray(mocap_pos0, dtype=np.float64),
        mocap_quat0=np.asarray(mocap_quat0, dtype=np.float64),
        meshes=tuple(meshes),
    )
