"""Robot model registry, the carry-across from other model objects, and the
per-device model tensors.

The three Stompy robots are read from the port's shipped MJCF files
(`gym_kmanip_torch/assets/{solo_arm,dual_arm,torso}.xml`) through the
port's own loader. Those files are generated from the hand-derived tables
in `models/_chains.py` (`_table_models()`, `tools/gen_assets.py`), byte
for byte the JAX package's assets, so the port rebuilds and changes a
robot without JAX.
"""

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.models.spec import (  # noqa: F401 (re-exported)
    HINGE,
    SLIDE,
    CameraSpec,
    FingertipSpec,
    MeshGeomSpec,
    RobotModel,
    SiteSpec,
    build_model,
)


@functools.lru_cache(maxsize=None)
def _from_asset(name: str) -> RobotModel:
    from gym_kmanip_torch.models.mjcf import load_mjcf

    return load_mjcf(os.path.join(k.ASSETS_DIR, f"{name}.xml"), name=name)


def solo_arm() -> RobotModel:
    return _from_asset("solo_arm")


def dual_arm() -> RobotModel:
    return _from_asset("dual_arm")


def torso() -> RobotModel:
    return _from_asset("torso")


def _table_models():
    """The builders of the three robots from the `_chains` tables (the
    source `tools/gen_assets.py` writes the assets from), by short name."""
    from gym_kmanip_torch.models import _chains as ch
    from gym_kmanip_torch.models.spec import quat_from_euler_xyz_f32

    base_r = [((0, 0, 0.5), ch.IDENT), ((0.5, 0.6, 0), ch.IDENT)]
    base_l = [((0, 0, 0.5), ch.IDENT), ((-0.5, 0.6, 0), ch.IDENT)]

    def _grip_cam(name, parent, target):
        return dict(name=name, parent=parent, pos=(0, 0.05, 0), fovy=20, target_site=target)

    def solo():
        return build_model(
            name="solo_arm",
            joints=ch.right_arm_joints(base_r, 0),
            sites=[ch.right_arm_site(0)],
            cameras=ch.world_cameras() + [_grip_cam("grip_r", 6, "eer_site")],
            fingertips=ch.right_arm_fingertips(0),
            actuators=ch.right_arm_actuators(),
            home_qpos=k.Q_SOLO_ARM_HOME,
            mocap_pos0=np.array([[0.2, 0.6, 0.6]]),
            mocap_quat0=np.array([[1.0, 0, 0, 0]]),
        )

    def dual():
        return build_model(
            name="dual_arm",
            joints=ch.right_arm_joints(base_r, 0) + ch.left_arm_joints(base_l, 10),
            sites=[ch.right_arm_site(0), ch.left_arm_site(10)],
            cameras=ch.world_cameras()
            + [_grip_cam("grip_r", 6, "eer_site"), _grip_cam("grip_l", 16, "eel_site")],
            fingertips=ch.right_arm_fingertips(0) + ch.left_arm_fingertips(10),
            actuators=ch.right_arm_actuators() + ch.left_arm_actuators(),
            home_qpos=k.Q_DUAL_ARM_HOME,
            mocap_pos0=np.array([[0.2, 0.6, 0.6], [-0.2, 0.6, 0.6]]),
            mocap_quat0=np.array([[1.0, 0, 0, 0], [1.0, 0, 0, 0]]),
        )

    def torso_m():
        root_frames = [
            ((0, 0.2, 0.7), ch.IDENT),
            ((0, 0, 0), quat_from_euler_xyz_f32((0, 0, 3.1416))),
        ]
        return build_model(
            name="torso",
            joints=ch.torso_joints(root_frames),
            sites=ch.torso_sites(),
            cameras=ch.world_cameras()
            + [_grip_cam("grip_r", 10, "eer_site"), _grip_cam("grip_l", 19, "eel_site")],
            fingertips=ch.torso_fingertips(),
            actuators=ch.torso_actuators(),
            home_qpos=k.Q_TORSO_HOME,
            mocap_pos0=np.array([[0.2, 0.6, 0.6], [-0.2, 0.6, 0.6]]),
            mocap_quat0=np.array([[1.0, 0, 0, 0], [1.0, 0, 0, 0]]),
        )

    return {"solo_arm": solo, "dual_arm": dual, "torso": torso_m}


_REGISTRY = {
    k.SOLO_ARM_MJCF: solo_arm,
    k.DUAL_ARM_MJCF: dual_arm,
    k.TORSO_MJCF: torso,
    "solo_arm": solo_arm,
    "dual_arm": dual_arm,
    "torso": torso,
}


def get_model(key: str) -> RobotModel:
    """Built-in robot by MJCF filename or short name, or a user robot by
    path to any MJCF file the loader subset covers."""
    fn = _REGISTRY.get(key)
    if fn is not None:
        return fn()
    if os.path.exists(key):
        from gym_kmanip_torch.models.mjcf import load_mjcf

        return load_mjcf(key)
    raise KeyError(key)


def _arr(a, dtype=np.float64):
    return None if a is None else np.array(a, dtype=dtype)


def from_numpy_model(m) -> RobotModel:
    """The port's RobotModel from any object with the JAX `RobotModel`'s
    fields (numpy arrays or array-likes), so two implementations can
    compute on identical constants."""
    return RobotModel(
        name=m.name,
        nq=int(m.nq),
        nu=int(m.nu),
        joint_names=tuple(m.joint_names),
        parent=_arr(m.parent, np.int32),
        jnt_pos=_arr(m.jnt_pos),
        jnt_quat=_arr(m.jnt_quat),
        jnt_type=_arr(m.jnt_type, np.int32),
        jnt_range=_arr(m.jnt_range),
        jnt_frictionloss=_arr(m.jnt_frictionloss),
        armature=_arr(m.armature),
        actuator_kp=_arr(m.actuator_kp),
        actuator_kv=_arr(m.actuator_kv),
        ctrl_range=_arr(m.ctrl_range),
        force_range=_arr(m.force_range),
        body_mass=_arr(m.body_mass),
        body_com=_arr(m.body_com),
        body_inertia=_arr(m.body_inertia),
        sites=tuple(
            SiteSpec(s.name, int(s.parent), _arr(s.pos), _arr(s.quat))
            for s in m.sites
        ),
        cameras=tuple(
            CameraSpec(c.name, int(c.parent), _arr(c.pos), float(c.fovy),
                       c.target_site, _arr(c.target_world))
            for c in m.cameras
        ),
        fingertips=tuple(
            FingertipSpec(int(t.parent), _arr(t.pos), float(t.radius), t.side)
            for t in m.fingertips
        ),
        ancestors=_arr(m.ancestors, bool),
        home_qpos=_arr(m.home_qpos),
        mocap_pos0=_arr(m.mocap_pos0),
        mocap_quat0=_arr(m.mocap_quat0),
        meshes=tuple(
            MeshGeomSpec(g.name, int(g.parent), _arr(g.tris, np.float32))
            for g in getattr(m, "meshes", ())
        ),
    )


class ModelTensors(NamedTuple):
    """float32 (and bool/long) tensors of one model on one device."""

    jnt_pos: torch.Tensor  # (nq,3)
    jnt_quat: torch.Tensor  # (nq,4)
    is_slide: torch.Tensor  # (nq,) bool
    jnt_lo: torch.Tensor  # (nq,)
    jnt_hi: torch.Tensor  # (nq,)
    frictionloss: torch.Tensor  # (nq,)
    armature: torch.Tensor  # (nq,)
    kp: torch.Tensor  # (nu,)
    kp_full: torch.Tensor  # (nq,) kp zero-padded to nq
    force_lo: torch.Tensor  # (nu,)
    force_hi: torch.Tensor  # (nu,)
    ctrl_lo: torch.Tensor  # (nu,)
    ctrl_hi: torch.Tensor  # (nu,)
    body_mass: torch.Tensor  # (nq,)
    body_com: torch.Tensor  # (nq,3)
    body_inertia: torch.Tensor  # (nq,3)
    ancestors: torch.Tensor  # (nq,nq) float 0/1
    site_parent: torch.Tensor  # (S,) long
    site_pos: torch.Tensor  # (S,3)
    site_quat: torch.Tensor  # (S,4)
    tip_parent: torch.Tensor  # (T,) long
    tip_pos: torch.Tensor  # (T,3)
    tip_radius: torch.Tensor  # (T,)
    tip_right: torch.Tensor  # (T,) bool
    tip_left: torch.Tensor  # (T,) bool


def canonical_device(device) -> torch.device:
    """`cuda` -> `cuda:<current>`, so one card has one cache key. Raises
    if a CUDA device is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def model_tensors(model: RobotModel, device) -> ModelTensors:
    """The model's constants as tensors on `device`, built once per
    (model, device) and cached on the model."""
    device = canonical_device(device)
    key = ("tensors", str(device))
    t = model.cache.get(key)
    if t is not None:
        return t

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    nq, nu = model.nq, model.nu
    kp_full = np.zeros(nq)
    kp_full[:nu] = model.actuator_kp
    tips = model.fingertips
    t = ModelTensors(
        jnt_pos=f32(model.jnt_pos),
        jnt_quat=f32(model.jnt_quat),
        is_slide=torch.as_tensor(model.jnt_type == SLIDE, device=device),
        jnt_lo=f32(model.jnt_range[:, 0]),
        jnt_hi=f32(model.jnt_range[:, 1]),
        frictionloss=f32(model.jnt_frictionloss),
        armature=f32(model.armature),
        kp=f32(model.actuator_kp),
        kp_full=f32(kp_full),
        force_lo=f32(model.force_range[:, 0]),
        force_hi=f32(model.force_range[:, 1]),
        ctrl_lo=f32(model.ctrl_range[:, 0]),
        ctrl_hi=f32(model.ctrl_range[:, 1]),
        body_mass=f32(model.body_mass),
        body_com=f32(model.body_com),
        body_inertia=f32(model.body_inertia),
        ancestors=f32(model.ancestors),
        site_parent=torch.as_tensor([s.parent for s in model.sites],
                                    dtype=torch.long, device=device),
        site_pos=f32(np.reshape([s.pos for s in model.sites], (-1, 3))),
        site_quat=f32(np.reshape([s.quat for s in model.sites], (-1, 4))),
        tip_parent=torch.as_tensor([tp.parent for tp in tips],
                                   dtype=torch.long, device=device),
        tip_pos=f32(np.reshape([tp.pos for tp in tips], (-1, 3))),
        tip_radius=f32([tp.radius for tp in tips]),
        tip_right=torch.as_tensor([tp.side == "r" for tp in tips],
                                  dtype=torch.bool, device=device),
        tip_left=torch.as_tensor([tp.side == "l" for tp in tips],
                                 dtype=torch.bool, device=device),
    )
    model.cache[key] = t
    return t


class SceneTensors(NamedTuple):
    """Constants of the scene (not of a robot) as float32 tensors."""

    gravity: torch.Tensor  # (3,)
    ez: torch.Tensor  # (3,) local z, the joint axis
    cube_corners: torch.Tensor  # (8, 3) in the cube frame, x-major signs * half size


def scene_tensors(device) -> SceneTensors:
    """The scene constants on `device`, built once per device, so the
    solve path copies nothing from the host."""
    return _scene_tensors(canonical_device(device))


@functools.lru_cache(maxsize=None)
def _scene_tensors(device: torch.device) -> SceneTensors:
    signs = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
    return SceneTensors(
        gravity=torch.tensor(k.GRAVITY, dtype=torch.float32, device=device),
        ez=torch.tensor([0.0, 0.0, 1.0], device=device),
        cube_corners=torch.tensor(signs, device=device) * k.CUBE_HALF_SIZE,
    )
