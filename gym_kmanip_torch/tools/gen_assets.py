"""Emit the port's MJCF assets from the robots' tables.

Port of the JAX package's `tools/gen_assets.py`. The three robots ship as
self-contained, mesh-free MJCF files (scene, robot tree, inertials, home
keyframe, cube and mocap bodies), `gym_kmanip_torch/assets/{solo_arm,
dual_arm,torso}.xml`, which `models/mjcf.py` loads into the RobotModel
every other layer runs on and which MuJoCo can also compile. This tool
serializes the hand-derived tables of `models/_chains.py`
(`models._table_models()`) into those files, byte for byte the JAX
package's assets. It round-trips each file through the port's loader,
bit-exact, and compiles it with MuJoCo where `mujoco` imports.

    python -m gym_kmanip_torch.tools.gen_assets
"""

import os
import xml.etree.ElementTree as ET

import numpy as np

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.models import spec as spec_mod

OUT_DIR = k.ASSETS_DIR


def _fmt(x) -> str:
    # %.17g: a bit-exact float64 round trip. The env's host IK replays a
    # scipy TRF whose iterate path (and so the recorded golden traces) is
    # sensitive to model values at the last bit: 9 significant digits
    # moved the solo and dual parity from ~8e-4 rad to 0.68.
    arr = np.atleast_1d(np.asarray(x, dtype=np.float64))
    return " ".join(f"{float(v):.17g}" for v in arr)


def _scene(world: ET.Element, model) -> None:
    """Table, lighting, world cameras, free cube, mocap hand targets."""
    ET.SubElement(world, "light", dict(pos="0 0 3", dir="0 0 -1"))
    for cam in model.cameras:
        if cam.parent == -1:
            ET.SubElement(
                world, "camera",
                dict(name=cam.name, pos=_fmt(cam.pos), fovy=_fmt(cam.fovy),
                     mode="targetbody", target="table"),
            )
    table = ET.SubElement(world, "body", dict(name="table", pos=_fmt(k.TABLE_POS)))
    half_z = (k.TABLE_TOP_Z - k.TABLE_POS[2]) if k.TABLE_TOP_Z > k.TABLE_POS[2] else 0.05
    ET.SubElement(
        table, "geom",
        dict(name="table", type="box",
             size=f"{k.TABLE_HALF_X} {k.TABLE_HALF_Y} {half_z / 2}",
             pos=f"0 0 {half_z / 2}", rgba="0.55 0.42 0.28 1"),
    )
    for i in range(model.mocap_pos0.shape[0]):
        name = "hand_r" if i == k.MOCAP_ID_R else "hand_l"
        hand = ET.SubElement(
            world, "body",
            dict(name=name, mocap="true", pos=_fmt(model.mocap_pos0[i]),
                 quat=_fmt(model.mocap_quat0[i])),
        )
        ET.SubElement(
            hand, "site",
            dict(name=f"{name}_site", type="sphere", size="0.01", rgba="1 0 0 0.3"),
        )
    # the free cube goes last, so its 7 qpos values trail the robot's in the
    # keyframe (MuJoCo's qpos follows document order)
    cube = ET.SubElement(world, "body", dict(name="cube", pos=_fmt(k.CUBE_INIT_POS)))
    ET.SubElement(cube, "freejoint", dict(name="cube_free"))
    ET.SubElement(
        cube, "geom",
        dict(name="cube", type="box", size=_fmt([k.CUBE_HALF_SIZE] * 3),
             mass=_fmt(k.CUBE_MASS), friction=_fmt(k.CUBE_FRICTION),
             solref=f"{k.CONTACT_TIMECONST} 1", rgba="0.8 0.2 0.2 1"),
    )


def _robot(world: ET.Element, model) -> None:
    children = {i: [] for i in range(-1, model.nq)}
    for i in range(model.nq):
        children[int(model.parent[i])].append(i)

    def emit(parent_el: ET.Element, i: int) -> None:
        jname = model.joint_names[i]
        body = ET.SubElement(
            parent_el, "body",
            dict(name=f"body_{jname}", pos=_fmt(model.jnt_pos[i]),
                 quat=_fmt(model.jnt_quat[i])),
        )
        ET.SubElement(
            body, "inertial",
            dict(pos=_fmt(model.body_com[i]), mass=_fmt(model.body_mass[i]),
                 diaginertia=_fmt(model.body_inertia[i])),
        )
        jtype = "slide" if model.jnt_type[i] == spec_mod.SLIDE else "hinge"
        ET.SubElement(
            body, "joint",
            dict(name=jname, type=jtype, pos="0 0 0", axis="0 0 1",
                 range=_fmt(model.jnt_range[i]),
                 frictionloss=_fmt(model.jnt_frictionloss[i]),
                 armature=_fmt(model.armature[i])),
        )
        for t_idx, tip in enumerate(model.fingertips):
            if tip.parent == i:
                ET.SubElement(
                    body, "geom",
                    dict(name=f"tip_{tip.side}_{t_idx}", type="sphere",
                         size=_fmt(tip.radius), pos=_fmt(tip.pos), rgba="0.2 0.2 0.2 1"),
                )
        for s in model.sites:
            if s.parent == i:
                marker = ET.SubElement(
                    body, "body", dict(name=s.name, pos=_fmt(s.pos), quat=_fmt(s.quat)),
                )
                ET.SubElement(
                    marker, "site",
                    dict(name=s.name, type="sphere", size="0.005", rgba="0 1 0 0.5"),
                )
        for cam in model.cameras:
            if cam.parent == i:
                ET.SubElement(
                    body, "camera",
                    dict(name=cam.name, pos=_fmt(cam.pos), fovy=_fmt(cam.fovy),
                         mode="targetbody", target=cam.target_site),
                )
        for c in children[i]:
            emit(body, c)

    for r in children[-1]:
        emit(world, r)


def build_asset_xml(model) -> str:
    """The MJCF text of `model`: robot tree, scene, actuators, keyframe."""
    root = ET.Element("mujoco", dict(model=model.name))
    ET.SubElement(root, "option", dict(timestep=_fmt(k.PHYSICS_TIMESTEP), gravity="0 0 -9.81"))
    world = ET.SubElement(root, "worldbody")
    _robot(world, model)
    _scene(world, model)
    act = ET.SubElement(root, "actuator")
    for i in range(model.nu):
        attrs = dict(
            name=f"act_{model.joint_names[i]}", joint=model.joint_names[i],
            kp=_fmt(model.actuator_kp[i]), ctrlrange=_fmt(model.ctrl_range[i]),
        )
        if np.all(np.isfinite(model.force_range[i])):
            attrs["forcerange"] = _fmt(model.force_range[i])
        ET.SubElement(act, "position", attrs)
    kf = ET.SubElement(root, "keyframe")
    cube_qpos = np.concatenate([k.CUBE_INIT_POS, [1.0, 0, 0, 0]])
    ET.SubElement(
        kf, "key", dict(name="home", qpos=_fmt(np.concatenate([model.home_qpos, cube_qpos]))),
    )
    ET.indent(root)
    return ET.tostring(root, encoding="unicode") + "\n"


def check_round_trip(path: str, model) -> None:
    """The file at `path` loads back into `model`'s values, bit for bit."""
    from gym_kmanip_torch.models.mjcf import load_mjcf

    loaded = load_mjcf(path, name=model.name)
    assert loaded.nq == model.nq and loaded.nu == model.nu, model.name
    for field in ("jnt_pos", "jnt_quat", "home_qpos", "body_mass", "body_com",
                  "body_inertia", "armature", "jnt_range"):
        np.testing.assert_array_equal(getattr(loaded, field), getattr(model, field),
                                      err_msg=f"{model.name}.{field}")
    for s in model.sites:
        np.testing.assert_array_equal(loaded.site(s.name).pos, s.pos)
        np.testing.assert_array_equal(loaded.site(s.name).quat, s.quat)
    assert loaded.joint_names == model.joint_names, model.name


def main(out_dir: str = OUT_DIR) -> None:
    # built from the tables directly, not through the registry, so that
    # regeneration never reads what it is about to write
    from gym_kmanip_torch.models import _table_models

    os.makedirs(out_dir, exist_ok=True)
    for name, builder in _table_models().items():
        model = builder()
        path = os.path.join(out_dir, f"{name}.xml")
        with open(path, "w") as f:
            f.write(build_asset_xml(model))
        check_round_trip(path, model)
        print(f"wrote {path}: nq={model.nq} nu={model.nu}, round-trip OK")
        try:
            import mujoco
        except ImportError:
            continue
        mujoco.MjModel.from_xml_path(path)
        print("  mujoco compile check OK")


if __name__ == "__main__":
    main()
