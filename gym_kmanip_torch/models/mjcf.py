"""MJCF-subset loader: robot XML -> static RobotModel (numpy and xml.etree).

Port of `gym_kmanip_tpu/models/mjcf.py`, the same subset:
  * <include> resolution and top-level section merging
  * nested <body> with pos / quat / euler, mocap bodies
  * <joint> hinge (default) and slide, pos=0 axis=z, range, frictionloss,
    armature
  * <inertial> (mass / pos / diaginertia)
  * the eer_site / eel_site marker bodies
  * sphere <geom name="tip_{r|l}..."> -> FingertipSpec collision spheres
  * <camera> fixed or mode="targetbody"
  * <position> actuators: kp, ctrlrange, forcerange, joint mapping
  * <keyframe><key name="home" qpos=.../> -> home_qpos (first nq values)
  * <asset><mesh file scale> + <geom type="mesh"> -> MeshGeomSpec
Other geoms are ignored.
"""

import os
import warnings
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np
from numpy.typing import NDArray

from gym_kmanip_torch.models.spec import (
    MeshGeomSpec, RobotModel, build_model, quat_from_euler_xyz_np,
)
from gym_kmanip_torch.utils.rotations import (
    quat_mul_np, quat_rotate_np, quat_to_mat_np,
)

# triangle budget per mesh geom; larger meshes are strided down
MAX_MESH_TRIS = 1024

_EE_SITE_BODIES = ("eer_site", "eel_site")


def load_stl(path: str, scale=(1.0, 1.0, 1.0), max_tris: int = MAX_MESH_TRIS
             ) -> NDArray:
    """Binary or ASCII STL -> (T, 3, 3) float32 triangle array."""
    scale = np.asarray(scale, np.float64)
    with open(path, "rb") as f:
        head = f.read(84)
        if len(head) >= 84 and not head[:5].lower().startswith(b"solid"):
            n = int.from_bytes(head[80:84], "little")
            rec = np.frombuffer(f.read(n * 50), dtype=np.uint8)
            if rec.size < n * 50:
                raise ValueError(f"{path}: truncated binary STL")
            rec = rec.reshape(n, 50)
            tris = (
                rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3).astype(np.float64)
            )
        else:
            f.seek(0)
            verts = []
            for line in f.read().decode("ascii", "replace").splitlines():
                parts = line.split()
                if parts[:1] == ["vertex"]:
                    verts.append([float(v) for v in parts[1:4]])
            if len(verts) % 3 != 0:
                raise ValueError(f"{path}: malformed ASCII STL")
            tris = np.asarray(verts, np.float64).reshape(-1, 3, 3)
    tris = tris * scale[None, None, :]
    if tris.shape[0] > max_tris:
        stride = int(np.ceil(tris.shape[0] / max_tris))
        tris = tris[::stride]
    return tris.astype(np.float32)


def _parse_vec(s: Optional[str], default):
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in s.split()], dtype=np.float64)


def _body_frame(body: ET.Element, normalize: bool = True) -> Tuple[NDArray, NDArray]:
    """`normalize=False` keeps a quat exactly as written (the shipped site
    markers carry deliberately unnormalized quats)."""
    pos = _parse_vec(body.get("pos"), (0.0, 0, 0))
    if body.get("quat") is not None:
        quat = _parse_vec(body.get("quat"), (1.0, 0, 0, 0))
        if normalize:
            quat = quat / np.linalg.norm(quat)
    elif body.get("euler") is not None:
        quat = quat_from_euler_xyz_np(_parse_vec(body.get("euler"), (0.0, 0, 0)))
    else:
        quat = np.array([1.0, 0, 0, 0])
    return pos, quat


def _chain(frames, normalize: bool) -> Tuple[NDArray, NDArray]:
    """Compose (pos, quat) frames in float64; a single frame passes through
    bit-exactly."""
    if len(frames) == 1:
        return (np.asarray(frames[0][0], dtype=np.float64),
                np.asarray(frames[0][1], dtype=np.float64))
    p, q = np.zeros(3), np.array([1.0, 0, 0, 0])
    for fp, fq in frames:
        fq = np.asarray(fq, dtype=np.float64)
        if normalize:
            fq = fq / np.linalg.norm(fq)
        p = p + quat_rotate_np(q, fp)
        q = quat_mul_np(q, fq)
    return p, q


def resolve_includes(path: str) -> ET.Element:
    """Flatten <include file=.../> elements (MuJoCo merge semantics)."""
    base = os.path.dirname(path)
    root = ET.parse(path).getroot()

    def expand(elem: ET.Element):
        for child in list(elem):
            if child.tag == "include":
                sub = resolve_includes(os.path.join(base, child.attrib["file"]))
                idx = list(elem).index(child)
                elem.remove(child)
                for j, sc in enumerate(list(sub)):
                    elem.insert(idx + j, sc)
            else:
                expand(child)

    expand(root)
    for tag in ("worldbody", "asset", "actuator", "visual", "option"):
        sections = root.findall(tag)
        for extra in sections[1:]:
            for ch in list(extra):
                sections[0].append(ch)
            root.remove(extra)
    return root


def _load_meshes(root: ET.Element, path: str) -> Dict[str, NDArray]:
    xml_dir = os.path.dirname(os.path.abspath(path))
    compiler = root.find("compiler")
    meshdir = compiler.get("meshdir", "") if compiler is not None else ""
    mesh_assets: Dict[str, NDArray] = {}
    asset = root.find("asset")
    if asset is None:
        return mesh_assets
    for mel in asset.findall("mesh"):
        mname = mel.get("name") or os.path.splitext(
            os.path.basename(mel.get("file", "")))[0]
        mfile = os.path.join(xml_dir, meshdir, mel.get("file", ""))
        scale = _parse_vec(mel.get("scale"), (1.0, 1.0, 1.0))
        try:
            mesh_assets[mname] = load_stl(mfile, scale=scale)
        except (OSError, ValueError) as e:
            warnings.warn(
                f"mesh asset '{mname}' unavailable ({e}); geometry "
                "falls back to the capsule approximation",
                RuntimeWarning,
            )
    return mesh_assets


def _camera(cam: ET.Element, parent: int) -> dict:
    targeted = cam.get("mode") == "targetbody"
    on_site = targeted and cam.get("target") in _EE_SITE_BODIES
    return dict(
        name=cam.get("name"),
        parent=parent,
        pos=_parse_vec(cam.get("pos"), (0.0, 0, 0)),
        fovy=float(cam.get("fovy", 45.0)),
        target_site=cam.get("target") if on_site else None,
        target_world=np.array([0.0, 0.6, 0.5]) if targeted and not on_site else None,
    )


def load_mjcf(
    path: str,
    home_qpos: Optional[NDArray] = None,
    fingertips: Optional[List[dict]] = None,
    name: Optional[str] = None,
) -> RobotModel:
    """Parse an MJCF file (with includes) into a RobotModel."""
    root = resolve_includes(path)
    wb = root.find("worldbody")
    if wb is None:
        raise ValueError(f"{path}: no <worldbody>")
    mesh_assets = _load_meshes(root, path)

    meshes: List[MeshGeomSpec] = []
    joints: List[dict] = []
    sites: List[dict] = []
    cameras: List[dict] = []
    tips: List[dict] = []
    mocap_pos: List[NDArray] = []
    mocap_quat: List[NDArray] = []
    jname_to_idx: Dict[str, int] = {}

    def walk(body: ET.Element, parent_joint: int, frames: List):
        """frames = accumulated (pos, quat) since the last joint body."""
        if body.get("mocap") == "true":
            p, q = _body_frame(body)
            mocap_pos.append(p)
            mocap_quat.append(q)
            return
        bname = body.get("name", "")
        p, q = _body_frame(body, normalize=False)
        my_frames = frames + [(p, q)]

        jel = body.find("joint")
        if body.find("freejoint") is not None or (
            jel is not None and jel.get("type") == "free"
        ):
            return  # free bodies (the cube) live in the engine, not the tree
        if jel is not None:
            jpos = _parse_vec(jel.get("pos"), (0.0, 0, 0))
            jaxis = _parse_vec(jel.get("axis"), (0.0, 0, 1.0))
            if not (np.allclose(jpos, 0) and np.allclose(jaxis, (0, 0, 1))):
                raise ValueError(
                    f"{jel.get('name')}: only pos=0 axis=z joints supported"
                )
            idx = len(joints)
            jp, jq = _chain(my_frames, normalize=True)
            if len(my_frames) > 1:
                jq = jq / np.linalg.norm(jq)
            jrec = dict(
                name=jel.get("name", f"joint_{idx}"),
                parent=parent_joint,
                pos=jp,
                quat=jq,
                type=jel.get("type", "hinge"),
                range=tuple(_parse_vec(jel.get("range"), (0.0, 0.0))),
                frictionloss=float(jel.get("frictionloss", 0.0)),
            )
            if jel.get("armature") is not None:
                jrec["armature"] = float(jel.get("armature"))
            ine = body.find("inertial")
            if ine is not None:
                jrec["mass"] = float(ine.get("mass"))
                jrec["com"] = _parse_vec(ine.get("pos"), (0.0, 0, 0))
                if ine.get("diaginertia") is not None:
                    jrec["inertia"] = _parse_vec(ine.get("diaginertia"), None)
            joints.append(jrec)
            jname_to_idx[jrec["name"]] = idx
            parent_joint, my_frames = idx, []

        for geom in body.findall("geom"):
            gname = geom.get("name", "")
            if geom.get("type") == "sphere" and gname.startswith("tip_"):
                tips.append(
                    dict(
                        parent=parent_joint,
                        pos=_parse_vec(geom.get("pos"), (0.0, 0, 0)),
                        radius=float(geom.get("size", "0.008").split()[0]),
                        side=gname.split("_")[1],
                    )
                )
            elif (geom.get("type") == "mesh" or geom.get("mesh")) and \
                    geom.get("mesh") in mesh_assets:
                cp, cq = np.zeros(3), np.array([1.0, 0, 0, 0])
                for fp, fq in my_frames:
                    fq64 = np.asarray(fq, np.float64)
                    cp = cp + quat_rotate_np(cq, fp)
                    cq = quat_mul_np(cq, fq64 / np.linalg.norm(fq64))
                gp = _parse_vec(geom.get("pos"), (0.0, 0, 0))
                if geom.get("quat") is not None:
                    gq = _parse_vec(geom.get("quat"), None)
                elif geom.get("euler") is not None:
                    gq = quat_from_euler_xyz_np(_parse_vec(geom.get("euler"), None))
                else:
                    gq = np.array([1.0, 0, 0, 0])
                gq = gq / np.linalg.norm(gq)
                cp = cp + quat_rotate_np(cq, gp)
                cq = quat_mul_np(cq, gq)
                tris = mesh_assets[geom.get("mesh")].astype(np.float64)
                tris = tris @ quat_to_mat_np(cq).T + cp[None, None, :]
                meshes.append(
                    MeshGeomSpec(
                        name=gname or geom.get("mesh"),
                        parent=parent_joint,
                        tris=tris.astype(np.float32),
                    )
                )

        if bname in _EE_SITE_BODIES:
            cp, cq = _chain(my_frames, normalize=False)
            sites.append(dict(name=bname, parent=parent_joint, pos=cp, quat=cq))

        for cam in body.findall("camera"):
            cameras.append(_camera(cam, parent_joint))

        for child in body.findall("body"):
            walk(child, parent_joint, my_frames)

    for top in wb.findall("body"):
        walk(top, -1, [])
    for cam in wb.findall("camera"):
        c = _camera(cam, -1)
        c.update(target_site=None, target_world=np.array([0.0, 0.6, 0.5]))
        cameras.append(c)

    actuators_by_joint: Dict[int, dict] = {}
    act_el = root.find("actuator")
    if act_el is not None:
        for pos_el in act_el.findall("position"):
            jn = pos_el.get("joint")
            if jn not in jname_to_idx:
                continue
            fr = pos_el.get("forcerange")
            actuators_by_joint[jname_to_idx[jn]] = dict(
                kp=float(pos_el.get("kp", 0.0)),
                ctrlrange=tuple(_parse_vec(pos_el.get("ctrlrange"), (0.0, 0.0))),
                forcerange=tuple(_parse_vec(fr, None))
                if fr is not None
                else (-np.inf, np.inf),
            )
    actuators = [actuators_by_joint[i] for i in sorted(actuators_by_joint)]
    if sorted(actuators_by_joint) != list(range(len(actuators))):
        raise ValueError("actuators must drive a joint-order prefix")

    nq = len(joints)
    if home_qpos is None:
        kf = root.find("keyframe")
        if kf is not None:
            for key in kf.findall("key"):
                if key.get("name") == "home" and key.get("qpos") is not None:
                    home_qpos = _parse_vec(key.get("qpos"), None)[:nq]
                    break

    return build_model(
        name=name or os.path.splitext(os.path.basename(path))[0],
        joints=joints,
        sites=sites,
        cameras=cameras,
        fingertips=fingertips if fingertips is not None else tips,
        actuators=actuators,
        home_qpos=home_qpos if home_qpos is not None else np.zeros(nq),
        mocap_pos0=np.stack(mocap_pos) if mocap_pos else np.zeros((0, 3)),
        mocap_quat0=np.stack(mocap_quat) if mocap_quat else np.zeros((0, 4)),
        meshes=tuple(meshes),
    )
