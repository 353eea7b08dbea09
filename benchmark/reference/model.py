"""The robot's constants, read from the benchmark's frozen copy of its MJCF
file (`assets/<robot>.xml`) with xml.etree and numpy alone.

This is the plain reference's own loader: it imports nothing of the system
under test. It reads the subset the robots use (nested bodies with pos and
quat, hinge and slide joints on the body's z axis, inertials, the
`eer_site` / `eel_site` marker bodies, the `tip_*` fingertip spheres,
position actuators and the `home` keyframe) and composes each joint's
frame from its parent joint's in float64, as MuJoCo's compiler does.
"""

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Tuple

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
SITE_BODIES = ("eer_site", "eel_site")


@dataclass(frozen=True)
class Robot:
    """Static robot constants (float64 numpy; quaternions wxyz)."""

    name: str
    nq: int
    nu: int
    parent: np.ndarray  # (nq,) int, -1 for a root
    is_slide: np.ndarray  # (nq,) bool
    jnt_pos: np.ndarray  # (nq, 3) joint frame in its parent joint's frame
    jnt_quat: np.ndarray  # (nq, 4)
    jnt_range: np.ndarray  # (nq, 2)
    frictionloss: np.ndarray  # (nq,)
    armature: np.ndarray  # (nq,)
    body_mass: np.ndarray  # (nq,)
    body_com: np.ndarray  # (nq, 3)
    body_inertia: np.ndarray  # (nq, 3) diagonal
    ancestors: np.ndarray  # (nq, nq) bool: joint j moves joint i
    kp: np.ndarray  # (nu,)
    ctrl_range: np.ndarray  # (nu, 2)
    force_range: np.ndarray  # (nu, 2)
    site_names: Tuple[str, ...]
    site_parent: np.ndarray  # (S,) int
    site_pos: np.ndarray  # (S, 3)
    tip_parent: np.ndarray  # (T,) int
    tip_pos: np.ndarray  # (T, 3)
    tip_radius: np.ndarray  # (T,)
    tip_side: Tuple[str, ...]  # "r" or "l"
    home_qpos: np.ndarray  # (nq,)

    def site_index(self, name: str) -> int:
        return self.site_names.index(name)


def _vec(s, default):
    return np.asarray(default if s is None else [float(x) for x in s.split()], np.float64)


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _qrot(q, v):
    u = np.asarray(q[1:], np.float64)
    uv = np.cross(u, v)
    return v + 2.0 * (float(q[0]) * uv + np.cross(u, uv))


def _compose(frames, normalize: bool):
    """One transform from a chain of (pos, quat) body frames; a single
    frame passes through as written."""
    if len(frames) == 1:
        return frames[0]
    p, q = np.zeros(3), np.array([1.0, 0.0, 0.0, 0.0])
    for fp, fq in frames:
        if normalize:
            fq = fq / np.linalg.norm(fq)
        p = p + _qrot(q, fp)
        q = _qmul(q, fq)
    return p, q


def load(name: str) -> Robot:
    """The robot `name` from `assets/<name>.xml`."""
    root = ET.parse(os.path.join(ASSETS, f"{name}.xml")).getroot()
    joints, sites, tips = [], [], []

    def walk(body, parent, frames):
        if body.get("mocap") == "true" or body.find("freejoint") is not None:
            return  # the hand targets and the cube are not part of the tree
        if body.get("euler") is not None:
            raise ValueError(f"{name}: body euler angles are not in the subset")
        frames = frames + [(_vec(body.get("pos"), (0.0, 0.0, 0.0)),
                            _vec(body.get("quat"), (1.0, 0.0, 0.0, 0.0)))]
        jel = body.find("joint")
        if jel is not None:
            if not (np.allclose(_vec(jel.get("pos"), (0, 0, 0)), 0)
                    and np.allclose(_vec(jel.get("axis"), (0, 0, 1)), (0, 0, 1))):
                raise ValueError(f"{jel.get('name')}: only pos=0 axis=z joints")
            p, q = _compose(frames, normalize=True)
            if len(frames) > 1:
                q = q / np.linalg.norm(q)
            ine = body.find("inertial")
            joints.append(dict(
                name=jel.get("name"), parent=parent, pos=p, quat=q,
                slide=jel.get("type") == "slide", range=_vec(jel.get("range"), (0, 0)),
                frictionloss=float(jel.get("frictionloss", 0.0)),
                armature=float(jel.get("armature")), mass=float(ine.get("mass")),
                com=_vec(ine.get("pos"), (0, 0, 0)), inertia=_vec(ine.get("diaginertia"), None)))
            parent, frames = len(joints) - 1, []
        for geom in body.findall("geom"):
            gname = geom.get("name", "")
            if geom.get("type") == "sphere" and gname.startswith("tip_"):
                tips.append(dict(parent=parent, pos=_vec(geom.get("pos"), (0, 0, 0)),
                                 radius=float(geom.get("size").split()[0]),
                                 side=gname.split("_")[1]))
        if body.get("name") in SITE_BODIES:
            p, _ = _compose(frames, normalize=False)
            sites.append(dict(name=body.get("name"), parent=parent, pos=p))
        for child in body.findall("body"):
            walk(child, parent, frames)

    for top in root.find("worldbody").findall("body"):
        walk(top, -1, [])

    index = {j["name"]: i for i, j in enumerate(joints)}
    acts = {}
    for el in root.find("actuator").findall("position"):
        fr = el.get("forcerange")
        acts[index[el.get("joint")]] = (float(el.get("kp", 0.0)), _vec(el.get("ctrlrange"), None),
                                        _vec(fr, None) if fr else np.array([-np.inf, np.inf]))
    if sorted(acts) != list(range(len(acts))):
        raise ValueError(f"{name}: actuators must drive a joint-order prefix")
    acts = [acts[i] for i in range(len(acts))]
    home = next(_vec(key.get("qpos"), None) for key in root.find("keyframe").findall("key")
                if key.get("name") == "home")

    nq = len(joints)
    parent = np.array([j["parent"] for j in joints])
    ancestors = np.zeros((nq, nq), bool)
    for i in range(nq):
        a = i
        while a >= 0:
            ancestors[i, a] = True
            a = int(parent[a])

    def stack(rows, key):
        return np.array([r[key] for r in rows], np.float64)

    return Robot(
        name=name, nq=nq, nu=len(acts), parent=parent,
        is_slide=np.array([j["slide"] for j in joints]),
        jnt_pos=stack(joints, "pos"), jnt_quat=stack(joints, "quat"),
        jnt_range=stack(joints, "range"), frictionloss=stack(joints, "frictionloss"),
        armature=stack(joints, "armature"), body_mass=stack(joints, "mass"),
        body_com=stack(joints, "com"), body_inertia=stack(joints, "inertia"),
        ancestors=ancestors,
        kp=np.array([a[0] for a in acts]), ctrl_range=np.array([a[1] for a in acts]),
        force_range=np.array([a[2] for a in acts]),
        site_names=tuple(s["name"] for s in sites),
        site_parent=np.array([s["parent"] for s in sites]),
        site_pos=stack(sites, "pos").reshape(-1, 3),
        tip_parent=np.array([t["parent"] for t in tips]), tip_pos=stack(tips, "pos").reshape(-1, 3),
        tip_radius=stack(tips, "radius"), tip_side=tuple(t["side"] for t in tips),
        home_qpos=home[:nq],
    )
