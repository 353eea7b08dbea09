"""VR hand-tracking teleoperation: gesture mapping and scene description.

Port of `gym_kmanip_tpu/teleop.py` (the reference's Vuer teleop handler,
examples/4_teleop.py of gym_kmanip): an index-thumb pinch gates EE
tracking, the EE position action is the anchored thumb delta, the EE
orientation action the anchored wrist-rotation euler delta, the
thumb-middle distance drives the gripper, and a thumb-pinky pinch resets
the episode and re-anchors the hand. Both hands are mapped for bimanual
robots.

`TeleopState` is plain Python with no vuer or network dependency;
`examples/4_teleop.py` is the Vuer wiring around it. The scene
descriptors read the sim backend's state from the card in one copy a
frame.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
from numpy.typing import NDArray

from gym_kmanip_torch import constants as k

# Vuer hand-landmark indices and pinch thresholds (4_teleop.py:125-131)
FINGER_INDEX: int = 9
FINGER_THUMB: int = 4
FINGER_MIDLE: int = 14
FINGER_PINKY: int = 24
PINCH_OPEN: float = 0.10  # 10 cm: fully open thumb-middle distance
PINCH_CLOSE: float = 0.01  # 1 cm: pinch trigger
RESET_BACKOFF: float = 1.0  # s between gesture resets (4_teleop.py:56)

SPHERE_ARGS: List[float] = [0.02, 10, 10]
TABLE_SIZE: NDArray = np.array([0.4, 0.8])
# Rz(pi/2)*Rx(-pi/2) as extrinsic-xyz euler (reference 4_teleop.py:67-69)
TABLE_ROT: NDArray = np.array([-np.pi / 2, 0.0, np.pi / 2])
VUER_LIGHT_POS: NDArray = np.array([0, 2, 2])
VUER_LIGHT_INTENSITY: float = 10.0
HAND_FPS: int = 30
MAX_FPS: int = 60


def _wrist_euler(hand_mat16) -> NDArray:
    """xyz euler of the 4x4 wrist pose streamed as event.value['{side}Hand']."""
    m = np.asarray(hand_mat16, dtype=np.float64).reshape(4, 4)[:3, :3]
    return k.mat_to_euler_xyz(m)


@dataclass
class _HandState:
    anchor_pos: NDArray  # thumb-tip anchor in vuer frame
    anchor_orn: NDArray  # wrist euler anchor
    ee_pos: NDArray = field(default_factory=lambda: np.zeros(3))
    ee_orn: NDArray = field(default_factory=lambda: np.zeros(3))
    grip: float = 0.0


class TeleopState:
    """Maps streamed hand frames to env actions.

    `bimanual` mirrors the right-hand gestures onto the left hand. The
    right pinky-thumb pinch requests an episode reset AND re-anchors the
    right hand; the left pinky-thumb pinch only re-anchors the left hand
    (the reference never sets `reset` from the left hand, 4_teleop.py:
    196-205 — quirk preserved).
    """

    def __init__(
        self,
        bimanual: bool,
        hr_anchor: Optional[NDArray] = None,
        hl_anchor: Optional[NDArray] = None,
    ):
        self.bimanual = bimanual
        self.reset_requested = False
        self.right = _HandState(
            anchor_pos=np.asarray(
                hr_anchor if hr_anchor is not None else np.zeros(3), dtype=np.float64
            ),
            anchor_orn=np.zeros(3),
        )
        self.left = _HandState(
            anchor_pos=np.asarray(
                hl_anchor if hl_anchor is not None else np.zeros(3), dtype=np.float64
            ),
            anchor_orn=np.zeros(3),
        )

    # -- gesture mapping ---------------------------------------------------
    def _handle_side(self, hand: _HandState, landmarks, wrist_mat, is_right: bool):
        lm = np.asarray(landmarks, dtype=np.float64)
        thumb = lm[FINGER_THUMB]
        wrist_orn = _wrist_euler(wrist_mat)
        # index-thumb pinch gates tracking (4_teleop.py:147-160)
        if np.linalg.norm(lm[FINGER_INDEX] - thumb) < PINCH_CLOSE:
            hand.ee_pos = np.clip(hand.anchor_pos - thumb, -1, 1)
            hand.ee_orn = np.clip(hand.anchor_orn - wrist_orn, -1, 1)
            # thumb-middle distance drives the gripper, normalized by the
            # fully-open span
            hand.grip = float(
                np.linalg.norm(thumb - lm[FINGER_MIDLE]) / PINCH_OPEN
            )
        # pinky-thumb pinch: re-anchor (and reset, right hand only)
        if np.linalg.norm(thumb - lm[FINGER_PINKY]) < PINCH_CLOSE:
            if is_right:
                self.reset_requested = True
            hand.anchor_pos = thumb.copy()
            hand.anchor_orn = wrist_orn

    def handle(self, value: Dict) -> None:
        """Process one HAND_MOVE event payload (event.value)."""
        if "rightLandmarks" in value and "rightHand" in value:
            self._handle_side(
                self.right, value["rightLandmarks"], value["rightHand"], True
            )
        if self.bimanual and "leftLandmarks" in value and "leftHand" in value:
            self._handle_side(
                self.left, value["leftLandmarks"], value["leftHand"], False
            )

    # -- env interface -----------------------------------------------------
    def action(self) -> Dict[str, NDArray]:
        a: Dict[str, NDArray] = {
            "eer_pos": self.right.ee_pos.astype(np.float32),
            "eer_orn": self.right.ee_orn.astype(np.float32),
            "grip_r": np.asarray([self.right.grip], dtype=np.float32),
        }
        if self.bimanual:
            a["eel_pos"] = self.left.ee_pos.astype(np.float32)
            a["eel_orn"] = self.left.ee_orn.astype(np.float32)
            a["grip_l"] = np.asarray([self.left.grip], dtype=np.float32)
        return a

    def consume_reset(self, now: float, last_reset: float) -> bool:
        """True if a gesture reset should fire (with the backoff debounce)."""
        if self.reset_requested and now - last_reset > RESET_BACKOFF:
            self.reset_requested = False
            return True
        return False


# -- scene description (vuer-schema kwargs, no vuer import) -----------------
def _host_state(u):
    """(qpos, cube_pos, cube_quat) of the sim backend's state as host arrays
    of its dtype, in one copy from its device."""
    s = u.env.state
    flat = torch.cat([s.qpos, s.cube_pos, s.cube_quat]).cpu().numpy()
    nq = s.qpos.shape[-1]
    return flat[:nq], flat[nq:nq + 3], flat[nq + 3:]


def scene_static(env, urdf_src: str) -> List[Dict]:
    """Initial upserts: light, hands stream, robot URDF, cube, table, hand
    spheres (4_teleop.py:214-256). Returns (schema-name, kwargs) descriptors
    consumed by examples/4_teleop.py and by tests."""
    u = env.unwrapped
    _, cube_pos, cube_quat = _host_state(u)
    cube_size = [2 * k.CUBE_HALF_SIZE] * 3
    items = [
        {"schema": "PointLight", "intensity": VUER_LIGHT_INTENSITY,
         "position": VUER_LIGHT_POS.tolist()},
        {"schema": "Hands", "fps": HAND_FPS, "stream": True, "key": "hands"},
        {"schema": "Urdf", "src": urdf_src, "jointValues": dict(u.q_dict),
         "position": k.mj2vuer_pos(np.zeros(3)).tolist(), "key": "robot"},
        {"schema": "Box", "args": cube_size,
         "position": k.mj2vuer_pos(cube_pos).tolist(),
         "rotation": k.mj2vuer_orn(cube_quat).tolist(),
         "materialType": "standard", "material": {"color": "#ff0000"},
         "key": "cube"},
        {"schema": "Plane", "args": TABLE_SIZE.tolist(),
         "position": k.mj2vuer_pos(k.TABLE_POS).tolist(),
         "rotation": TABLE_ROT.tolist(),
         "materialType": "standard", "material": {"color": "#cbc1ae"},
         "key": "table"},
        {"schema": "Sphere", "args": SPHERE_ARGS,
         "position": np.zeros(3).tolist(),
         "materialType": "standard", "material": {"color": "#0000ff"},
         "key": "hand_r"},
    ]
    if "eel_pos" in env.action_space.spaces:
        items.append(
            {"schema": "Sphere", "args": SPHERE_ARGS,
             "position": np.zeros(3).tolist(),
             "materialType": "standard", "material": {"color": "#ff0000"},
             "key": "hand_l"},
        )
    return items


def scene_dynamic(env, teleop: "TeleopState") -> List[Dict]:
    """Per-frame upserts: robot joint values, cube pose, hand indicators
    (4_teleop.py:263-285)."""
    u = env.unwrapped
    qpos, cube_pos, cube_quat = _host_state(u)
    qpos = qpos[: u.q_len]
    joint_values = {name: float(qv) for name, qv in zip(u.q_keys, qpos)}
    items = [
        {"schema": "Urdf", "jointValues": joint_values, "key": "robot"},
        {"schema": "Box",
         "position": k.mj2vuer_pos(cube_pos).tolist(),
         "rotation": k.mj2vuer_orn(cube_quat).tolist(),
         "key": "cube"},
        {"schema": "Sphere", "position": teleop.right.anchor_pos.tolist(),
         "rotation": teleop.right.anchor_orn.tolist(), "key": "hand_r"},
    ]
    if teleop.bimanual:
        items.append(
            {"schema": "Sphere", "position": teleop.left.anchor_pos.tolist(),
             "rotation": teleop.left.anchor_orn.tolist(), "key": "hand_l"},
        )
    return items
