"""Kinematic chain data for the Stompy robots: the tables the shipped
assets are generated from.

Port of `gym_kmanip_tpu/models/_chains.py`, the same numbers. They were
transcribed from the upstream gym_kmanip MJCF trees:
  * right arm: assets/arm_r_body.xml (joints at lines 3-68) and actuators
    arm_r.xml:44-55
  * left arm: assets/arm_l_body.xml:3-58 and actuators arm_l.xml:47-56
  * torso: assets/torso_body.xml:20-180 and actuators torso.xml:113-135

These are physical facts about the robots (link offsets, joint axes,
ranges, servo gains) as Python records for `models.spec.build_model`;
`models._table_models()` builds the three robots from them and
`tools/gen_assets.py` writes them out as the MJCF files the registry
loads. The euler frames are converted in float32
(`spec.quat_from_euler_xyz_f32`), the arithmetic the shipped assets hold.
"""

from typing import List

import numpy as np

from gym_kmanip_torch.models.spec import quat_from_euler_xyz_f32

IDENT = (1.0, 0.0, 0.0, 0.0)


def right_arm_joints(base_frames: List, offset: int) -> List[dict]:
    """Right arm chain: 8 hinges + 2 grip sliders (arm_r_body.xml:2-62)."""
    j = offset
    return [
        dict(
            name="joint_right_arm_1_x8_1_dof_x8",
            parent=-1,
            frames=base_frames
            + [((0, 0, 0), quat_from_euler_xyz_f32((3.1416, 0, 3.1416)))],
            range=(-2.0944, 2.0944),
        ),
        dict(
            name="joint_right_arm_1_x8_2_dof_x8",
            parent=j + 0,
            frames=[((0, -0.033, -0.11), (0.707107, 0.707107, 0, 0))],
            range=(0, 1.91986),
        ),
        dict(
            name="joint_right_arm_1_x6_1_dof_x6",
            parent=j + 1,
            frames=[((0, 0.0325, -0.1035), (0.5, -0.5, -0.5, -0.5))],
            range=(-1.0472, 3.66519),
        ),
        dict(
            name="joint_right_arm_1_x6_2_dof_x6",
            parent=j + 2,
            frames=[
                ((-0.01625, -0.0281458, -0.214), (-0.612372, -0.353553, 0.612372, -0.353553))
            ],
            range=(-1.5708, 1.5708),
        ),
        dict(
            name="joint_right_arm_1_x4_1_dof_x4",
            parent=j + 3,
            frames=[((-0.078, -3.12968e-09, -0.0375), (0.5, -0.5, 0.5, -0.5))],
            range=(-3.14159, 3.14159),
        ),
        dict(
            name="joint_right_arm_1_hand_right_1_x4_3_dof_x4",
            parent=j + 4,
            frames=[
                ((0.00555746, 0.0853667, -0.1125),
                 (-1.89469e-08, -1.89469e-08, -0.707107, -0.707107))
            ],
            range=(-3.14159, 3.14159),
        ),
        dict(
            name="joint_right_arm_1_hand_right_1_x4_1_dof_x4",
            parent=j + 5,
            frames=[
                ((0.0723528, 0.0322135, -0.0875), (-0.385118, -0.385118, -0.59303, -0.59303))
            ],
            range=(-2.61799, 0.523599),
        ),
        dict(
            name="joint_right_arm_1_hand_right_1_x4_2_dof_x4",
            parent=j + 6,
            frames=[((-0.00120208, -0.020637, -0.0792), (-0.707107, 0.707107, 0, 0))],
            range=(-3.14159, 3.14159),
        ),
        dict(
            name="joint_right_arm_1_hand_right_1_slider_3",
            parent=j + 6,
            frames=[((-0.0762021, -0.073637, -0.0792), (0.5, 0.5, -0.5, -0.5))],
            type="slide",
            range=(-0.029, 0.005),
            frictionloss=30.0,
        ),
        dict(
            name="joint_right_arm_1_hand_right_1_slider_1",
            parent=j + 6,
            frames=[((0.0737979, -0.073637, -0.0792), (-0.5, 0.5, -0.5, 0.5))],
            type="slide",
            range=(-0.029, 0.005),
            frictionloss=30.0,
        ),
    ]


def right_arm_site(offset: int) -> dict:
    # eer_site body, arm_r_body.xml:63-65
    return dict(
        name="eer_site",
        parent=offset + 6,
        pos=(0, -0.14, -0.08),
        quat=(-0.707107, 0.707107, 0, 0),
    )


def right_arm_fingertips(offset: int) -> List[dict]:
    # gripper finger meshes sit at ~(0.01,-0.01,-0.033) on each slide body
    # (arm_r_body.xml:50-60); approximated as spheres near the pad tips
    return [
        dict(parent=offset + 8, pos=(0.01, -0.01, -0.045), radius=0.008, side="r"),
        dict(parent=offset + 9, pos=(0.01, -0.01, -0.045), radius=0.008, side="r"),
    ]


def right_arm_actuators() -> List[dict]:
    # arm_r.xml:44-55 -- note kp=0 on the hand x4_2 servo (line 53)
    kp = [1000, 1000, 1000, 1000, 1000, 1000, 1000, 0, 200, 200]
    ranges = [
        (-2.0944, 2.0944), (0, 1.91986), (-1.0472, 3.66519), (-1.5708, 1.5708),
        (-3.14159, 3.14159), (-3.14159, 3.14159), (-2.61799, 0.523599),
        (-3.14159, 3.14159), (-0.029, 0.005), (-0.029, 0.005),
    ]
    force = [(-100, 100)] * 8 + [(-np.inf, np.inf)] * 2
    return [
        dict(kp=k, ctrlrange=r, forcerange=f) for k, r, f in zip(kp, ranges, force)
    ]


def left_arm_joints(base_frames: List, offset: int) -> List[dict]:
    """Left arm chain (mirror), arm_l_body.xml:2-58."""
    j = offset
    return [
        dict(
            name="joint_left_arm_2_x8_1_dof_x8",
            parent=-1,
            frames=base_frames
            + [((0, 0, 0), quat_from_euler_xyz_f32((3.1416, 0, 3.1416)))],
            range=(-1.5708, 1.5708),
        ),
        dict(
            name="joint_left_arm_2_x8_2_dof_x8",
            parent=j + 0,
            frames=[((0, -0.033, -0.11), (0.707107, 0.707107, 0, 0))],
            range=(-1.91986, 0),
        ),
        dict(
            name="joint_left_arm_2_x6_1_dof_x6",
            parent=j + 1,
            frames=[((0, 0.0325, -0.1035), (0.5, -0.5, -0.5, -0.5))],
            range=(-3.66519, 1.0472),
        ),
        dict(
            name="joint_left_arm_2_x6_2_dof_x6",
            parent=j + 2,
            frames=[
                ((-0.01625, 0.0281458, -0.214), (0.612372, -0.353553, -0.612372, -0.353553))
            ],
            range=(-1.5708, 1.5708),
        ),
        dict(
            name="joint_left_arm_2_x4_1_dof_x4",
            parent=j + 3,
            frames=[((-0.078, 2.87032e-09, -0.0375), (0.5, -0.5, 0.5, -0.5))],
            range=(-3.14159, 3.14159),
        ),
        dict(
            name="joint_left_arm_2_hand_left_1_x4_3_dof_x4",
            parent=j + 4,
            frames=[
                ((-0.0855879, 0.0181923, -0.1125), (-0.444997, -0.444997, 0.549525, 0.549525))
            ],
            range=(-4.36332, 1.74533),
        ),
        dict(
            name="joint_left_arm_2_hand_left_1_x4_1_dof_x4",
            parent=j + 5,
            frames=[
                ((0.0723528, 0.0322135, -0.0875), (-0.385118, -0.385118, -0.59303, -0.59303))
            ],
            range=(-3.49066, 3.49066),
        ),
        dict(
            name="joint_left_arm_2_hand_left_1_x4_2_dof_x4",
            parent=j + 6,
            frames=[((-0.00120208, -0.020637, -0.0792), (-0.707107, 0.707107, 0, 0))],
            range=(-3.14159, 3.14159),
        ),
        dict(
            name="joint_left_arm_2_hand_left_1_slider_3",
            parent=j + 6,
            frames=[((-0.0762021, -0.073637, -0.0792), (0.5, 0.5, -0.5, -0.5))],
            type="slide",
            range=(-0.029, 0.005),
            frictionloss=30.0,
        ),
        dict(
            name="joint_left_arm_2_hand_left_1_slider_1",
            parent=j + 6,
            frames=[((0.0737979, -0.073637, -0.0792), (-0.5, 0.5, -0.5, 0.5))],
            type="slide",
            range=(-0.029, 0.005),
            frictionloss=30.0,
        ),
    ]


def left_arm_site(offset: int) -> dict:
    # eel_site body, arm_l_body.xml:53-55
    return dict(
        name="eel_site",
        parent=offset + 6,
        pos=(0, -0.14, -0.08),
        quat=(-0.707107, 0.707107, 0, 0),
    )


def left_arm_fingertips(offset: int) -> List[dict]:
    return [
        dict(parent=offset + 8, pos=(0.01, -0.01, -0.045), radius=0.008, side="l"),
        dict(parent=offset + 9, pos=(0.01, -0.01, -0.045), radius=0.008, side="l"),
    ]


def left_arm_actuators() -> List[dict]:
    # arm_l.xml:47-56 -- kp=0 on hand x4_2 (line 54)
    kp = [1000, 1000, 1000, 1000, 1000, 1000, 1000, 0, 200, 200]
    ranges = [
        (-1.5708, 1.5708), (-1.91986, 0), (-3.66519, 1.0472), (-1.5708, 1.5708),
        (-3.14159, 3.14159), (-4.36332, 1.74533), (-3.49066, 3.49066),
        (-3.14159, 3.14159), (-0.029, 0.005), (-0.029, 0.005),
    ]
    force = [(-100, 100)] * 8 + [(-np.inf, np.inf)] * 2
    return [
        dict(kp=k, ctrlrange=r, forcerange=f) for k, r, f in zip(kp, ranges, force)
    ]


# ---------------------------------------------------------------------------
# Torso chains (torso_body.xml). All joints hang off the `root` body which is
# rotated euler(0,0,3.1416) relative to robot_root (_env_torso.xml:4,
# torso_body.xml:2).
# ---------------------------------------------------------------------------


def torso_joints(root_frames: List) -> List[dict]:
    rf = root_frames  # robot_root -> root body
    return [
        # --- head (torso_body.xml:20-33) ---
        dict(
            name="joint_head_1_x4_1_dof_x4",
            parent=-1,
            frames=rf
            + [((0.000148008, 0.0434136, 0.0633109), (0, 2.32051e-08, -1, 6.96153e-08))],
            range=(-2.51327, 0.628319),
        ),
        dict(
            name="joint_head_1_x4_2_dof_x4",
            parent=0,
            frames=[
                ((-0.0202786, -0.0279111, -0.1215), (-0.672498, -0.672499, 0.218508, 0.218508))
            ],
            range=(-1.5708, 0.261799),
        ),
        # --- right arm (torso_body.xml:47-110) ---
        dict(
            name="joint_right_arm_1_x8_1_dof_x8",
            parent=-1,
            frames=rf
            + [((-0.0766223, 0.032495, -0.00775921), (0.379928, -0.596368, 0.596368, -0.379928))],
            range=(-2.0944, 2.0944),
        ),
        dict(
            name="joint_right_arm_1_x8_2_dof_x8",
            parent=2,
            frames=[((0, -0.033, -0.11), (0.707107, 0.707107, 0, 0))],
            range=(0, 1.91986),
        ),
        dict(
            name="joint_right_arm_1_x6_1_dof_x6",
            parent=3,
            frames=[((0, 0.0325, -0.0945), (0.5, -0.5, -0.5, -0.5))],
            range=(-1.0472, 3.66519),
        ),
        dict(
            name="joint_right_arm_1_x6_2_dof_x6",
            parent=4,
            frames=[
                ((-0.01625, -0.0281458, -0.214), (-0.612372, -0.353553, 0.612372, -0.353553))
            ],
            range=(-1.5708, 1.5708),
        ),
        dict(
            name="joint_right_arm_1_x4_1_dof_x4",
            parent=5,
            frames=[((-0.078, 2.87032e-09, -0.0375), (0.5, -0.5, 0.5, -0.5))],
            range=(-3.14159, 3.14159),
        ),
        dict(
            name="joint_right_arm_1_hand_1_x4_1_dof_x4",
            parent=6,
            frames=[
                ((-0.00151566, -0.0144206, -0.082), (-0.706138, -0.706138, 0.0370071, 0.0370071))
            ],
            range=(-2.61799, 0.523599),
        ),
        dict(
            name="joint_right_arm_1_hand_1_slider_1",
            parent=7,
            frames=[
                ((0.139251, -0.00228616, -0.014), (-0.218508, -0.218508, -0.672498, -0.672499))
            ],
            type="slide",
            range=(-0.034, 0),
        ),
        dict(
            name="joint_right_arm_1_hand_1_slider_2",
            parent=7,
            frames=[
                ((0.0452051, -0.131729, -0.014), (0.218508, -0.218508, -0.672499, 0.672498))
            ],
            type="slide",
            range=(-0.034, 0),
        ),
        dict(
            name="joint_right_arm_1_hand_1_x4_2_dof_x4",
            parent=7,
            frames=[
                ((0.0489455, -0.035561, -0.014), (-0.32102, -0.32102, 0.630037, 0.630037))
            ],
            range=(-3.14159, 3.14159),
        ),
        # --- left arm (torso_body.xml:111-177) ---
        dict(
            name="joint_left_arm_2_x8_1_dof_x8",
            parent=-1,
            frames=rf
            + [((0.0766657, 0.032495, -0.00791584), (0.379928, -0.596368, -0.596368, 0.379928))],
            range=(-1.5708, 1.5708),
        ),
        dict(
            name="joint_left_arm_2_x8_2_dof_x8",
            parent=11,
            frames=[((0, -0.033, -0.11), (0.707107, 0.707107, 0, 0))],
            range=(-1.91986, 0),
        ),
        dict(
            name="joint_left_arm_2_x6_1_dof_x6",
            parent=12,
            frames=[((0, 0.0325, -0.0945), (0.5, -0.5, -0.5, -0.5))],
            range=(-3.66519, 1.0472),
        ),
        dict(
            name="joint_left_arm_2_x6_2_dof_x6",
            parent=13,
            frames=[
                ((-0.01625, 0.0281458, -0.214), (0.612372, -0.353553, -0.612372, -0.353553))
            ],
            range=(-1.5708, 1.5708),
        ),
        dict(
            name="joint_left_arm_2_x4_1_dof_x4",
            parent=14,
            frames=[((-0.078, 2.87032e-09, -0.0375), (0.5, -0.5, 0.5, -0.5))],
            range=(-3.14159, 3.14159),
        ),
        dict(
            name="joint_left_arm_2_hand_1_x4_1_dof_x4",
            parent=15,
            frames=[
                ((-0.00151566, -0.0144206, -0.082), (-0.706138, -0.706138, 0.0370071, 0.0370071))
            ],
            range=(-2.61799, 0.523599),
        ),
        dict(
            name="joint_left_arm_2_hand_1_slider_1",
            parent=16,
            frames=[
                ((0.139251, -0.00228616, -0.014), (-0.218508, -0.218508, -0.672498, -0.672499))
            ],
            type="slide",
            range=(-0.034, 0),
        ),
        dict(
            name="joint_left_arm_2_hand_1_slider_2",
            parent=16,
            frames=[
                ((0.0452051, -0.131729, -0.014), (0.218508, -0.218508, -0.672499, 0.672498))
            ],
            type="slide",
            range=(-0.034, 0),
        ),
        dict(
            name="joint_left_arm_2_hand_1_x4_2_dof_x4",
            parent=16,
            frames=[
                ((0.0489455, -0.035561, -0.014), (-0.32102, -0.32102, 0.630037, 0.630037))
            ],
            range=(-3.14159, 3.14159),
        ),
    ]


def torso_sites() -> List[dict]:
    # eer_site hangs off right hand x4_2 (torso_body.xml:101-105), eel_site
    # off left hand x4_2 (torso_body.xml:168-172); both at (0,0,-0.14)
    return [
        dict(name="eer_site", parent=10, pos=(0, 0, -0.14), quat=IDENT),
        dict(name="eel_site", parent=19, pos=(0, 0, -0.14), quat=IDENT),
    ]


def torso_fingertips() -> List[dict]:
    # gripper meshes at ~(-0.049, ±0.01, -0.033) on each slide body
    # (torso_body.xml:88-99 / 155-166)
    return [
        dict(parent=8, pos=(-0.049, 0.01, -0.045), radius=0.008, side="r"),
        dict(parent=9, pos=(-0.049, -0.01, -0.045), radius=0.008, side="r"),
        dict(parent=17, pos=(-0.049, 0.01, -0.045), radius=0.008, side="l"),
        dict(parent=18, pos=(-0.049, -0.01, -0.045), radius=0.008, side="l"),
    ]


def torso_actuators() -> List[dict]:
    # torso.xml:113-135: 20 position servos, all kp=100, forcerange ±100,
    # ctrl order == qpos order (head, right arm, left arm)
    ranges = [
        (-2.51327, 0.628319), (-1.5708, 0.261799),
        (-2.0944, 2.0944), (0, 1.91986), (-1.0472, 3.66519), (-1.5708, 1.5708),
        (-3.14159, 3.14159), (-2.61799, 0.523599), (-0.034, 0), (-0.034, 0),
        (-3.14159, 3.14159),
        (-1.5708, 1.5708), (-1.91986, 0), (-3.66519, 1.0472), (-1.5708, 1.5708),
        (-3.14159, 3.14159), (-2.61799, 0.523599), (-0.034, 0), (-0.034, 0),
        (-3.14159, 3.14159),
    ]
    return [dict(kp=100, ctrlrange=r, forcerange=(-100, 100)) for r in ranges]


def world_cameras() -> List[dict]:
    # top/head cameras are world-fixed, targeting the table body at
    # (0, 0.6, 0.5) (_env_solo_arm.xml:14-15, scene.xml:14)
    return [
        dict(name="top", parent=-1, pos=(0, 0, 1.3), fovy=78, target_world=(0, 0.6, 0.5)),
        dict(name="head", parent=-1, pos=(0, 0, 1.0), fovy=78, target_world=(0, 0.6, 0.5)),
    ]
