"""The port's frames against the MuJoCo goldens in tests/golden/.

Frames from `kinematics.rnea_terms_fast` on CPU tensors, which runs the
FK + RNEA kernel's plain version, then the sites' world poses and their
Jacobians, against the MuJoCo traces of tools/make_golden.py at the bands
of tests/test_kinematics.py:49,56,77,81: position 2e-5, orientation
(rotation matrix) 5e-5, Jacobians 1e-4. No JAX, nothing compiled.
"""

import os

import numpy as np
import pytest
import torch

from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.utils import rotations as rot

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

CASES = [
    ("solo_arm", {"eer_site_pos": "eer_site"}),
    ("dual_arm", {"eer_site_pos": "eer_site", "eel_site_pos": "eel_site"}),
    ("torso", {"eer_site_pos": "eer_site", "eel_site_pos": "eel_site"}),
]


@pytest.mark.parametrize("robot,sites", CASES)
def test_frames_match_mujoco(robot, sites):
    data = np.load(os.path.join(GOLDEN, f"{robot}.npz"))
    model = get_model(robot)
    np.testing.assert_allclose(data["jnt_range"], model.jnt_range, atol=1e-6)
    qs = torch.as_tensor(data["qpos"], dtype=torch.float32)
    xpos, xquat, axis_w, _ = kin.rnea_terms_fast(model, qs, torch.zeros_like(qs))
    for golden, site in sites.items():
        pos, quat = kin.site_pose(model, xpos, xquat, site)
        np.testing.assert_allclose(pos.numpy(), data[f"{golden}_pos"], atol=2e-5,
                                   err_msg=f"{robot}/{site} position")
        np.testing.assert_allclose(rot.quat_to_mat(quat).reshape(-1, 9).numpy(),
                                   data[f"{golden}_mat"], atol=5e-5,
                                   err_msg=f"{robot}/{site} orientation")
        jacp, jacr = kin.point_jacobian(model, xpos, axis_w, pos, model.site(site).parent)
        np.testing.assert_allclose(jacp.numpy(), data[f"{golden}_jacp"], atol=1e-4,
                                   err_msg=f"{robot}/{site} jacp")
        np.testing.assert_allclose(jacr.numpy(), data[f"{golden}_jacr"], atol=1e-4,
                                   err_msg=f"{robot}/{site} jacr")
