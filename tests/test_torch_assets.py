"""The port's robot tables, asset generator and shipped assets against the
JAX package's.

The tables (`gym_kmanip_torch/models/_chains.py`) must build models equal
to the JAX package's `_table_models()` bit for bit, and the generator must
write the JAX package's asset files byte for byte: the env's host IK is
sensitive to model values at the last bit (tests/test_mjcf_loader.py:24-60).
No JAX program is compiled here.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gym_kmanip_tpu import constants as jk
from gym_kmanip_tpu.models import _table_models as jax_table_models

from gym_kmanip_torch import constants as tk
from gym_kmanip_torch import models, zoo
from gym_kmanip_torch.dynamics.engine import control_step
from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models.mjcf import load_mjcf
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.tools import gen_assets

NAMES = ("solo_arm", "dual_arm", "torso")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_equal(a, b, path):
    """Field by field, arrays bit for bit with their dtypes."""
    if dataclasses.is_dataclass(a):
        names = [f.name for f in dataclasses.fields(a) if f.compare]
        assert names == [f.name for f in dataclasses.fields(b) if f.compare], path
        for n in names:
            _assert_equal(getattr(a, n), getattr(b, n), f"{path}.{n}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("name", NAMES)
def test_table_models_match_jax(name):
    want = jax_table_models()[name]()
    got = models._table_models()[name]()
    _assert_equal(want, got, name)
    # the registry's asset-backed model is the table's, bit for bit
    # (tests/test_mjcf_loader.py:24-60 holds the JAX package to the same)
    loaded = models.get_model(name)
    assert loaded is getattr(models, name)()
    for field in ("parent", "jnt_pos", "jnt_quat", "jnt_type", "jnt_range", "home_qpos",
                  "body_mass", "body_com", "body_inertia", "armature", "actuator_kp",
                  "ctrl_range", "force_range", "mocap_pos0", "mocap_quat0"):
        np.testing.assert_array_equal(getattr(loaded, field), getattr(got, field),
                                      err_msg=field)


@pytest.mark.parametrize("name", NAMES)
def test_emitted_and_shipped_assets_match_jax(name):
    jax_bytes = _read(os.path.join(jk.ASSETS_DIR, f"{name}.xml"))
    emitted = gen_assets.build_asset_xml(models._table_models()[name]())
    assert emitted.encode() == jax_bytes
    assert _read(os.path.join(tk.ASSETS_DIR, f"{name}.xml")) == jax_bytes


def test_template_copy_matches_jax():
    rel = os.path.join("templates", "robot_template.xml")
    assert _read(os.path.join(tk.ASSETS_DIR, rel)) == _read(os.path.join(jk.ASSETS_DIR, rel))


def test_gen_assets_main_writes_the_shipped_files(tmp_path):
    gen_assets.main(out_dir=str(tmp_path))
    for name in NAMES:
        assert _read(tmp_path / f"{name}.xml") == _read(os.path.join(tk.ASSETS_DIR,
                                                                     f"{name}.xml"))
    # the round-trip check fails on a file that does not hold the model
    model = models._table_models()["solo_arm"]()
    bad = tmp_path / "bad.xml"
    bad.write_text(gen_assets.build_asset_xml(model).replace(
        'armature="0.050000000000000003"', 'armature="0.05000000000000001"', 1))
    with pytest.raises(AssertionError):
        gen_assets.check_round_trip(str(bad), model)


def test_paths_resolve_as_before():
    """The assets are the port's own; the episodes and the zoo's artifacts
    stay the JAX package's, shared by path."""
    port = os.path.join(REPO, "gym_kmanip_torch")
    assert tk.ASSETS_DIR == os.path.join(port, "assets")
    assert tk.DATA_DIR == jk.DATA_DIR == os.path.join(REPO, "gym_kmanip_tpu", "data")
    assert zoo._ZOO_DIR == os.path.join(REPO, "gym_kmanip_tpu", "zoo")
    assert zoo.list_policies() == ("bc_pick_dual", "bc_pick_solo", "bc_pick_torso",
                                   "bc_pixels_solo")


def test_robot_template_loads_and_holds_home():
    """tests/test_mjcf_loader.py:133-166 on the port's copy of the template."""
    m = load_mjcf(os.path.join(tk.ASSETS_DIR, "templates", "robot_template.xml"))
    assert m.nq == 4 and m.nu == 4
    assert [s.name for s in m.sites] == ["eer_site"]
    assert {c.name for c in m.cameras} == {"grip_r", "top", "head"}
    assert m.mocap_pos0.shape == (1, 3)
    np.testing.assert_allclose(m.home_qpos, [0.3, -1.2, 0.005, 0.005])
    xp, xq, _ = kin.fk(m, torch.tensor(m.home_qpos, dtype=torch.float32))
    p, _ = kin.site_pose(m, xp, xq, "eer_site")
    assert torch.isfinite(p).all()
    s = init_state(m, device="cpu")
    s2, _ = control_step(m, s, s.ctrl)
    np.testing.assert_allclose(s2.qpos.numpy(), m.home_qpos, atol=1e-3)
