"""The port's model loader and constants against the JAX package's.

Names, ints and bools must match exactly, floats to atol 1e-6 (the JAX
loader composes Euler frames in float32; the shipped assets have none, so
in practice the floats are bit-equal).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gym_kmanip_tpu import constants as jk
from gym_kmanip_tpu.models import get_model as jax_get_model

from gym_kmanip_torch import constants as tk
from gym_kmanip_torch.models import from_numpy_model, get_model, model_tensors

ATOL = 1e-6


def _assert_same(a, b, path):
    """Recursive field-by-field equality of two model values."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.compare:
                _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        assert a.shape == np.shape(b), path
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=path)
    elif isinstance(a, np.ndarray):
        assert a.dtype.kind == np.asarray(b).dtype.kind, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float):
        assert a == pytest.approx(b, abs=ATOL), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", ["solo_arm", "dual_arm", "torso"])
def test_get_model_matches_jax(name):
    jm, tm = jax_get_model(name), get_model(name)
    jfields = [f.name for f in dataclasses.fields(jm)]
    tfields = [f.name for f in dataclasses.fields(tm) if f.compare]
    assert tfields == jfields
    _assert_same(jm, tm, name)
    # the MJCF filename keys reach the same models
    key = {"solo_arm": tk.SOLO_ARM_MJCF, "dual_arm": tk.DUAL_ARM_MJCF,
           "torso": tk.TORSO_MJCF}[name]
    assert get_model(key) is tm


def test_constants_match_jax():
    names = [n for n in dir(tk) if n.isupper()]
    assert len(names) >= 40
    for n in names:
        if n == "ASSETS_DIR":  # the port's own copies (tests/test_torch_assets.py)
            assert tk.ASSETS_DIR == os.path.join(os.path.dirname(tk.__file__), "assets")
            continue
        want, got = getattr(jk, n), getattr(tk, n)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, n
            np.testing.assert_array_equal(got, want, err_msg=n)
        elif n == "ACT_DTYPE":
            assert got == want
        elif n == "CAMERAS":  # the port's own Cam class: compared field by field
            assert list(got) == list(want)
            for name, cam in want.items():
                assert dataclasses.asdict(got[name]) == dataclasses.asdict(cam), name
        else:
            assert got == want and type(got) is type(want), n


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_from_numpy_model_round_trips(name):
    jm, tm = jax_get_model(name), get_model(name)
    from_jax = from_numpy_model(jm)
    _assert_same(tm, from_jax, name)
    again = from_numpy_model(from_jax)
    _assert_same(from_jax, again, name)
    assert again.cache == {} and again is not from_jax


def test_model_tensors_cached_per_device():
    m = from_numpy_model(get_model("solo_arm"))
    t = model_tensors(m, "cpu")
    assert model_tensors(m, "cpu") is t
    assert t.jnt_pos.dtype.is_floating_point and t.jnt_pos.shape == (m.nq, 3)
    np.testing.assert_array_equal(t.kp_full.numpy()[: m.nu],
                                  m.actuator_kp.astype(np.float32))
    assert t.tip_right.tolist() == [tip.side == "r" for tip in m.fingertips]


def test_entry_points_default_to_the_card():
    """init_state, state_from_numpy and init_mppi put their tensors on the
    card unless the caller passes another device; with no card they raise
    rather than fall back to the CPU."""
    import inspect

    from gym_kmanip_torch.dynamics.state import init_state, state_from_numpy
    from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi

    for fn in (init_state, state_from_numpy, init_mppi):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    m = get_model("solo_arm")
    on_cpu = init_state(m, device="cpu")
    calls = (lambda: init_state(m), lambda: state_from_numpy(on_cpu),
             lambda: init_mppi(m, MPPIConfig(horizon=2)).nominal)
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            assert (out.qpos if hasattr(out, "qpos") else out).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
