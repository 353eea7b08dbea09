"""The port's plant step (`engine.control_step`: ten 2 ms substeps and the
end-of-step diagnostics) against the JAX package's on the same inputs.

Both sides compute on identical constants (`from_numpy_model`). Tolerances:
qpos 1e-5, qvel and cube 1e-4, sites and fingertips 1e-5, flags exact.
`qpos_force` is held against the JAX package in tests/test_torch_env_jax.py.
"""

import jax
import numpy as np
import torch

from gym_kmanip_tpu.dynamics.engine import control_step as jcontrol_step
from gym_kmanip_tpu.dynamics.state import init_state as jinit_state
from gym_kmanip_tpu.models import get_model as jax_get_model

from gym_kmanip_torch.dynamics import engine
from gym_kmanip_torch.dynamics.state import state_from_numpy, state_to_numpy
from gym_kmanip_torch.models import from_numpy_model

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               atol=atol, rtol=0, err_msg=msg)


def test_control_step_matches_jax():
    jm = jax_get_model("solo_arm")
    m = from_numpy_model(jm)
    rng = np.random.RandomState(5)
    js = jinit_state(jm, cube_pos=np.array([0.15, 0.58, 0.62]))
    ctrl = (jm.home_qpos[: jm.nu] + rng.randn(jm.nu) * 0.1).astype(np.float32)
    js2, jaux = jax.jit(lambda s, u: jcontrol_step(jm, s, u))(js, ctrl)

    s = state_from_numpy(js, device="cpu")
    s2, aux = engine.control_step(m, s, _t(ctrl))
    want = state_to_numpy(state_from_numpy(js2, device="cpu"))
    _close(s2.qpos, want.qpos, 1e-5)
    _close(s2.qvel, want.qvel, 1e-4)
    for f in ("cube_pos", "cube_quat", "cube_linvel", "cube_angvel"):
        _close(getattr(s2, f), getattr(want, f), 1e-4, f)
    _close(s2.time, want.time, 1e-6)
    for f in ("site_pos", "site_quat", "tip_pos"):
        _close(getattr(aux, f), getattr(jaux, f), 1e-5, f)
    for f in ("touch_r", "touch_l", "touch_table"):
        assert bool(getattr(aux, f)) == bool(getattr(jaux, f)), f
    # forces at the state's own qpos: the first substep's rebase is the
    # plain integration (no joint reaches the safety clamp here)
    s3, aux3 = engine.control_step(m, s, _t(ctrl), qpos_force=s.qpos)
    for f in s2._fields:
        assert torch.equal(getattr(s3, f), getattr(s2, f)), f
    assert torch.equal(aux3.site_pos, aux.site_pos) and bool(aux3.touch_r) == bool(aux.touch_r)
