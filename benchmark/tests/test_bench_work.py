"""The frozen work counts give chip_smoke.py's numbers at both robots'
sizes (they were copied from it and are never updated to follow a
kernel)."""

import importlib.util
import os

import pytest
import torch

from harness import work
from reference import model as rmodel

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module; it stops at import without a card, so
    the import is told there is one (its counts need none)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_counts",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
def test_counts_match_chip_smoke(smoke, name):
    from gym_kmanip_torch.models import get_model

    m, r = get_model(name), rmodel.load(name)
    assert work.rnea_flops(r) == smoke.rnea_flops(m)
    assert work.contact_flops(r) == smoke.contact_flops(m)
    assert work.chol_flops(r.nq, 4) == smoke.chol_flops(m.nq, 4)
    for contact in (True, False):
        assert work.substep_flops(r, contact) == smoke.substep_flops(m, contact)
    assert work.pick_cost_flops(r) == smoke.pick_cost_flops(m)
    assert work.FP32_FLOP_PER_S == smoke.FP32_FLOP_PER_S
    assert work.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    # chip_smoke.py's K2 bound at the fused solve's shape
    K, H = 256, 50
    flops, nbytes = work.rollout_pick_work(r, K, H, 1, True)
    assert flops == K * H * (smoke.substep_flops(m, True) + smoke.pick_cost_flops(m))
    assert nbytes == 4 * (K * H * m.nu + 2 * m.nq + 13 + K)
