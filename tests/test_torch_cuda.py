"""The substep CUDA kernel against its plain PyTorch version, on the card.

Skips without a GPU. This file imports neither JAX nor the JAX package, so
it runs on a GPU host that has neither; there, skip tests/conftest.py
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are those the JAX package holds its Pallas substep to
(tests/test_pallas.py:202-207): qpos and xpos 1e-5, qvel and cube 1e-4,
touch flags exact.
"""

import numpy as np
import pytest
import torch

from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.ops import substep_cuda

pytestmark = pytest.mark.cuda

MODES = [(0.02, True), (0.002, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU, and nvcc to build the kernel")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["solo_arm", "torso"])
@pytest.mark.parametrize("dt,implicit", MODES)
def test_kernel_matches_plain_on_cuda(cuda, name, dt, implicit):
    m = get_model(name)
    inputs = [torch.as_tensor(a, device=cuda)
              for a in substep_cuda.random_inputs(m, 256, seed=11)]
    before = substep_cuda.substep_batched.launches
    got = substep_cuda.substep_batched(m, dt, True, implicit, *inputs)
    want = substep_cuda.substep_batched_reference(m, dt, True, implicit, *inputs)
    torch.cuda.synchronize()
    assert substep_cuda.substep_batched.launches == before + 1
    for name_, g, w, tol in zip(("qpos", "qvel", "cube13", "touch", "xpos", "xquat"),
                                got, want, (1e-5, 1e-4, 1e-4, None, 1e-5, 1e-5)):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if tol is None:
            np.testing.assert_array_equal(g, w, err_msg=name_)
        else:
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name_)


def test_wrapper_refuses_bad_inputs(cuda):
    m = get_model("solo_arm")
    q, v, c, cube = (torch.as_tensor(a, device=cuda)
                     for a in substep_cuda.random_inputs(m, 8, seed=0))
    with pytest.raises(TypeError):
        substep_cuda.substep_batched(m, 0.02, True, True, q.double(), v, c, cube)
    with pytest.raises(ValueError):
        substep_cuda.substep_batched(m, 0.02, True, True, q, v, c, cube[:, :12])
    wide = torch.zeros(8, 2 * m.nq, device=cuda)
    with pytest.raises(ValueError):
        substep_cuda.substep_batched(m, 0.02, True, True, wide[:, ::2], v, c, cube)
    with pytest.raises(ValueError):
        substep_cuda.substep_batched(m, 0.02, True, True, q.cpu(), v, c, cube)
