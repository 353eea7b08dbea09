"""The benchmark's own tests: on the CPU, at tiny sizes; the ones that need
the card are marked `cuda` and skip without one.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(name: str = "solo_pick.k256", horizon: int = 4, n_samples: int = 8):
    """A cell of the manifest cut to a size the CPU runs in a second."""
    from harness import manifest

    cell = manifest.load_cell(name)
    config = dict(cell.config, mppi=dict(cell.config["mppi"], horizon=horizon))
    traffic = dict(cell.traffic, n_samples=n_samples, start_states=16, warmup_solves=2,
                   check_solves=2, trace_solves=2)
    return cell._replace(config=config, traffic=traffic)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")
