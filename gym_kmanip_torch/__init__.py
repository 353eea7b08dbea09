"""gym_kmanip_torch: the PyTorch + CUDA port of gym_kmanip_tpu.

The JAX package (`gym_kmanip_tpu`) is the reference; this package mirrors
its module names and is held to it by `tests/test_torch_*.py`. It imports
torch and numpy only, never JAX, gymnasium or the JAX package, and reads
the JAX package's MJCF assets by path.

Ported so far: the solo-arm MPPI pick solve (models, dynamics, MPC), with
the physics substep as a hand-written CUDA kernel for Hopper
(`ops/substep_cuda.py`, `csrc/substep.cu`).
"""

__version__ = "0.1.0"
