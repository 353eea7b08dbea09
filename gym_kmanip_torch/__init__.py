"""gym_kmanip_torch: the PyTorch + CUDA port of gym_kmanip_tpu.

The JAX package (`gym_kmanip_tpu`) is the reference; this package mirrors
its module names and is held to it by `tests/test_torch_*.py`. It imports
torch and numpy only, never JAX or the JAX package (gymnasium only where
`env.register()` or the Gym shell `KManipEnv` is asked for), and reads the
JAX package's MJCF assets by path.

Ported so far: the solo-arm MPPI pick solve (models, dynamics, MPC), the
iLQR solve (solvers/ilqr.py, solvers/parallel_lqr.py), the single Gym env
for all eight ids (env/, solvers/ik_host.py, native/), the vectorized env
(env/vec_env.py, solvers/trf.py, solvers/ik.py), the vision serving path
(render/raycast.py, mpc/vision_cost.py, zoo/) and examples 8, 9, 11 and
12. Every Pallas kernel of the JAX package is a hand-written CUDA
kernel for Hopper in `csrc/`, bound by the `ops/*_cuda.py` wrappers.
"""

__version__ = "0.1.0"
