"""Kinematics, linear algebra and the hand-written CUDA kernels."""
