"""Batched articulated dynamics in PyTorch (port of gym_kmanip_tpu.dynamics)."""

from gym_kmanip_torch.dynamics.state import SimState, StepAux, init_state
from gym_kmanip_torch.dynamics.engine import control_step, substep

__all__ = ["SimState", "StepAux", "init_state", "control_step", "substep"]
