"""Sampling MPC: rollouts, costs and MPPI (port of gym_kmanip_tpu.mpc)."""
