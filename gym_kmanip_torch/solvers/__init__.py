"""Trajectory optimizers: iLQR."""
