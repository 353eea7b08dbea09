"""The benchmark's plain reference: the robot read from a frozen copy of
its MJCF file, the rollout with contacts and the pick cost, and the MPPI
solve, in plain PyTorch. It imports nothing of the system under test."""
