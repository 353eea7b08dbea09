"""Multi-process solves: the ("rollout",) mesh over the ranks of a
`torch.distributed` process group (parallel/mesh.py)."""
