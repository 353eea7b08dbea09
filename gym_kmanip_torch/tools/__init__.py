"""Measurement tools of the port, each run as `python -m gym_kmanip_torch.tools.<name>`."""
