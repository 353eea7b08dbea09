"""Examples of the port, each a module with a `main()` whose sizes and
`device` are keyword arguments (the JAX package's constants by default):

    python -m gym_kmanip_torch.examples.9_mpc_ilqr
"""
