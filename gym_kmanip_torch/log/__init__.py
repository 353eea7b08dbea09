"""Episode loggers: `log_h5py` writes the ACT / LeRobot HDF5 layout,
`log_rerun` the rerun visualization streams (a JSON-lines file without the
rerun SDK)."""
