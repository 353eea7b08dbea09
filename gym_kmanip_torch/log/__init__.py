"""Episode loggers: `log_h5py` writes the ACT / LeRobot HDF5 layout."""
