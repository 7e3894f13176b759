"""Host utilities: the training engine's meters, timer, logger and metrics,
and the reference's HDF5 checkpoint files (``h5file``)."""
