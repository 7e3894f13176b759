"""Host utilities: the training engine's meters, the tracer (``trace``:
spans and their totals), the logger and metrics,
and the reference's HDF5 checkpoint files (``h5file``)."""
