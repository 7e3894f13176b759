"""Host utilities of the training engine: meters, timer, logger, metrics."""
