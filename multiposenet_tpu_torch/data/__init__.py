"""data of multiposenet_tpu_torch (see the package docstring)."""
