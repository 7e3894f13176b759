"""The benchmark of the PyTorch/CUDA port ``multiposenet_tpu_torch``; see
``run.py``."""
