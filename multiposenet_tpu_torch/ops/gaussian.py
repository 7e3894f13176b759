"""Gaussian kernels as numpy constants — twin of the numpy part of
multiposenet_tpu/ops/gaussian.py.  scipy's kernel: radius
int(truncate * sigma + 0.5), weights exp(-0.5 (x/sigma)^2) normalised."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=16)
def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    out = (k / k.sum()).astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=16)
def blur_matrix(n: int, sigma: float = 1.0, mode: str = "nearest",
                truncate: float = 4.0) -> np.ndarray:
    """The 1-D gaussian blur as a dense (n, n) operator with the edge mode
    ('nearest' replicates, anything else zero-pads) baked in:
    blur_matrix(n) @ x == gaussian blur of x along that axis.  Read-only."""
    k = gaussian_kernel1d(float(sigma), truncate)
    r = (len(k) - 1) // 2
    g = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, kv in enumerate(k):
            j = i + t - r
            if mode == "nearest":
                j = min(max(j, 0), n - 1)
            elif not (0 <= j < n):
                continue
            g[i, j] += kv
    g.flags.writeable = False
    return g
