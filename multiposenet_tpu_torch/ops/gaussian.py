"""Separable gaussian blur — PyTorch twin of multiposenet_tpu/ops/gaussian.py,
the device form of scipy's ``gaussian_filter`` (which skimage's ``gaussian``
wraps).  scipy's kernel: radius int(truncate * sigma + 0.5), weights
exp(-0.5 (x/sigma)^2) normalised.

The inference PRN stage blurs its grids with the dense operators of
``blur_matrix`` (engine/inference.py); the PRN train step blurs its target
marks with ``gaussian_blur``, a depthwise 1-D convolution per axis
(engine/train_steps.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


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


def gaussian_blur(x: torch.Tensor, sigma: float = 1.0, mode: str = "nearest",
                  truncate: float = 4.0) -> torch.Tensor:
    """Blur the spatial dims of (..., H, W, C) in float32: pad H (edge copies
    for 'nearest', zeros for 'constant'), convolve it, then pad and
    convolve W, as scipy filters one axis after the other.  Each axis is a
    depthwise convolution with the 1-D kernel.  On a GPU, run it with TF32
    off (``engine.inference.full_fp32_matmul``): the JAX blur runs at
    ``Precision.HIGHEST``."""
    if mode not in ("nearest", "constant"):
        raise ValueError(f"mode {mode!r}: 'nearest' or 'constant'")
    k = torch.from_numpy(np.array(gaussian_kernel1d(float(sigma), truncate)))
    r = (k.shape[0] - 1) // 2
    shape = x.shape
    h, w, c = shape[-3], shape[-2], shape[-1]
    xb = x.reshape(-1, h, w, c).float().permute(0, 3, 1, 2)      # (N, C, H, W)
    k = k.to(xb.device)
    pad_mode = "replicate" if mode == "nearest" else "constant"
    xb = F.conv2d(F.pad(xb, (0, 0, r, r), mode=pad_mode),
                  k.view(1, 1, -1, 1).repeat(c, 1, 1, 1), groups=c)
    xb = F.conv2d(F.pad(xb, (r, r, 0, 0), mode=pad_mode),
                  k.view(1, 1, 1, -1).repeat(c, 1, 1, 1), groups=c)
    return xb.permute(0, 2, 3, 1).reshape(shape)
