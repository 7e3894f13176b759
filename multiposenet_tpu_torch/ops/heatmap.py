"""Gaussian heatmap targets, built on the device inside the keypoint train
step — PyTorch twin of multiposenet_tpu/ops/heatmap.py.

The reference draws them per joint per person in numpy in its data workers
(reference datasets/coco_data/heatmap.py:20-41, putGaussianMaps).  Here they
are one batched function of the padded joint array, so the host ships a
(B, P, J, 3) joint tensor instead of a (H/4, W/4, J) map per sample.

Numerics are putGaussianMaps':
  grid      = ix * stride + stride/2 - 0.5
  exponent  = d^2 / (2 sigma^2), cut off at 4.6052 (= ln(100))
  channel   = clip(sum over people, 0, 1)
(the reference's accumulate-then-clip equals sum-then-clip, since every
contribution is non-negative.)
"""

from __future__ import annotations

import numpy as np
import torch

LN100 = 4.6052


def make_heatmaps(joints: torch.Tensor, grid_h: int, grid_w: int,
                  stride: int = 4, sigma: float = 7.0) -> torch.Tensor:
    """(B, P, J, 3) padded joints -> (B, grid_h, grid_w, J) heatmaps.

    ``joints[..., 2]`` is the visibility; a gaussian is drawn iff v <= 1
    (reference COCO_data_pipeline.py:225-235).  Pad rows carry v = 2.
    """
    start = stride / 2.0 - 0.5
    dev = joints.device
    ys = torch.arange(grid_h, dtype=torch.float32, device=dev) * stride + start
    xs = torch.arange(grid_w, dtype=torch.float32, device=dev) * stride + start

    joints = joints.float()
    cx, cy = joints[..., 0], joints[..., 1]                  # (B, P, J)
    draw = (joints[..., 2] <= 1.0).float()

    dx2 = torch.square(xs - cx[..., None])                   # (B, P, J, W)
    dy2 = torch.square(ys - cy[..., None])                   # (B, P, J, H)
    # a tensor divisor: a scalar one would be taken as a reciprocal product
    # on CUDA and round differently from the JAX division
    denom = torch.tensor(2.0 * sigma * sigma, dtype=torch.float32, device=dev)
    expo = (dy2[..., :, None] + dx2[..., None, :]) / denom   # (B, P, J, H, W)
    g = torch.where(expo <= LN100, torch.exp(-expo), 0.0)
    g = g * draw[..., None, None]
    heat = g.sum(dim=1).clamp(0.0, 1.0)                      # (B, J, H, W)
    return heat.permute(0, 2, 3, 1)


def make_heatmaps_np(joints: np.ndarray, grid_h: int, grid_w: int,
                     stride: int = 4, sigma: float = 7.0) -> np.ndarray:
    """Numpy twin of ``make_heatmaps`` for one image: (P, J, 3) ->
    (grid_h, grid_w, J), drawn person by person as the reference does."""
    start = stride / 2.0 - 0.5
    ys = np.arange(grid_h, dtype=np.float32) * stride + start
    xs = np.arange(grid_w, dtype=np.float32) * stride + start
    num_j = joints.shape[1]
    heat = np.zeros((grid_h, grid_w, num_j), dtype=np.float32)
    for p in range(joints.shape[0]):
        for j in range(num_j):
            if joints[p, j, 2] > 1:
                continue
            d2 = (xs[None, :] - joints[p, j, 0]) ** 2 + (ys[:, None] - joints[p, j, 1]) ** 2
            expo = d2 / (2.0 * sigma * sigma)
            g = np.where(expo <= LN100, np.exp(-expo), 0.0)
            heat[:, :, j] = np.clip(heat[:, :, j] + g, 0.0, 1.0)
    return heat
