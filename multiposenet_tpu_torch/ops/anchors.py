"""RetinaNet anchor generation — numpy twin of multiposenet_tpu/ops/anchors.py.

Anchors are a pure function of the static input shape: computed once in
numpy per shape and uploaded once by the pipeline.  Numerics follow the
reference exactly (network/anchors.py:39-126): base anchors, grid shift with
a +0.5 cell-centre offset, per-level feature shapes by ceil-division.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

from multiposenet_tpu_torch.config import AnchorConfig


def generate_base_anchors(base_size: float, ratios: Sequence[float],
                          scales: Sequence[float]) -> np.ndarray:
    """(len(ratios)*len(scales), 4) anchors in x1y1x2y2 centred at origin."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    num = len(ratios) * len(scales)

    anchors = np.zeros((num, 4), dtype=np.float64)
    anchors[:, 2:] = base_size * np.tile(scales, (2, len(ratios))).T
    areas = anchors[:, 2] * anchors[:, 3]
    # w = sqrt(area/ratio), h = w * ratio
    anchors[:, 2] = np.sqrt(areas / np.repeat(ratios, len(scales)))
    anchors[:, 3] = anchors[:, 2] * np.repeat(ratios, len(scales))
    anchors[:, 0::2] -= np.tile(anchors[:, 2] * 0.5, (2, 1)).T
    anchors[:, 1::2] -= np.tile(anchors[:, 3] * 0.5, (2, 1)).T
    return anchors


def _shift(feat_shape: Tuple[int, int], stride: int,
           anchors: np.ndarray) -> np.ndarray:
    """Tile base anchors over a feature grid; anchor index fastest."""
    shift_x = (np.arange(0, feat_shape[1]) + 0.5) * stride
    shift_y = (np.arange(0, feat_shape[0]) + 0.5) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    return (shifts[:, None, :] + anchors[None, :, :]).reshape(-1, 4)


@functools.lru_cache(maxsize=64)
def anchors_for_shape(image_shape: Tuple[int, int],
                      cfg: AnchorConfig = AnchorConfig()) -> np.ndarray:
    """All anchors for an (H, W) input, concatenated over pyramid levels, as
    a float32 (A_total, 4) array (read-only: the cache shares it)."""
    image_shape = np.asarray(image_shape[:2])
    all_anchors = []
    for level, stride, size in zip(cfg.pyramid_levels, cfg.strides, cfg.sizes):
        feat_shape = (image_shape + 2 ** level - 1) // (2 ** level)
        base = generate_base_anchors(size, cfg.ratios, cfg.scales)
        all_anchors.append(_shift(tuple(int(x) for x in feat_shape), stride, base))
    out = np.concatenate(all_anchors, axis=0).astype(np.float32)
    out.flags.writeable = False
    return out
