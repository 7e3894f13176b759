"""Box transforms and +1px IoU — PyTorch twin of multiposenet_tpu/ops/boxes.py
(reference network/utils.py, lib/nms/src/nms.c:55-58).  Every function keeps
the JAX op order, so float32 results round the same way."""

from __future__ import annotations

import torch

BBOX_STD = (0.1, 0.1, 0.2, 0.2)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 std=BBOX_STD) -> torch.Tensor:
    """(..., A, 4) x1y1x2y2 anchors + (..., A, 4) deltas -> x1y1x2y2 boxes."""
    widths = anchors[..., 2] - anchors[..., 0]
    heights = anchors[..., 3] - anchors[..., 1]
    ctr_x = anchors[..., 0] + 0.5 * widths
    ctr_y = anchors[..., 1] + 0.5 * heights

    dx = deltas[..., 0] * std[0]
    dy = deltas[..., 1] * std[1]
    dw = deltas[..., 2] * std[2]
    dh = deltas[..., 3] * std[3]

    pred_ctr_x = ctr_x + dx * widths
    pred_ctr_y = ctr_y + dy * heights
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack(
        [pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
         pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Clamp x1,y1 to >= 0 and x2,y2 to <= width/height.  A box decoded past
    the image edge can come out with x2 < x1: that is kept, as in JAX."""
    return torch.stack(
        [boxes[..., 0].clamp(min=0.0), boxes[..., 1].clamp(min=0.0),
         boxes[..., 2].clamp(max=float(width)),
         boxes[..., 3].clamp(max=float(height))], dim=-1)


def box_iou_plus1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix (..., N, 4) x (..., M, 4) -> (..., N, M) with the legacy
    +1-pixel convention of the reference's native NMS."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]) + 1.0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]) + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)
