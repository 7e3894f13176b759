"""Box transforms and IoU — PyTorch twin of multiposenet_tpu/ops/boxes.py
(reference network/utils.py, network/losses.py:5-22, lib/nms/src/nms.c:55-58).
Every function keeps the JAX op order, so float32 results round the same
way.  The reference has two IoU conventions: the standard one inside the
focal loss (``box_iou``) and a +1-pixel one inside NMS (``box_iou_plus1``)."""

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


def encode_boxes(anchors: torch.Tensor, gt: torch.Tensor,
                 std=BBOX_STD) -> torch.Tensor:
    """Encode gt boxes against anchors, the focal loss's regression target:
    (..., 4) x1y1x2y2 each -> (..., 4) normalised (dx, dy, dw, dh).  The gt
    width and height are clamped to >= 1 (reference losses.py:112-113)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah

    gw = (gt[..., 2] - gt[..., 0]).clamp(min=1.0)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=1.0)
    gx = gt[..., 0] + 0.5 * (gt[..., 2] - gt[..., 0])
    gy = gt[..., 1] + 0.5 * (gt[..., 3] - gt[..., 1])

    t = torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                     torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
    # divided by a tensor, as JAX divides by its float32 array
    return t / torch.tensor(std, dtype=t.dtype, device=t.device)


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


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Standard IoU matrix (..., N, 4) x (..., M, 4) -> (..., N, M), the
    union clamped to >= 1e-8 (reference losses.py:5-22)."""
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])).clamp(min=0.0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])).clamp(min=0.0)
    inter = iw * ih
    union = (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(min=1e-8)
    return inter / union
