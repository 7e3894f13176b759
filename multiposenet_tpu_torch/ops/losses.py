"""Loss functions — masked-MSE keypoint loss, RetinaNet focal loss, PRN BCE;
PyTorch twin of multiposenet_tpu/ops/losses.py.

The reference's FocalLoss loops over the batch in Python on dynamic tensors
(reference network/losses.py:41-137).  Here GT boxes arrive padded to
(B, N, 5) with -1 rows (the reference bbox_collater,
COCO_data_pipeline.py:444-457), and every image of the batch is one slice of
the same tensor ops, with the padding masked out arithmetically.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from multiposenet_tpu_torch.ops.boxes import box_iou, encode_boxes


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 activations up to float32; float64 stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# --------------------------------------------------------------------------
# Keypoint subnet: 5-term masked MSE (reference network/posenet.py:367-403)
# --------------------------------------------------------------------------

KEYPOINT_LOSS_NAMES = ("heatmap_loss_k2", "heatmap_loss_k3", "heatmap_loss_k4",
                       "heatmap_loss_k5", "heatmap_loss")


def keypoint_loss(saved_for_loss: Sequence[torch.Tensor],
                  heat_target: torch.Tensor, heat_mask: torch.Tensor,
                  num_joints: int = 18
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked MSE over the 4 intermediate heads and the final head.

    saved_for_loss: 5 NHWC tensors with >= num_joints channels (the
    intermediate ones have 19; only :num_joints enter the loss).
    heat_target, heat_mask: (B, H, W, num_joints).
    Logs each term and the final head's ``max_ht``/``min_ht``.
    """
    logs = {}
    total = torch.zeros((), dtype=torch.float32, device=heat_target.device)
    gt = _at_least_f32(heat_mask * heat_target)
    for name, out in zip(KEYPOINT_LOSS_NAMES, saved_for_loss):
        pred = _at_least_f32(out[..., :num_joints]) * heat_mask
        loss = torch.mean(torch.square(pred - gt))
        logs[name] = loss
        total = total + loss
    final = saved_for_loss[-1][..., :num_joints]
    logs["max_ht"] = final.max()
    logs["min_ht"] = final.min()
    return total, logs


# --------------------------------------------------------------------------
# Detection subnet: focal + smooth-L1 (reference network/losses.py:25-137)
# --------------------------------------------------------------------------

def focal_loss_single(classification: torch.Tensor, regression: torch.Tensor,
                      anchors: torch.Tensor, annotations: torch.Tensor,
                      alpha: float = 0.25, gamma: float = 2.0,
                      pos_iou: float = 0.5, neg_iou: float = 0.4,
                      beta: float = 1.0 / 9.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image focal classification loss and smooth-L1 regression loss.

    classification (..., A, C) sigmoid probabilities, regression (..., A, 4),
    anchors (A, 4), annotations (..., N, 5) x1y1x2y2 + class, pad rows -1.
    Leading dims are images; returns losses of shape (...,).

    The reference's semantics: anchors with IoU in [neg_iou, pos_iou) are
    ignored; each anchor takes the first GT of largest IoU (padding rows
    never win: their IoU is -1); the classification loss is normalised by
    clamp(num_pos, 1); the regression loss averages over positive anchors
    x 4 coordinates; an image without GT has both losses 0
    (reference losses.py:50-55).
    """
    num_classes = classification.shape[-1]
    ann_valid = annotations[..., 4] != -1                            # (..., N)
    num_valid = ann_valid.sum(-1)

    cls = _at_least_f32(classification).clamp(1e-4, 1.0 - 1e-4)

    iou = box_iou(anchors, annotations[..., :4])                     # (..., A, N)
    iou = torch.where(ann_valid[..., None, :], iou, -1.0)
    iou_max = iou.amax(-1)
    iou_argmax = iou.argmax(-1)                                      # first max

    assigned = torch.gather(                                         # (..., A, 5)
        annotations, -2,
        iou_argmax[..., None].expand(*iou_argmax.shape, annotations.shape[-1]))
    positive = iou_max >= pos_iou
    negative = iou_max < neg_iou
    num_pos = positive.sum(-1).float()

    # targets: 1 at the assigned class of a positive, 0 on its other
    # channels and on negatives, -1 (ignored) in between
    assigned_cls = assigned[..., 4].to(torch.int64).clamp(0, num_classes - 1)
    one_hot = F.one_hot(assigned_cls, num_classes).float()
    targets = torch.where(positive[..., None], one_hot,
                          torch.where(negative[..., None], 0.0, -1.0))

    is_one = targets == 1.0
    alpha_factor = torch.where(is_one, alpha, 1.0 - alpha)
    focal_weight = torch.where(is_one, 1.0 - cls, cls)
    focal_weight = alpha_factor * torch.pow(focal_weight, gamma)
    bce = -(targets * torch.log(cls) + (1.0 - targets) * torch.log(1.0 - cls))
    cls_loss = torch.where(targets != -1.0, focal_weight * bce, 0.0)
    cls_loss = cls_loss.sum((-2, -1)) / num_pos.clamp(min=1.0)

    # regression: smooth L1 on the encoded deltas of positive anchors
    reg_targets = encode_boxes(anchors, assigned[..., :4])
    diff = torch.abs(reg_targets - _at_least_f32(regression))
    smooth = torch.where(diff <= beta, 0.5 / beta * torch.square(diff),
                         diff - 0.5 * beta)
    pos_f = positive.float()[..., None]
    reg_loss = (smooth * pos_f).sum((-2, -1)) / (4.0 * num_pos).clamp(min=1.0)
    reg_loss = torch.where(num_pos > 0, reg_loss, 0.0)

    has_ann = num_valid > 0
    return (torch.where(has_ann, cls_loss, 0.0),
            torch.where(has_ann, reg_loss, 0.0))


def detection_loss(classification: torch.Tensor, regression: torch.Tensor,
                   anchors: torch.Tensor, annotations: torch.Tensor, **kw
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, A, C), (B, A, 4), anchors (A, 4), GT (B, N, 5) -> the batch mean
    of the per-image focal and regression losses, and their sum."""
    cls_l, reg_l = focal_loss_single(classification, regression, anchors,
                                     annotations, **kw)
    cls_loss = cls_l.mean()
    reg_loss = reg_l.mean()
    total = cls_loss + reg_loss
    return total, {"total_loss": total, "classification_loss": cls_loss,
                   "regression_loss": reg_loss}


# --------------------------------------------------------------------------
# PRN subnet: BCE (reference network/posenet.py:427-445)
# --------------------------------------------------------------------------

def prn_loss(output: torch.Tensor, label: torch.Tensor, eps: float = 1e-12
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, H, W, 17) softmax output in (0, 1) and gaussian targets -> BCE."""
    out = _at_least_f32(output).clamp(eps, 1.0 - eps)
    lbl = _at_least_f32(label)
    loss = -torch.mean(lbl * torch.log(out) + (1.0 - lbl) * torch.log(1.0 - out))
    return loss, {"prn_loss": loss}
