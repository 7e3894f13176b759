"""The detection stage's train step in plain PyTorch: the benchmark's frozen
reference (published: LiMeng95/MultiPoseNet.pytorch
multipose_detection_train.py, network/losses.py FocalLoss, training/trainer.py).
Imports nothing of the program.

The trunk and the keypoint parts are frozen; the RetinaNet pyramid
(conv6, conv7, latlayer1-3, toplayer0-2) and both heads train with Adam
(betas 0.9 / 0.999, eps 1e-8, no weight decay).  The loss is the focal loss
(alpha 0.25, gamma 2) over anchors with IoU >= 0.5 positive and < 0.4
negative, normalised per image by its positives, plus the smooth-L1 loss
(beta 1/9) of the positives' encoded boxes, each averaged over the batch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch

from mpn_bench.reference.model import PoseNet, preprocess
from mpn_bench.reference.post import BBOX_STD

TRAINABLE_PREFIXES = ("fpn.conv6.", "fpn.conv7.", "fpn.latlayer", "fpn.toplayer0.",
                      "fpn.toplayer1.", "fpn.toplayer2.", "regressionModel.",
                      "classificationModel.")


def trainable(name: str) -> bool:
    return name.startswith(TRAINABLE_PREFIXES)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A, 4) x (N, 4) x1y1x2y2 -> (A, N) IoU, the union clamped at 1e-8."""
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None] - inter).clamp(min=1e-8)


def focal_loss(cls: torch.Tensor, reg: torch.Tensor, anchors: torch.Tensor,
               annotations: torch.Tensor, alpha=0.25, gamma=2.0, beta=1.0 / 9.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch means of the per-image focal and regression losses; GT rows
    whose class is -1 are padding."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + 0.5 * aw
    ay = anchors[:, 1] + 0.5 * ah
    std = torch.tensor(BBOX_STD, device=cls.device)
    cls_losses, reg_losses = [], []
    for j in range(cls.shape[0]):
        ann = annotations[j]
        ann = ann[ann[:, 4] != -1]
        if ann.shape[0] == 0:
            cls_losses.append(cls.new_zeros(()))
            reg_losses.append(cls.new_zeros(()))
            continue
        c = cls[j].clamp(1e-4, 1.0 - 1e-4)
        iou = box_iou(anchors, ann[:, :4])
        iou_max, iou_arg = iou.max(dim=1)
        targets = torch.full_like(c, -1.0)
        targets[iou_max < 0.4] = 0.0
        positive = iou_max >= 0.5
        num_pos = positive.sum()
        assigned = ann[iou_arg]
        targets[positive] = 0.0
        targets[positive, assigned[positive, 4].long()] = 1.0
        alpha_f = torch.where(targets == 1.0, alpha, 1.0 - alpha)
        focal_w = torch.where(targets == 1.0, 1.0 - c, c)
        focal_w = alpha_f * focal_w ** gamma
        bce = -(targets * torch.log(c) + (1.0 - targets) * torch.log(1.0 - c))
        loss = torch.where(targets != -1.0, focal_w * bce, 0.0)
        cls_losses.append(loss.sum() / num_pos.clamp(min=1).float())
        if num_pos > 0:
            a = assigned[positive]
            gw = (a[:, 2] - a[:, 0]).clamp(min=1.0)
            gh = (a[:, 3] - a[:, 1]).clamp(min=1.0)
            gx = a[:, 0] + 0.5 * (a[:, 2] - a[:, 0])
            gy = a[:, 1] + 0.5 * (a[:, 3] - a[:, 1])
            t = torch.stack([(gx - ax[positive]) / aw[positive],
                             (gy - ay[positive]) / ah[positive],
                             torch.log(gw / aw[positive]),
                             torch.log(gh / ah[positive])], dim=1) / std
            diff = (t - reg[j][positive]).abs()
            reg_losses.append(torch.where(diff <= beta, 0.5 * diff ** 2 / beta,
                                          diff - 0.5 * beta).mean())
        else:
            reg_losses.append(cls.new_zeros(()))
    return torch.stack(cls_losses).mean(), torch.stack(reg_losses).mean()


def detection_steps(model: PoseNet, batches: Sequence[Dict[str, torch.Tensor]],
                    anchors: torch.Tensor, lr: float, autocast_dtype=None,
                    half_batch: bool = False
                    ) -> Tuple[List[float], Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """Train ``model`` in place for one step per batch.  Returns each
    step's loss, the first step's gradient and each parameter's change
    over the steps, by parameter name.  ``autocast_dtype`` runs the
    forward under autocast (the control); ``half_batch`` leaves out the
    second half of every batch (a fault)."""
    params = {n: p for n, p in model.named_parameters()}
    names = [n for n in params if trainable(n)]
    for n, p in params.items():
        p.requires_grad_(n in names)
    start = {n: params[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    dev = anchors.device
    for t, batch in enumerate(batches, start=1):
        img = preprocess(batch["image"].to(dev))
        ann = batch["boxes"].to(dev).float()
        if half_batch:
            img, ann = img[: img.shape[0] // 2], ann[: ann.shape[0] // 2]
        ctx = (torch.autocast(dev.type, dtype=autocast_dtype)
               if autocast_dtype is not None else contextlib.nullcontext())
        with ctx:
            cls, reg = model.detection_forward(img)
        cls_l, reg_l = focal_loss(cls.float(), reg.float(), anchors, ann)
        loss = cls_l + reg_l
        # a batch without positives leaves the regression head unused
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)]
        with torch.no_grad():
            for n, g in zip(names, grads):
                if t == 1:
                    first[n] = g.detach().clone()
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                params[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
        losses.append(float(loss.detach()))
    delta = {n: params[n].detach() - start[n] for n in names}
    return losses, first, delta
