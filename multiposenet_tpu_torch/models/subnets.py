"""Subnet heads: keypoint estimation, RetinaNet detection heads, PRN —
PyTorch twin of multiposenet_tpu/models/subnets.py.

Conv heads take NCHW features.  The detection heads return (B, A, 4) and
(B, A, C) with anchors in (y, x, anchor) order, as the JAX heads reshape
their NHWC output; the PRN takes and returns the (B, gh, gw, 17) grids of
the JAX package and flattens them in (y, x, joint) order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multiposenet_tpu_torch.models.fpn import upsample_nearest


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class KeypointHead(nn.Module):
    """Keypoint subnet (reference posenet.py:162-187, 288-318).

    Per FPN level: 3x3 conv 256->128 (``convt``) + 3x3 conv 128->128
    (``convs``); upsample to stride 4; concat (p5, p4, p3, p2); 3x3 conv ->
    256; relu; 1x1 conv -> num_joints heatmaps.  Intermediate supervision:
    per-level 1x1 conv -> interm_channels upsampled to stride 4.
    """

    def __init__(self, num_joints: int = 18, interm_channels: int = 19,
                 mid_channels: int = 128, in_channels: int = 256):
        super().__init__()
        for k in range(2, 6):
            self.add_module(f"convfin_k{k}",
                            _conv(in_channels, interm_channels, 1))
        m = mid_channels
        for i in range(1, 5):
            self.add_module(f"convt{i}", _conv(in_channels, m, 3))
            self.add_module(f"convs{i}", _conv(m, m, 3))
        self.conv2 = _conv(4 * m, 256, 3)
        self.convfin = _conv(256, num_joints, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fp2, fp3, fp4, fp5 = feats
        hw = fp2.shape[2:4]
        saved = [
            self.convfin_k2(fp2),
            upsample_nearest(self.convfin_k3(fp3), hw),
            upsample_nearest(self.convfin_k4(fp4), hw),
            upsample_nearest(self.convfin_k5(fp5), hw),
        ]
        p5 = self.convs1(self.convt1(fp5))
        p4 = self.convs2(self.convt2(fp4))
        p3 = self.convs3(self.convt3(fp3))
        p2 = self.convs4(self.convt4(fp2))
        cat = torch.cat([upsample_nearest(p5, hw), upsample_nearest(p4, hw),
                         upsample_nearest(p3, hw), p2], dim=1)
        predict = self.convfin(F.relu(self.conv2(cat)))
        saved.append(predict)
        return predict, saved


def _nchw_to_anchors(out: torch.Tensor, per_anchor: int) -> torch.Tensor:
    """(B, A*k, H, W) -> (B, H*W*A, k) in (y, x, anchor) order."""
    b = out.shape[0]
    return out.permute(0, 2, 3, 1).reshape(b, -1, per_anchor)


class RegressionHead(nn.Module):
    """RetinaNet box regression trunk, shared across levels
    (reference posenet.py:33-69)."""

    def __init__(self, num_anchors: int = 9, feature_size: int = 256):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"conv{i}", _conv(feature_size, feature_size, 3))
        self.output = _conv(feature_size, num_anchors * 4, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return _nchw_to_anchors(self.output(x), 4)


class ClassificationHead(nn.Module):
    """RetinaNet classification trunk with sigmoid output
    (reference posenet.py:72-117)."""

    def __init__(self, num_anchors: int = 9, num_classes: int = 1,
                 feature_size: int = 256):
        super().__init__()
        self.num_classes = num_classes
        for i in range(1, 5):
            self.add_module(f"conv{i}", _conv(feature_size, feature_size, 3))
        self.output = _conv(feature_size, num_anchors * num_classes, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return _nchw_to_anchors(torch.sigmoid(self.output(x)), self.num_classes)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Flax's ``nn.Dropout``: keep each value with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate).  The mask is drawn from
    ``generator`` (on ``x``'s device), which ``F.dropout`` cannot take.

    ``shard=(i, n)``: ``x`` is the i-th of n equal slices of a global batch
    (process i of n).  The mask is drawn for the whole global batch and the
    i-th slice kept, so that every process's generator stays in step and n
    processes mask as one process does."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    i, n = shard
    b = x.shape[0]
    draw = torch.rand((n * b,) + tuple(x.shape[1:]), generator=generator,
                      device=x.device)
    keep = draw[i * b:(i + 1) * b] < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class PRN(nn.Module):
    """Pose Residual Network (reference posenet.py:130-152): a residual MLP
    over the flattened (gh, gw, 17) grid with a softmax over the whole
    vector, taken in at least float32.  With ``train=True``, dropout at
    ``rate`` follows ``dens1`` and ``bneck`` (subnets.py:151-153), its
    masks drawn from ``generator`` for slice ``shard`` of the global
    batch (``dropout``); otherwise dropout is the identity.
    """

    def __init__(self, node_count: int = 1024, coeff: int = 2,
                 rate: float = 0.5):
        super().__init__()
        self.height, self.width = 28 * coeff, 18 * coeff
        self.rate = rate
        d = self.height * self.width * 17
        self.dens1 = nn.Linear(d, node_count)
        self.bneck = nn.Linear(node_count, node_count)
        self.dens2 = nn.Linear(node_count, d)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
                train: bool = False, generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        if train and self.rate > 0.0 and generator is None:
            raise ValueError("PRN training with dropout needs a generator")
        b = x.shape[0]
        res = x.reshape(b, -1).to(compute_dtype)
        out = F.relu(self.dens1(res))
        if train:
            out = dropout(out, self.rate, generator, shard)
        out = F.relu(self.bneck(out))
        if train:
            out = dropout(out, self.rate, generator, shard)
        out = F.relu(self.dens2(out))
        out = (out + res).to(torch.promote_types(out.dtype, torch.float32))
        return torch.softmax(out, dim=1).reshape(b, self.height, self.width, 17)
