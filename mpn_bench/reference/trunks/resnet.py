"""ResNet-50 and ResNet-101 (He et al., arXiv 1512.03385) in torchvision's
layout, the published MultiPoseNet's trunk: the 7x7 stem and max pool, then
four stages of bottlenecks whose outputs c2-c5 have 256, 512, 1024 and 2048
channels at strides 4-32.  BatchNorm normalises with its running
statistics.  Every convolution goes through ``model.conv``."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from mpn_bench.reference import model as ref_model

NAMES = ("resnet50", "resnet101")
BLOCK_COUNTS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
PLANES = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)
EXPANSION = 4


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * EXPANSION, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * EXPANSION)
        self.downsample = None
        if stride != 1 or inplanes != planes * EXPANSION:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * EXPANSION, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes * EXPANSION))

    def run(self, x: torch.Tensor, q: ref_model.Quant) -> torch.Tensor:
        conv, bn = ref_model.conv, ref_model.bn
        out = F.relu(bn(self.bn1, conv(self.conv1, x, q)))
        out = F.relu(bn(self.bn2, conv(self.conv2, out, q)))
        out = bn(self.bn3, conv(self.conv3, out, q))
        if self.downsample is not None:
            x = bn(self.downsample[1], conv(self.downsample[0], x, q))
        return F.relu(out + x)


def build(name: str) -> ref_model.Trunk:
    modules = {"conv1": nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
               "bn1": nn.BatchNorm2d(64)}
    inplanes = 64
    for li, (planes, n, stride) in enumerate(
            zip(PLANES, BLOCK_COUNTS[name], STRIDES), start=1):
        layer = []
        for i in range(n):
            layer.append(Bottleneck(inplanes, planes, stride if i == 0 else 1))
            inplanes = planes * EXPANSION
        modules[f"layer{li}"] = nn.Sequential(*layer)
    return ref_model.Trunk(modules, run, tuple(p * EXPANSION for p in PLANES))


def run(fpn: nn.Module, x: torch.Tensor, q: ref_model.Quant) -> List[torch.Tensor]:
    c1 = F.relu(ref_model.bn(fpn.bn1, ref_model.conv(fpn.conv1, x, q)))
    x = F.max_pool2d(c1, 3, stride=2, padding=1)
    feats = []
    for li in range(1, 5):
        for block in getattr(fpn, f"layer{li}"):
            x = block.run(x, q)
        feats.append(x)
    return feats                                   # c2, c3, c4, c5
