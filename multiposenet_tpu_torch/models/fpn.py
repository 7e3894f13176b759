"""ResNet-50/101 backbone + dual-head FPN — PyTorch twin of
multiposenet_tpu/models/fpn.py.

One bottom-up ResNet trunk feeds two independent FPN top-downs: a detection
pyramid P3..P7 (RetinaNet) and a keypoint pyramid P2..P5, merged with
nearest-neighbour upsample-adds (reference network/fpn.py:37-134).

Modules take and return NCHW tensors (run them in ``channels_last`` memory
format on the GPU); ``models/posenet.PoseNet`` converts from and to the JAX
package's NHWC layout at its public methods.  Submodule names follow the
reference ``state_dict`` keys (``fpn.layer3.22.downsample.0.weight``).

BatchNorm (eps 1e-5) normalises with its running statistics unless a
forward is given ``train=True``, as the keypoint train step does: then it
normalises with the batch's statistics and updates the running ones with
Flax's rule (``BatchNorm``), over the global batch of every process once
a train step inside a process group has switched that on
(``use_global_batch_stats``).  The module's own ``training`` flag is not
read.

Each trunk layer ends in ``trunk_epilogue``: ``relu(bn(conv_out) [+
residual] [+ bn_down(down_out)])``.  On running statistics in float32 with
no autograd to record through the trunk (the detection stage's frozen
trunk, val steps, float32 inference) it is one call of the operator
``mpn::trunk_epilogue`` (ops/trunk_epilogue.py), one kernel launch on the
GPU; otherwise the modules' own op sequence.

``fold_bn=True`` builds the inference-only graph of a folded state dict
(models/fold_bn.py): the trunk convs carry a bias and each trunk BN is a
``FoldedBN``, which passes its input through and refuses ``train=True``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.nn.functional import all_reduce as differentiable_all_reduce

from multiposenet_tpu_torch.ops import trunk_epilogue as _te

BN_EPS = 1e-5


class FPNFeatures(NamedTuple):
    keypoint: Tuple[torch.Tensor, ...]   # (fp2, fp3, fp4, fp5) strides 4..32
    detection: Tuple[torch.Tensor, ...]  # (p3, p4, p5, p6, p7) strides 8..128


def upsample_nearest(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour upsample of a (B, C, H, W) tensor to ``target_hw``.

    Integer ratios are a plain repeat, ``out[i] = in[i // k]``.  Other ratios
    pick ``in[floor((i + 0.5) * H / th)]`` with the product and quotient
    rounded in float32 in that order, as ``jax.image.resize(method="nearest")``
    does (fpn.py:46), so both packages pick the same source pixels.
    """
    h, w = x.shape[2], x.shape[3]
    th, tw = int(target_hw[0]), int(target_hw[1])
    if (th, tw) == (h, w):
        return x
    if th % h == 0 and tw % w == 0:
        return F.interpolate(x, scale_factor=(th // h, tw // w), mode="nearest")

    def offsets(n_in: int, n_out: int) -> torch.Tensor:
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5)
        return torch.floor(pos * n_in / n_out).to(torch.int64)

    x = x.index_select(2, offsets(h, th)) if th != h else x
    return x.index_select(3, offsets(w, tw)) if tw != w else x


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with Flax's training semantics (flax/linen/normalization.py,
    ``momentum=0.9`` as the JAX trunk sets it).  ``train=True`` normalises
    with the batch mean and the BIASED batch variance, and updates
    ``running = 0.9 * running + 0.1 * batch`` with that biased variance,
    where ``nn.BatchNorm2d`` would use the unbiased one (n/(n-1) larger).
    The statistics are taken in at least float32.  ``num_batches_tracked``
    is left as it is: the momentum is fixed.

    With ``global_stats`` set (``use_global_batch_stats``, which a train
    step inside a process group calls), ``train=True`` takes the statistics
    of the global batch of the default process group, as JAX's BatchNorm
    does under a batch-sharded ``jit`` (``_global_train``)."""

    FLAX_MOMENTUM = 0.9

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS)
        self.global_stats = False

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.global_stats:
            return self._global_train(x)
        # One pass for the normalisation and the statistics: at momentum 1.0
        # F.batch_norm writes the batch mean and the unbiased batch variance
        # into the zeroed buffers it is given, which are then folded into the
        # running ones with the variance rescaled to the biased one.
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                           self.eps)
        n = x.numel() // x.shape[1]
        m = self.FLAX_MOMENTUM
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=(1.0 - m) * (n - 1) / n)
        return out

    def _global_train(self, x: torch.Tensor) -> torch.Tensor:
        """Batch statistics over every process's batch: the per-channel sum,
        sum of squares and count, summed over the group by a differentiable
        all-reduce (its backward all-reduces the gradients, so the backward
        is the global batch's too).  Flax's fast variance, ``E[x^2] -
        E[x]^2`` clipped at 0 (the biased variance), normalises and enters
        the running update; ``n`` is the global count.  The processes'
        batches may differ in size."""
        c = x.shape[1]
        dt = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(dt)
        local = torch.cat([xs.sum(dim=(0, 2, 3)), (xs * xs).sum(dim=(0, 2, 3)),
                           xs.new_full((1,), x.numel() // c)])
        total = differentiable_all_reduce(local)
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        scale = self.weight.to(dt) * torch.rsqrt(var + self.eps)
        shift = self.bias.to(dt) - mean * scale
        out = (xs * scale.view(1, c, 1, 1) + shift.view(1, c, 1, 1)).to(x.dtype)
        m = self.FLAX_MOMENTUM
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean.to(self.running_mean.dtype),
                                           alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.to(self.running_var.dtype),
                                          alpha=1.0 - m)
        return out


def use_global_batch_stats(module: nn.Module) -> None:
    """Make every ``BatchNorm`` in ``module`` take the statistics of the
    global batch when it trains: one differentiable all-reduce over the
    default process group per layer and pass (``BatchNorm._global_train``),
    so every process must run the same forwards."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.global_stats = True


class FoldedBN(nn.Module):
    """A trunk BatchNorm of the ``fold_bn=True`` graph: its affine lives in
    the conv before it, so it passes its input through."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise RuntimeError("fold_bn is an inference-only graph")
        return x


def _trunk_bn(c: int, fold_bn: bool) -> nn.Module:
    return FoldedBN() if fold_bn else BatchNorm(c)


def trunk_epilogue(x: torch.Tensor, bn: nn.Module, train: bool,
                   residual: Optional[torch.Tensor] = None,
                   down: Optional[Tuple[torch.Tensor, nn.Module]] = None
                   ) -> torch.Tensor:
    """The end of a trunk layer, ``relu(bn(x) [+ residual] [+
    down_bn(down_x)])`` with ``down = (down_x, down_bn)``, the downsample
    conv's raw output and its BatchNorm.  In one call of the operator
    ``mpn::trunk_epilogue`` (one kernel launch on the GPU) where
    ``ops/trunk_epilogue.engages`` takes the layer; otherwise as the
    modules' own op sequence."""
    if _te.engages(x, bn, train, residual, down):
        return _te.fused(x, bn, residual, down)
    out = bn(x, train)
    if down is not None:
        residual = down[1](down[0], train)
    return F.relu(out if residual is None else out + residual)


class Bottleneck(nn.Module):
    """ResNet bottleneck block, expansion 4 (reference fpn.py:9-34)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 fold_bn: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=fold_bn)
        self.bn1 = _trunk_bn(planes, fold_bn)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=fold_bn)
        self.bn2 = _trunk_bn(planes, fold_bn)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=fold_bn)
        self.bn3 = _trunk_bn(planes * 4, fold_bn)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=fold_bn),
                _trunk_bn(planes * 4, fold_bn))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = trunk_epilogue(self.conv1(x), self.bn1, train)
        out = trunk_epilogue(self.conv2(out), self.bn2, train)
        if self.downsample is None:
            return trunk_epilogue(self.conv3(out), self.bn3, train, residual=x)
        conv, bn = self.downsample
        return trunk_epilogue(self.conv3(out), self.bn3, train,
                              down=(conv(x), bn))


def pyramid_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv6`` or ``conv7`` (3x3, stride 2, padding 1) applied to ``x``.

    Over a 1x1 map (P6 at a 64 px input, C5 at 32 px) the output reads the
    centre tap alone, so there the conv runs as the 1x1 conv of its centre
    tap: the same output, and a zero gradient for the eight taps that see
    only padding, as the JAX package computes.  PyTorch's oneDNN
    convolution backward in bfloat16 on the CPU wrote garbage, NaN at
    times, into those taps' gradient."""
    if x.shape[-2:] == (1, 1):
        return F.conv2d(x, conv.weight[:, :, 1:2, 1:2], conv.bias)
    return conv(x)


class ResNetFPN(nn.Module):
    """ResNet trunk + dual FPN heads; block_counts (3,4,6,3) is resnet50,
    (3,4,23,3) resnet101; ``fold_bn`` builds the folded inference graph."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 23, 3),
                 channels: int = 256, fold_bn: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=fold_bn)
        self.bn1 = _trunk_bn(64, fold_bn)
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), block_counts, (1, 2, 2, 2)), start=1):
            layer: List[nn.Module] = []
            for i in range(blocks):
                layer.append(Bottleneck(inplanes, planes,
                                        stride if i == 0 else 1, fold_bn))
                inplanes = planes * 4
            self.add_module(f"layer{li}", nn.Sequential(*layer))

        ch = channels
        conv = lambda cin, k, s=1: nn.Conv2d(cin, ch, k, stride=s,  # noqa: E731
                                             padding=k // 2)
        # detection pyramid (reference fpn.py:103-112)
        self.conv6 = conv(2048, 3, 2)
        self.conv7 = conv(ch, 3, 2)
        self.latlayer1 = conv(2048, 1)
        self.latlayer2 = conv(1024, 1)
        self.latlayer3 = conv(512, 1)
        self.toplayer0 = conv(ch, 3)
        self.toplayer1 = conv(ch, 3)
        self.toplayer2 = conv(ch, 3)
        # keypoint pyramid (reference fpn.py:114-122)
        self.toplayer = conv(2048, 1)
        self.flatlayer1 = conv(1024, 1)
        self.flatlayer2 = conv(512, 1)
        self.flatlayer3 = conv(256, 1)
        self.smooth1 = conv(ch, 3)
        self.smooth2 = conv(ch, 3)
        self.smooth3 = conv(ch, 3)

    def _stage(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        for block in getattr(self, name):
            x = block(x, train)
        return x

    def forward(self, x: torch.Tensor, detection: bool = True,
                train: bool = False) -> FPNFeatures:
        """NCHW image -> both pyramids; ``detection=False`` skips the
        detection pyramid (``FPNFeatures.detection`` is empty).  ``train``
        runs the trunk's BatchNorms on batch statistics and updates their
        running statistics."""
        c1 = trunk_epilogue(self.conv1(x), self.bn1, train)
        c1 = F.max_pool2d(c1, 3, stride=2, padding=1)
        c2 = self._stage("layer1", c1, train)   # stride 4
        c3 = self._stage("layer2", c2, train)   # stride 8
        c4 = self._stage("layer3", c3, train)   # stride 16
        c5 = self._stage("layer4", c4, train)   # stride 32

        hw = lambda t: t.shape[2:4]  # noqa: E731
        det: Tuple[torch.Tensor, ...] = ()
        if detection:
            p6 = pyramid_conv(self.conv6, c5)
            p7 = pyramid_conv(self.conv7, F.relu(p6))
            p5 = self.latlayer1(c5)
            p4 = upsample_nearest(p5, hw(c4)) + self.latlayer2(c4)
            p3 = upsample_nearest(p4, hw(c3)) + self.latlayer3(c3)
            det = (self.toplayer2(p3), self.toplayer1(p4), self.toplayer0(p5),
                   p6, p7)

        fp5 = self.toplayer(c5)
        fp4 = upsample_nearest(fp5, hw(c4)) + self.flatlayer1(c4)
        fp3 = upsample_nearest(fp4, hw(c3)) + self.flatlayer2(c3)
        fp2 = upsample_nearest(fp3, hw(c2)) + self.flatlayer3(c2)
        fp4 = self.smooth1(fp4)
        fp3 = self.smooth2(fp3)
        fp2 = self.smooth3(fp2)
        return FPNFeatures(keypoint=(fp2, fp3, fp4, fp5), detection=det)
