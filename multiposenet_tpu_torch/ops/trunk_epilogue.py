"""The frozen trunk's epilogue: ``relu(bn(x) [+ residual] [+
bn_down(down)])`` with each BatchNorm on its running statistics, the end of
every trunk layer of ``models/fpn.py`` (the stem, each bottleneck's three
convs).

``trunk_epilogue`` is the registered operator ``mpn::trunk_epilogue``
(``torch.library.custom_op``): on a CUDA tensor the dispatcher runs the
hand-written kernel (ops/cuda_trunk_epilogue.py, csrc/trunk_epilogue.cu),
one pass over device memory; on a CPU tensor ``trunk_epilogue_plain``, the
kernel's plain twin: the op sequence the trunk ran before the kernel
(``F.batch_norm``, ``+``, ``F.relu``), which chip_smoke.py holds the kernel
against on the card.  With its shape function the operator is one opaque
node of a ``torch.export`` graph.

``engages`` is the whole rule by which ``models/fpn.trunk_epilogue``
calls the operator (through ``fused``), read from the layer's modules and
tensors: BatchNorms on running statistics, every tensor float32 and no
autograd to record.  On a CUDA device that is the kernel, which raises on a
layout it cannot take.  Anything else (batch statistics, the folded graph,
bf16 autocast, gradients into the trunk, float64) runs the modules' own op
sequence, as before.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multiposenet_tpu_torch.ops import cuda_trunk_epilogue


def trunk_epilogue_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor, eps: float,
                         residual: Optional[torch.Tensor] = None,
                         down: Optional[torch.Tensor] = None,
                         down_mean: Optional[torch.Tensor] = None,
                         down_var: Optional[torch.Tensor] = None,
                         down_weight: Optional[torch.Tensor] = None,
                         down_bias: Optional[torch.Tensor] = None,
                         down_eps: float = 0.0) -> torch.Tensor:
    """``relu(bn(x) + residual)``, the residual optional or the downsample
    conv's output ``down`` through its own BatchNorm, each BatchNorm on its
    running statistics."""
    out = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
    if down is not None:
        residual = F.batch_norm(down, down_mean, down_var, down_weight,
                                down_bias, False, 0.0, down_eps)
    if residual is not None:
        out = out + residual
    return F.relu(out)


@torch.library.custom_op("mpn::trunk_epilogue", mutates_args=(),
                         device_types="cpu")
def trunk_epilogue(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   residual: Optional[torch.Tensor] = None,
                   down: Optional[torch.Tensor] = None,
                   down_mean: Optional[torch.Tensor] = None,
                   down_var: Optional[torch.Tensor] = None,
                   down_weight: Optional[torch.Tensor] = None,
                   down_bias: Optional[torch.Tensor] = None,
                   down_eps: float = 0.0) -> torch.Tensor:
    """The trunk epilogue: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors."""
    return trunk_epilogue_plain(x, mean, var, weight, bias, eps, residual, down,
                                down_mean, down_var, down_weight, down_bias,
                                down_eps)


@trunk_epilogue.register_kernel("cuda")
def _trunk_epilogue_cuda(x, mean, var, weight, bias, eps, residual=None,
                         down=None, down_mean=None, down_var=None,
                         down_weight=None, down_bias=None, down_eps=0.0):
    down_bn = (None if down is None
               else (down_mean, down_var, down_weight, down_bias, down_eps))
    return cuda_trunk_epilogue.trunk_epilogue_cuda(
        x, (mean, var, weight, bias, eps), residual, down, down_bn)


@trunk_epilogue.register_fake
def _trunk_epilogue_fake(x, mean, var, weight, bias, eps, residual=None,
                         down=None, down_mean=None, down_var=None,
                         down_weight=None, down_bias=None, down_eps=0.0):
    return torch.empty_like(x)


def _bn_tensors(bn: nn.BatchNorm2d):
    return bn.running_mean, bn.running_var, bn.weight, bn.bias


def engages(x: torch.Tensor, bn: nn.Module, train: bool,
            residual: Optional[torch.Tensor] = None,
            down: Optional[Tuple[torch.Tensor, nn.Module]] = None) -> bool:
    """Whether the layer's end ``relu(bn(x) [+ residual] [+
    down_bn(down_x)])``, ``down = (down_x, down_bn)``, runs as ``fused``:
    every BatchNorm a ``BatchNorm2d`` on its running statistics (``train``
    false; the folded graph's pass-through is none), every tensor float32,
    and none needing a gradient while autograd records."""
    bns = (bn,) if down is None else (bn, down[1])
    if train or not all(isinstance(b, nn.BatchNorm2d) for b in bns):
        return False
    tensors = [x, *(t for b in bns for t in _bn_tensors(b))]
    if residual is not None:
        tensors.append(residual)
    if down is not None:
        tensors.append(down[0])
    if any(t.dtype != torch.float32 for t in tensors):
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def fused(x: torch.Tensor, bn: nn.BatchNorm2d,
          residual: Optional[torch.Tensor] = None,
          down: Optional[Tuple[torch.Tensor, nn.BatchNorm2d]] = None
          ) -> torch.Tensor:
    """The layer's end as one call of ``trunk_epilogue``, for a layer that
    ``engages`` takes."""
    if down is None:
        return trunk_epilogue(x, *_bn_tensors(bn), bn.eps, residual)
    return trunk_epilogue(x, *_bn_tensors(bn), bn.eps, None, down[0],
                          *_bn_tensors(down[1]), down[1].eps)
