"""The trunk epilogue as a hand-written CUDA kernel
(csrc/trunk_epilogue.cu): ``relu(bn(x) [+ residual] [+ bn_down(down)])``
over NHWC float32 activations, with each BatchNorm on its running
statistics, in one pass over device memory.  It replaces no TPU kernel (XLA
fuses these ops into the convolution there); the source says why it exists,
what bounds it and how it is built.

Built with nvcc for ``sm_90a`` at first use (``_build.py``) and called
through ctypes on PyTorch's current stream; the kernel allocates nothing and
does not synchronise, the wrapper allocates the output.  ``ops/
trunk_epilogue.trunk_epilogue``, the operator ``mpn::trunk_epilogue``, sends
CUDA tensors here and CPU tensors to the plain PyTorch twin ``ops/
trunk_epilogue.trunk_epilogue_plain``; there is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from multiposenet_tpu_torch import _build

SOURCE = "trunk_epilogue.cu"

# a BatchNorm as (running_mean, running_var, weight, bias, eps)
BN = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float]

# kernel launches since import (chip_smoke.py zeroes and reads it: 49 a
# ResNet-50 detection step, 100 a ResNet-101 one); the evaluator runs
# forwards from two threads, so the count is kept under a lock
launches = 0
_launches_lock = threading.Lock()


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).trunk_epilogue_launch
    ptr, f32 = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = [ptr, ptr, ctypes.c_int, ptr, ctypes.c_longlong, ctypes.c_int,
                   ptr, ptr, ptr, ptr, f32, ptr, ptr, ptr, ptr, f32, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check_bn(bn: BN, x: torch.Tensor, what: str) -> None:
    for t in bn[:4]:
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{what}: BatchNorm tensors must be float32 on "
                            f"{x.device}, got {t.dtype} on {t.device}")
        if t.dim() != 1 or t.shape[0] != x.shape[1] or t.stride(0) != 1:
            raise ValueError(f"{what}: BatchNorm tensors must be dense [C = "
                             f"{x.shape[1]}], got {tuple(t.shape)}")


def trunk_epilogue_cuda(x: torch.Tensor, bn: BN,
                        residual: Optional[torch.Tensor] = None,
                        down: Optional[torch.Tensor] = None,
                        down_bn: Optional[BN] = None) -> torch.Tensor:
    """``relu(bn(x) [+ residual] [+ down_bn(down)])`` of (B, C, H, W)
    float32 CUDA tensors in channels-last memory format, C a multiple of 4;
    at most one of ``residual`` and ``down``.  Raises on a wrong device,
    dtype, shape or layout, on a build failure and on a refused launch."""
    global launches
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError("trunk_epilogue_cuda takes a float32 CUDA tensor, got "
                        f"{x.dtype} on {x.device}")
    if residual is not None and down is not None:
        raise ValueError("trunk_epilogue_cuda takes a residual or a downsample "
                         "input, not both")
    if (down is None) != (down_bn is None):
        raise ValueError("trunk_epilogue_cuda: a downsample input needs its "
                         "BatchNorm and the other way round")
    second = residual if residual is not None else down
    for t in (x,) if second is None else (x, second):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError("trunk_epilogue_cuda: inputs must be float32 on "
                            f"{x.device}, got {t.dtype} on {t.device}")
        if (t.dim() != 4 or t.shape[1] % 4
                or not t.is_contiguous(memory_format=torch.channels_last)
                or t.data_ptr() % 16):
            raise ValueError("trunk_epilogue_cuda takes 4-D channels-last "
                             "dense tensors, C a multiple of 4, 16-byte "
                             f"aligned; got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if second is not None and second.shape != x.shape:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(second.shape)} "
                         "differ")
    _check_bn(bn, x, "bn")
    if down_bn is not None:
        _check_bn(down_bn, x, "down_bn")
    y = torch.empty_like(x)   # x's strides: the kernel writes x's order
    if x.numel() == 0:
        return y
    mode = 0 if second is None else (1 if residual is not None else 2)
    b2 = down_bn if down_bn is not None else bn
    args = (x.data_ptr(), 0 if second is None else second.data_ptr(), mode,
            y.data_ptr(), x.numel(), x.shape[1],
            *(t.data_ptr() for t in bn[:4]), float(bn[4]),
            *(t.data_ptr() for t in b2[:4]), float(b2[4]),
            torch.cuda.current_stream(x.device).cuda_stream)
    launch = _launcher()
    # a kernel launches only into a stream of the current device; the device
    # context, which costs host time on every call, is entered only if needed
    if x.device.index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(x.device):
            err = launch(*args)
    if err != 0:
        raise RuntimeError(f"trunk_epilogue kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    return y
