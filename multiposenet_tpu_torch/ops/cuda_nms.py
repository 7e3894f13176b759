"""Kernel K1: greedy NMS suppression as a hand-written CUDA kernel
(csrc/nms_suppress.cu), the port of the TPU kernel
multiposenet_tpu/ops/pallas_nms.py::_nms_suppress_kernel.

One launch per batch, one 1024-thread block per image, nothing leaves the
chip between the loads and the keep mask.  The kernel is bound by latency,
not by bytes or operations: its stages are a staging load, the suppression
bitmask built in parallel (one ``__ballot_sync`` per (row, 32-box word)
task, shared out among 32 warps), and a greedy scan in one warp that goes
32 boxes at a time, with register steps for the rows of a word that
suppress something in it and one ``__reduce_or_sync`` per later word.
The keep mask is bit-equal to the plain twin: each float op rounds on its
own in ``box_iou_plus1``'s order, min and max propagate NaN, and the
divide stays; only a pair whose intersection is 0 or NaN skips it, when
``iou_thresh >= 0``.

Built with nvcc for ``sm_90a`` at first use (``_build.py``) and called
through ctypes on PyTorch's current stream.  ``ops/nms.nms_suppress``, the
operator ``mpn::nms_suppress``, sends CUDA tensors here and CPU tensors to
the plain PyTorch twin ``ops/nms.nms_suppress_plain``; there is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from multiposenet_tpu_torch import _build

SOURCE = "nms_suppress.cu"
MAX_K = 1024

# kernel launches since import (chip_smoke.py zeroes and reads it to show
# that each path went through the kernel); the evaluator launches from two
# threads, so the count is kept under a lock
launches = 0
_launches_lock = threading.Lock()


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).nms_suppress_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nms_suppress_cuda(sorted_boxes: torch.Tensor, valid: torch.Tensor,
                      iou_thresh: float) -> torch.Tensor:
    """(B, K, 4) float32 score-sorted x1y1x2y2 boxes + (B, K) bool validity
    on one CUDA device -> (B, K) bool keep mask.  Raises on a wrong device,
    dtype, shape or layout, on a build failure and on a refused launch."""
    global launches
    if sorted_boxes.device.type != "cuda" or valid.device != sorted_boxes.device:
        raise ValueError("nms_suppress_cuda takes CUDA tensors on one device, "
                         f"got {sorted_boxes.device} and {valid.device}")
    if sorted_boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("nms_suppress_cuda takes float32 boxes and a bool "
                        f"mask, got {sorted_boxes.dtype} and {valid.dtype}")
    if (sorted_boxes.dim() != 3 or sorted_boxes.shape[2] != 4
            or tuple(valid.shape) != tuple(sorted_boxes.shape[:2])):
        raise ValueError(f"shapes {tuple(sorted_boxes.shape)} and "
                         f"{tuple(valid.shape)} are not (B, K, 4) and (B, K)")
    b, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"K = {k} candidates exceeds the kernel's {MAX_K}")
    if not (sorted_boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_suppress_cuda takes contiguous tensors")
    if sorted_boxes.data_ptr() % 16:
        raise ValueError("nms_suppress_cuda reads each box as one 16-byte "
                         "load: the boxes must start 16-byte aligned")
    keep = torch.empty_like(valid)
    if b == 0 or k == 0:
        return keep
    launch = _launcher()
    args = (sorted_boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
            float(iou_thresh), torch.cuda.current_stream(valid.device).cuda_stream)
    # a kernel launches only into a stream of the current device; the device
    # context, which costs host time on every call, is entered only if needed
    if valid.device.index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(valid.device):
            err = launch(*args)
    if err != 0:
        raise RuntimeError(f"nms_suppress kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    return keep
