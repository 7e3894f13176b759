"""Fixed-size batched NMS — PyTorch twin of multiposenet_tpu/ops/nms.py.

    scores -> threshold mask -> top-k (K candidates, ties by ascending index)
           -> greedy +1px-IoU suppression (strict >) -> fixed-K outputs

The suppression step is ``nms_suppress``, the registered operator
``mpn::nms_suppress`` (``torch.library.custom_op``): on a CUDA tensor the
dispatcher runs the hand-written kernel (ops/cuda_nms.py,
csrc/nms_suppress.cu); on a CPU tensor ``nms_suppress_plain``, the kernel's
plain PyTorch twin, which the CPU tests hold against the JAX package and
chip_smoke.py holds the kernel against on the card.  Any other device has
no implementation and raises.  As an operator with a shape function it is
one opaque node of a ``torch.export`` graph (engine/export_model.py), so a
program that holds it is loaded after importing this module.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multiposenet_tpu_torch.ops import cuda_nms
from multiposenet_tpu_torch.ops.boxes import box_iou_plus1


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) suppressed entries are zeros
    scores: torch.Tensor   # (B, K) suppressed entries are -1
    indices: torch.Tensor  # (B, K) int32 indices into the input; -1 invalid
    keep: torch.Tensor     # (B, K) bool keep mask


def nms_suppress_plain(sorted_boxes: torch.Tensor, valid: torch.Tensor,
                       iou_thresh: float) -> torch.Tensor:
    """(B, K, 4) score-sorted boxes + (B, K) validity -> (B, K) keep mask:
    box i, if valid and not yet suppressed, suppresses every later j with
    IoU(i, j) > iou_thresh (ops/nms.py:65-71 and pallas_nms.py:62-78)."""
    k = valid.shape[1]
    later = torch.ones(k, k, dtype=torch.bool, device=valid.device).triu(1)
    over = (box_iou_plus1(sorted_boxes, sorted_boxes) > iou_thresh) & later
    suppressed = torch.zeros_like(valid)
    for i in range(k):
        alive = valid[:, i] & ~suppressed[:, i]
        suppressed |= over[:, i] & alive[:, None]
    return valid & ~suppressed


@torch.library.custom_op("mpn::nms_suppress", mutates_args=(),
                         device_types="cpu")
def nms_suppress(sorted_boxes: torch.Tensor, valid: torch.Tensor,
                 iou_thresh: float) -> torch.Tensor:
    """Greedy suppression: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors."""
    return nms_suppress_plain(sorted_boxes, valid, iou_thresh)


@nms_suppress.register_kernel("cuda")
def _nms_suppress_cuda(sorted_boxes: torch.Tensor, valid: torch.Tensor,
                       iou_thresh: float) -> torch.Tensor:
    return cuda_nms.nms_suppress_cuda(sorted_boxes, valid, iou_thresh)


@nms_suppress.register_fake
def _nms_suppress_fake(sorted_boxes: torch.Tensor, valid: torch.Tensor,
                       iou_thresh: float) -> torch.Tensor:
    return torch.empty_like(valid)


def rounded_to(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host, as JAX rounds a Python
    scalar it compares with an array: bf16 scores meet a bf16 threshold."""
    return float(torch.tensor(value, dtype=dtype))


def topk_candidates(boxes: torch.Tensor, scores: torch.Tensor, k: int,
                    score_thresh: float):
    """The K best-scoring candidates per image: (top_scores, top_idx,
    top_boxes, valid).  Candidates at or below ``score_thresh`` are dropped
    (valid False, score -inf).  The top-k is a stable descending sort, so
    equal scores keep ascending index order like ``lax.top_k``."""
    masked = torch.where(scores > rounded_to(score_thresh, scores.dtype),
                         scores, float("-inf"))
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    return top_scores, top_idx, top_boxes, top_scores > float("-inf")


def batched_topk_nms(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thresh: float = 0.5, max_out: int = 100,
                     score_thresh: float = 0.0) -> NMSResult:
    """Greedy hard-NMS with static output size, over a leading batch axis:
    boxes (B, N, 4) x1y1x2y2, scores (B, N) -> NMSResult of (B, max_out)."""
    k = min(max_out, scores.shape[1])
    top_scores, top_idx, top_boxes, valid = topk_candidates(
        boxes, scores, k, score_thresh)

    keep = nms_suppress(top_boxes.float().contiguous(), valid, iou_thresh)

    out_boxes = torch.where(keep[..., None], top_boxes, 0.0)
    out_scores = torch.where(keep, top_scores, -1.0)
    out_idx = torch.where(keep, top_idx, -1).to(torch.int32)
    if k < max_out:
        pad = max_out - k
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad), value=-1.0)
        out_idx = torch.nn.functional.pad(out_idx, (0, pad), value=-1)
        keep = torch.nn.functional.pad(keep, (0, pad))
    return NMSResult(out_boxes, out_scores, out_idx, keep)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              iou_thresh: float = 0.5, max_out: int = 100,
              score_thresh: float = 0.0) -> NMSResult:
    """One image: boxes (N, 4), scores (N,) -> NMSResult of (K, ...)."""
    r = batched_topk_nms(boxes[None], scores[None], iou_thresh, max_out,
                         score_thresh)
    return NMSResult(*(t[0] for t in r))
