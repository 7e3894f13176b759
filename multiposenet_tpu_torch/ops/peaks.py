"""Heatmap peak finding with sub-pixel refinement — PyTorch twin of
multiposenet_tpu/ops/peaks.py (reference network/joint_utils.py:19-138).

- local maxima over the 4-connected cross (-inf padding), ``> thre1``;
- a per-(image, joint) top-k, ties by ascending index as ``lax.top_k``;
- a 5x5 window clamped at the border, gathered directly (the JAX package
  extracts it with one-hot contractions, a TPU choice; the values are the
  same);
- x``f`` bicubic upsampling through the constant matrix ``_upsample_matrix``
  (OpenCV INTER_CUBIC, a=-0.75, replicate border), in float32 (the
  pipeline runs it with TF32 off, engine/inference.full_fp32_matmul);
- first-index argmax, then coords = window_start * f + argmax.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def _cubic_weight(d: np.ndarray, a: float = -0.75) -> np.ndarray:
    """OpenCV INTER_CUBIC kernel (Keys, a=-0.75)."""
    d = np.abs(d)
    return np.where(
        d <= 1.0,
        (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0,
        np.where(d < 2.0, a * (d ** 3 - 5.0 * d ** 2 + 8.0 * d - 4.0), 0.0),
    )


@functools.lru_cache(maxsize=16)
def _upsample_matrix(src: int, factor: int) -> np.ndarray:
    """(src*factor, src) matrix M with M @ x == cv2.resize(x, fx=factor,
    INTER_CUBIC) along one axis, replicate border (read-only)."""
    dst = src * factor
    m = np.zeros((dst, src), dtype=np.float32)
    for j in range(dst):
        s = (j + 0.5) / factor - 0.5
        base = int(np.floor(s))
        t = s - base
        taps = np.array([base - 1, base, base + 1, base + 2])
        w = _cubic_weight(np.array([t + 1.0, t, 1.0 - t, 2.0 - t]))
        for tap, wt in zip(np.clip(taps, 0, src - 1), w):
            m[j, tap] += wt
    m.flags.writeable = False
    return m


@functools.lru_cache(maxsize=16)
def _cached_upsample(src: int, factor: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(_upsample_matrix(src, factor))).to(device)


def _upsample_tensor(src: int, factor: int, device: torch.device) -> torch.Tensor:
    """``_upsample_matrix`` on ``device``, uploaded once per device rather
    than on every call.  A torch.export trace gets a tensor of its own: the
    cache would keep the trace's fake tensor for every later call."""
    if torch.compiler.is_exporting():
        return _cached_upsample.__wrapped__(src, factor, device)
    return _cached_upsample(src, factor, device)


class PeakSet(NamedTuple):
    coords: torch.Tensor  # (B, J, P, 2) int32 refined [x, y] in upsampled space
    scores: torch.Tensor  # (B, J, P) float32 score at the refined location
    valid: torch.Tensor   # (B, J, P) bool


def find_peaks_refined_batched(heatmaps: torch.Tensor, thre1: float = 0.1,
                               max_peaks: int = 32, upsamp_factor: int = 1,
                               win_size: int = 2, refine: bool = True
                               ) -> PeakSet:
    """(B, H, W, J) heatmaps -> fixed-capacity peaks per (image, joint).

    Invalid slots have score -1.  Coordinates are in the upsampled frame
    (original image = heatmap * upsamp_factor).
    """
    b, h, w, num_j = heatmaps.shape
    hm = heatmaps.permute(0, 3, 1, 2).float()                  # (B, J, H, W)

    padded = F.pad(hm, (1, 1, 1, 1), value=float("-inf"))
    cross_max = torch.maximum(
        hm,
        torch.maximum(
            torch.maximum(padded[:, :, :-2, 1:-1], padded[:, :, 2:, 1:-1]),
            torch.maximum(padded[:, :, 1:-1, :-2], padded[:, :, 1:-1, 2:])))
    is_peak = (hm == cross_max) & (hm > thre1)

    flat = torch.where(is_peak, hm, -1.0).reshape(b, num_j, h * w)
    top_scores, top_idx = torch.sort(flat, dim=2, descending=True, stable=True)
    top_scores = top_scores[..., :max_peaks]
    top_idx = top_idx[..., :max_peaks]                       # int64
    valid = top_scores > thre1
    py = top_idx // w
    px = top_idx % w

    f = int(upsamp_factor)
    if not refine:
        cx = torch.round((px + 0.5) * f - 0.5).to(torch.int32)
        cy = torch.round((py + 0.5) * f - 0.5).to(torch.int32)
        coords = torch.stack([cx, cy], dim=-1)
        return PeakSet(coords, torch.where(valid, top_scores, -1.0), valid)

    s = 2 * win_size + 1
    wy = (py - win_size).clamp(0, h - s)                       # window starts
    wx = (px - win_size).clamp(0, w - s)
    ar = torch.arange(s, device=hm.device)
    iy = wy[..., :, None, None] + ar[:, None]                  # (B, J, P, s, 1)
    ix = wx[..., :, None, None] + ar[None, :]                  # (B, J, P, 1, s)
    cell = (iy * w + ix).reshape(b, num_j, max_peaks * s * s)
    patches = torch.gather(hm.reshape(b, num_j, h * w), 2, cell)
    patches = patches.reshape(b, num_j, max_peaks, s, s)

    if f > 1:
        m = _upsample_tensor(s, f, hm.device)
        up = (m @ patches) @ m.t()                             # (B,J,P,sf,sf)
    else:
        up = patches           # the identity upsample (multi-scale eval)

    sf = s * f
    flat_up = up.reshape(b, num_j, max_peaks, sf * sf)
    amax = flat_up.argmax(dim=-1)                              # first index
    rs = flat_up.amax(dim=-1)
    rx = wx * f + amax % sf
    ry = wy * f + amax // sf
    coords = torch.stack([rx, ry], dim=-1).to(torch.int32)
    return PeakSet(coords, torch.where(valid, rs, -1.0), valid)
