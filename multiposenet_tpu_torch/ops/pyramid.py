"""The multi-scale eval's image pyramid, built on the device — the port of
``Evaluator._pyramid_body`` and ``_pyramid_args_np`` in
multiposenet_tpu/engine/evaluator.py.

Per scale, a vertical then a horizontal gather-lerp with cv2's INTER_LINEAR
taps and quantised weights (ops/resize.linear_resize_coeffs), each product
and sum rounded in float32, then ``floor(x + 0.5)`` clipped to uint8, within
one uint8 step of cv2.resize.  Outside the resized region the padded batch
holds 128 (reference tester.py:38-81).  The flip row reuses the vertical
pass and mirrors only the horizontal taps: ``img[:, ::-1]`` at column ``x``
is ``img`` at ``w - 1 - x``, so the row equals resizing the mirrored image.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multiposenet_tpu_torch.eval.multiscale import crop_shape_only
from multiposenet_tpu_torch.ops.resize import linear_resize_coeffs


class LerpTaps(NamedTuple):
    """One axis of an INTER_LINEAR resize: output i reads
    ``src[i0] * w0 + src[i1] * (1 - w0)``."""
    i0: torch.Tensor     # (n_out,) int64
    i1: torch.Tensor     # (n_out,) int64
    w0: torch.Tensor     # (n_out,) float32


class ScaleTaps(NamedTuple):
    padded_hw: Tuple[int, int]      # the scale's batch (H, W), bucketed
    real_hw: Tuple[int, int]        # the resized image inside it
    im_scale: float                 # resized / original
    rows: LerpTaps
    cols: LerpTaps
    cols_flip: Optional[LerpTaps]   # the mirrored image's columns


def lerp_taps(n_in: int, n_out: int, device, mirror: bool = False) -> LerpTaps:
    i0, i1, w0 = linear_resize_coeffs(n_in, n_out)
    if mirror:
        i0, i1 = n_in - 1 - i0, n_in - 1 - i1
    return LerpTaps(torch.from_numpy(i0.astype(np.int64)).to(device),
                    torch.from_numpy(i1.astype(np.int64)).to(device),
                    torch.from_numpy(np.array(w0)).to(device))


def pyramid_taps(h: int, w: int, dests: Sequence[float], bucket: int,
                 with_flip: bool, device) -> List[ScaleTaps]:
    """The taps of every scale of an (h, w) image: scale k resizes the
    shorter side to ``dests[k]`` and pads to a multiple of max(32, bucket)
    (``crop_shape_only``)."""
    out = []
    for dest in dests:
        padded, im_scale, (rh, rw) = crop_shape_only((h, w), dest, factor=32,
                                                     bucket=bucket)
        out.append(ScaleTaps(
            padded, (rh, rw), im_scale, lerp_taps(h, rh, device),
            lerp_taps(w, rw, device),
            lerp_taps(w, rw, device, mirror=True) if with_flip else None))
    return out


def _lerp(a: torch.Tensor, b: torch.Tensor, w0: torch.Tensor) -> torch.Tensor:
    return a * w0 + b * (1.0 - w0)


def resize_rows(srcf: torch.Tensor, t: LerpTaps) -> torch.Tensor:
    """(H, W, C) float32 -> (n_out, W, C)."""
    return _lerp(srcf[t.i0], srcf[t.i1], t.w0[:, None, None])


def resize_cols(g: torch.Tensor, t: LerpTaps) -> torch.Tensor:
    """(H, W, C) float32 -> (H, n_out, C)."""
    return _lerp(g[:, t.i0], g[:, t.i1], t.w0[None, :, None])


def round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


def resize_u8(src: torch.Tensor, rows: LerpTaps, cols: LerpTaps) -> torch.Tensor:
    """(H, W, C) uint8 -> (len(rows), len(cols), C) uint8, INTER_LINEAR."""
    return round_u8(resize_cols(resize_rows(src.float(), rows), cols))


def build_pyramid(src: torch.Tensor, taps: Sequence[ScaleTaps]
                  ) -> List[torch.Tensor]:
    """(h, w, 3) uint8 original -> per scale a (1 or 2, H, W, 3) uint8
    batch: the resized image, then (with flip taps) the resized mirror,
    128 outside the resized region."""
    srcf = src.float()
    outs = []
    for t in taps:
        (dh, dw), (rh, rw) = t.padded_hw, t.real_hw
        g = resize_rows(srcf, t.rows)
        imgs = [resize_cols(g, t.cols)]
        if t.cols_flip is not None:
            imgs.append(resize_cols(g, t.cols_flip))
        batch = torch.full((len(imgs), dh, dw, src.shape[2]), 128,
                           dtype=torch.uint8, device=src.device)
        batch[:, :rh, :rw] = round_u8(torch.stack(imgs))
        outs.append(batch)
    return outs
