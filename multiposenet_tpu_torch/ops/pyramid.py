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

``build_pyramid_group`` builds the pyramids of G images whose scales share
their padded shapes in one pass per scale (the grouped eval,
engine/grouped_eval.py): each image has its own taps, padded to the scale's
shape, and the same arithmetic, so each of its rows equals
``build_pyramid``'s.
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


class GroupTaps(NamedTuple):
    """One scale of a group of G images: each image's taps padded to the
    scale's batch shape (padding reads pixel 0 and is replaced by 128)."""
    padded_hw: Tuple[int, int]
    real_hw: torch.Tensor           # (G, 2) int64 resized (h, w) per image
    rows: LerpTaps                  # (G, H) each
    cols: LerpTaps                  # (G, W) each
    cols_flip: Optional[LerpTaps]


def group_pyramid_taps(sizes: Sequence[Tuple[int, int]],
                       dests_list: Sequence[Sequence[float]], bucket: int,
                       with_flip: bool, device) -> List[GroupTaps]:
    """The taps of every scale of G images of (h, w) ``sizes`` with
    ``dests_list[g]`` per scale; the images' padded scale shapes must
    agree.  Built on the host and uploaded once."""
    out = []
    for k in range(len(dests_list[0])):
        shapes = [crop_shape_only(hw, dests[k], factor=32, bucket=bucket)
                  for hw, dests in zip(sizes, dests_list)]
        (dh, dw) = shapes[0][0]
        if any(s[0] != (dh, dw) for s in shapes):
            raise ValueError(f"scale {k}: padded shapes differ in the group: "
                             f"{[s[0] for s in shapes]}")

        def stacked(n_ins, n_outs, n_pad, mirror=False):
            i0s, i1s, w0s = [], [], []
            for n_in, n_out in zip(n_ins, n_outs):
                i0, i1, w0 = linear_resize_coeffs(n_in, n_out)
                if mirror:
                    i0, i1 = n_in - 1 - i0, n_in - 1 - i1
                pad = (0, n_pad - n_out)
                i0s.append(np.pad(i0, pad))
                i1s.append(np.pad(i1, pad))
                w0s.append(np.pad(w0, pad))
            return LerpTaps(*(torch.from_numpy(np.stack(a).astype(dt)).to(device)
                              for a, dt in ((i0s, np.int64), (i1s, np.int64),
                                            (w0s, np.float32))))

        hs = [hw[0] for hw in sizes]
        ws = [hw[1] for hw in sizes]
        rhs = [s[2][0] for s in shapes]
        rws = [s[2][1] for s in shapes]
        out.append(GroupTaps(
            (dh, dw), torch.tensor([s[2] for s in shapes], device=device),
            stacked(hs, rhs, dh), stacked(ws, rws, dw),
            stacked(ws, rws, dw, mirror=True) if with_flip else None))
    return out


def build_pyramid_group(srcs: torch.Tensor, taps: Sequence[GroupTaps]
                        ) -> List[torch.Tensor]:
    """(G, hp, wp, 3) uint8 originals, padded -> per scale a (G * nb, H, W,
    3) uint8 batch, image-major (each image, then its mirror), 128 outside
    each image's resized region."""
    g_n, _, wp, c = srcs.shape
    srcf = srcs.float()
    gi = torch.arange(g_n, device=srcs.device)[:, None]
    outs = []
    for t in taps:
        dh, dw = t.padded_hw
        rows = _lerp(srcf[gi, t.rows.i0], srcf[gi, t.rows.i1],
                     t.rows.w0[:, :, None, None])             # (G, dh, wp, c)

        def cols(lt: LerpTaps):
            def take(i):
                return torch.gather(rows, 2, i[:, None, :, None].expand(
                    g_n, dh, dw, c))
            return _lerp(take(lt.i0), take(lt.i1), lt.w0[:, None, :, None])

        imgs = [cols(t.cols)] + ([cols(t.cols_flip)] if t.cols_flip is not None
                                 else [])
        batch = round_u8(torch.stack(imgs, dim=1))              # (G, nb, ...)
        ar_h = torch.arange(dh, device=srcs.device)
        ar_w = torch.arange(dw, device=srcs.device)
        valid = ((ar_h[None, :, None] < t.real_hw[:, 0, None, None])
                 & (ar_w[None, None, :] < t.real_hw[:, 1, None, None]))
        batch = torch.where(valid[:, None, :, :, None], batch, 128)
        outs.append(batch.reshape((-1,) + batch.shape[2:]))
    return outs
