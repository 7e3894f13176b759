"""The cv2 operators of the training data path and of the evaluator's
host chain, written from their arithmetic in numpy, so that both run where
cv2 is not installed.

The JAX package augments with ``cv2.resize`` (INTER_CUBIC and INTER_AREA),
``cv2.getRotationMatrix2D`` + ``cv2.warpAffine`` (INTER_CUBIC,
BORDER_CONSTANT) and rasterises COCO polygons with ``cv2.fillPoly``
(multiposenet_tpu/data/augment.py, rle.py).  Each function here computes
what that call computes, held against cv2 itself by
tests/test_torch_port_image_ops.py and, for the evaluator's host chain
(``resize_linear`` and the dsize form of ``resize_cubic``, eval/multiscale.py),
tests/test_torch_port_eval_host.py:

- ``resize_cubic``: cv2 hands a uint8 INTER_CUBIC resize, and a float32
  one of 1, 3 or 4 channels, to Intel IPP, whose result is the separable
  Keys cubic (A = -0.75, weights from the float64 offset, source
  coordinate (d + 0.5) / fx - 0.5, replicated borders) summed in float32
  and rounded half up.  It equals cv2 except where a sum lands within
  ~1e-5 of x.5 (a few pixels in 10^6, one level).  A float32 image of any
  other channel count (the evaluator's 18-joint heatmaps) takes OpenCV's
  own path, which is reproduced exactly: float32 source coordinates and
  Keys weights, each row's 4 taps summed left to right, then the 4 rows
  summed as its 4-lane vector loop sums them.
- ``resize_linear``: ``cv2.resize(img, dsize)``, INTER_LINEAR.  uint8 takes
  OpenCV's fixed-point path, reproduced exactly: 11-bit weights rounded
  one by one from float32 offsets, an integer row pass, and the column
  pass of its vector loop, ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4))
  >> 16) + 2 >> 2``.  A one-channel float32 image goes to IPP, whose
  result is reproduced exactly too: ``a + (b - a) * t`` as one fused
  multiply-add, along each row first, then down each column.
- ``resize_area_u8``: OpenCV's own INTER_AREA (cv2 does not give it to
  IPP): area-overlap weights summed in float32 and rounded to even when
  shrinking, a block mean when the inverse scale is an integer, and the
  2-tap fixed-point path with area weights when growing.
- ``rotation_matrix_2d`` and ``warp_affine_cubic``: the inverse map with
  float32 source coordinates, the Keys cubic of the continuous sub-pixel
  offset, each 4-tap row summed in float32 then weighted by its row tap,
  rounded to even, and the constant border per tap (OpenCV 5's
  warpAffine).  It equals cv2 but where a sum lands within ~1e-4 of x.5
  (about 1 pixel in 10^5, one level).
- ``fill_poly``: OpenCV's polygon fill: every edge drawn as an 8-connected
  Bresenham line (clipped to the image), then an even-odd scanline fill
  over the edges in 16.16 fixed point.

Every per-pixel step is a vectorised numpy operation over the whole image
(a tap or a row of taps at a time), which releases the interpreter lock,
so that ``data.loader.Loader``'s worker threads run them side by side.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from multiposenet_tpu_torch.ops.resize import _cubic_weights

_XY_SHIFT = 16                # fillPoly's fixed-point x


def out_size(n: int, f: float) -> int:
    """The length cv2.resize gives an axis of ``n`` pixels scaled by ``f``
    (``saturate_cast<int>(n * f)``: round half to even)."""
    return int(np.rint(n * f))


def _as_hwc(img: np.ndarray) -> np.ndarray:
    return img if img.ndim == 3 else img[:, :, None]


def _planes(img: np.ndarray) -> np.ndarray:
    """(H, W[, C]) -> contiguous float32 (C, H, W): gathers along a
    plane's rows and columns then read contiguous memory."""
    return np.ascontiguousarray(np.moveaxis(_as_hwc(img), 2, 0), np.float32)


def _from_planes(out: np.ndarray, ndim: int) -> np.ndarray:
    out = np.ascontiguousarray(np.moveaxis(out, 0, 2))
    return out if ndim == 3 else out[:, :, 0]


def _separable(planes: np.ndarray, ix, wx, iy, wy) -> np.ndarray:
    """Sum over column taps ``ix``/``wx`` (outputs, T), then over row taps,
    in float32 in tap order: (C, H, W) -> (C, OH, OW)."""
    rows = np.take(planes, ix[:, 0], axis=2) * wx[:, 0]
    for k in range(1, ix.shape[1]):
        rows += np.take(planes, ix[:, k], axis=2) * wx[:, k]
    out = np.take(rows, iy[:, 0], axis=1) * wy[:, 0, None]
    for k in range(1, iy.shape[1]):
        out += np.take(rows, iy[:, k], axis=1) * wy[:, k, None]
    return out


# A window is (y0, y1, x0, x1): the output rows [y0, y1) and columns
# [x0, x1) to compute.  Each output pixel depends only on its own taps, so a
# window of an operator's output equals the same window cut from its full
# output, and the datasets compute only what their crop keeps.
Window = Tuple[int, int, int, int]


def _span(idx: np.ndarray) -> Tuple[int, int]:
    return int(idx.min()), int(idx.max()) + 1


def content_box(img: np.ndarray, value) -> Optional[Window]:
    """The bounding box (y0, y1, x0, x1) of the pixels that differ from
    ``value`` in any channel, or None when every pixel equals it."""
    diff = _as_hwc(img) != np.asarray(value, img.dtype).reshape(-1)[:_as_hwc(img).shape[2]]
    diff = diff.any(axis=2)
    rows, cols = np.flatnonzero(diff.any(axis=1)), np.flatnonzero(diff.any(axis=0))
    if rows.size == 0:
        return None
    return int(rows[0]), int(rows[-1]) + 1, int(cols[0]), int(cols[-1]) + 1


def reach(idx: np.ndarray, lo: int, hi: int) -> Tuple[int, int]:
    """The outputs [d0, d1) of a tap table ``idx`` (outputs, T) with a tap
    in the source range [lo, hi); any other output reads only pixels
    outside it."""
    hit = np.flatnonzero(((idx >= lo) & (idx < hi)).any(axis=1))
    return (int(hit[0]), int(hit[-1]) + 1) if hit.size else (0, 0)


def _windowed(img: np.ndarray, window: Optional[Window], oh: int, ow: int,
              col_taps, row_taps, run):
    """Slice a pair of per-axis tap tables to ``window`` and hand ``run``
    the source region they read, with the tables shifted into it."""
    y0, y1, x0, x1 = window or (0, oh, 0, ow)
    if y1 <= y0 or x1 <= x0:
        return np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + img.shape[2:], img.dtype)
    cols = [t[x0:x1] for t in col_taps]
    rows = [t[y0:y1] for t in row_taps]
    (c0, c1), (r0, r1) = _span(cols[0]), _span(rows[0])
    out = run(img[r0:r1, c0:c1], cols, rows, c0, r0)
    return out.reshape((y1 - y0, x1 - x0) + img.shape[2:])


# ---------------------------------------------------------------------------
# INTER_CUBIC resize


def _frozen(*arrays):
    """The arrays made read-only, as a cached table's callers share them."""
    for a in arrays:
        a.flags.writeable = False
    return arrays


@functools.lru_cache(maxsize=64)
def cubic_taps(n_in: int, n_out: int, f: float):
    """Per output position: the 4 replicated-border source indices and the
    float32 weights of cv2's (IPP's) INTER_CUBIC."""
    x = (np.arange(n_out) + 0.5) / f - 0.5
    s = np.floor(x)
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return _frozen(idx, _cubic_weights(x - s).astype(np.float32))


def resize_cubic(img: np.ndarray, fx: Optional[float] = None,
                 fy: Optional[float] = None, window: Optional[Window] = None,
                 dsize: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=fx, fy=fy, interpolation=INTER_CUBIC)``
    for a (H, W) or (H, W, C) uint8 or float32 image (only ``window`` of
    it, when given); with ``dsize=(width, height)`` in place of the
    factors, ``cv2.resize(img, dsize, interpolation=INTER_CUBIC)``, whose
    factors are ``dsize / size``."""
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_cubic takes uint8 or float32, not {img.dtype}")
    h, w = img.shape[:2]
    if dsize is not None:
        ow, oh = int(dsize[0]), int(dsize[1])
        fx, fy = ow / w, oh / h
    else:
        fy = fx if fy is None else fy
        oh, ow = out_size(h, fy), out_size(w, fx)
    if img.dtype == np.float32 and _as_hwc(img).shape[2] not in (1, 3, 4):
        if window is not None:
            raise ValueError("resize_cubic takes no window for this image")
        return _resize_cubic_f32_opencv(img, ow, oh, fx, fy)

    def run(src, cols, rows, c0, r0):
        out = _separable(_planes(src), cols[0] - c0, cols[1], rows[0] - r0, rows[1])
        if img.dtype == np.uint8:
            out = np.clip(np.floor(out + np.float32(0.5)), 0, 255).astype(np.uint8)
        return _from_planes(out, img.ndim)

    return _windowed(img, window, oh, ow, cubic_taps(w, ow, fx),
                     cubic_taps(h, oh, fy), run)


def _coord_f32(n_out: int, inv_scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's source coordinate of each output along one axis,
    ``(float)((d + 0.5) * (1 / inv_scale) - 0.5)``, split into its floor
    (int64) and float32 fraction."""
    x = ((np.arange(n_out) + 0.5) * (1.0 / inv_scale) - 0.5).astype(np.float32)
    s = np.floor(x)
    return s.astype(np.int64), (x - s).astype(np.float32)


@functools.lru_cache(maxsize=64)
def opencv_cubic_taps(n_in: int, n_out: int, inv_scale: float):
    """OpenCV's own INTER_CUBIC taps of one axis: the 4 replicated-border
    source indices and interpolateCubic's float32 weights."""
    s, t = _coord_f32(n_out, inv_scale)
    a, one = np.float32(-0.75), np.float32(1)
    u = t + one
    w0 = ((a * u - np.float32(5) * a) * u + np.float32(8) * a) * u - np.float32(4) * a
    w1 = ((a + np.float32(2)) * t - (a + np.float32(3))) * t * t + one
    v = one - t
    w2 = ((a + np.float32(2)) * v - (a + np.float32(3))) * v * v + one
    w3 = one - w0 - w1 - w2
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return _frozen(idx, np.stack([w0, w1, w2, w3], axis=1).astype(np.float32))


def _resize_cubic_f32_opencv(img: np.ndarray, ow: int, oh: int,
                             fx: float, fy: float) -> np.ndarray:
    """OpenCV's float32 INTER_CUBIC (resizeGeneric without IPP): per row,
    ((s0 a0 + s1 a1) + s2 a2) + s3 a3; then per output row, over the
    row's W * C values, b0 r0 + (b1 r1 + (b2 r2 + b3 r3)) in 4-lane vector
    steps and ((b0 r0 + b1 r1) + b2 r2) + b3 r3 for the last W * C mod 4."""
    h, w = img.shape[:2]
    src = _as_hwc(img)
    c = src.shape[2]
    ix, ax = opencv_cubic_taps(w, ow, fx)
    iy, ay = opencv_cubic_taps(h, oh, fy)
    rows = src[:, ix[:, 0]] * ax[None, :, 0, None]
    for k in range(1, 4):
        rows += src[:, ix[:, k]] * ax[None, :, k, None]
    rows = rows.reshape(h, ow * c)
    r = [rows[iy[:, k]] for k in range(4)]
    b = [ay[:, k, None] for k in range(4)]
    n_vec = ow * c - (ow * c) % 4
    out = r[0] * b[0] + (r[1] * b[1] + (r[2] * b[2] + r[3] * b[3]))
    tail = slice(n_vec, None)
    out[:, tail] = ((r[0][:, tail] * b[0] + r[1][:, tail] * b[1])
                    + r[2][:, tail] * b[2]) + r[3][:, tail] * b[3]
    return out.reshape((oh, ow) + img.shape[2:])


# ---------------------------------------------------------------------------
# INTER_LINEAR resize (the dsize form)


@functools.lru_cache(maxsize=64)
def linear_taps_u8(n_in: int, n_out: int, columns: bool):
    """OpenCV's fixed-point INTER_LINEAR taps of one axis: (n_out, 2)
    source indices and 11-bit weights, each weight rounded on its own from
    the float32 fraction.  Along columns an output before the first pixel
    or at or past the last takes that pixel at full weight; along rows the
    fraction stays and the indices are clamped."""
    s, t = _coord_f32(n_out, n_out / n_in)
    if columns:
        edge = (s < 0) | (s >= n_in - 1)
        t = np.where(edge, np.float32(0), t)
        s = np.clip(s, 0, n_in - 1)
    w0 = np.rint((np.float32(1) - t) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(t * np.float32(2048)).astype(np.int32)
    idx = np.clip(np.stack([s, s + 1], axis=1), 0, n_in - 1)
    return _frozen(idx, np.stack([w0, w1], axis=1))


@functools.lru_cache(maxsize=64)
def linear_taps_f32(n_in: int, n_out: int):
    """IPP's INTER_LINEAR taps of one axis: (n_out, 2) source indices
    and the float32 fraction of the float64 source coordinate ``(d + 0.5)
    * (n_in / n_out) - 0.5`` (a fraction just under 1 rounds to 1), an
    output outside the pixels' span taking the nearest one.  Equal to cv2
    for inputs of 2 pixels or more along the axis."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(x).astype(np.int64)
    t = (x - s).astype(np.float32)
    edge = (s < 0) | (s >= n_in - 1)
    t = np.where(edge, np.float32(0), t)
    s = np.clip(s, 0, n_in - 1)
    return _frozen(np.stack([s, np.minimum(s + 1, n_in - 1)], axis=1), t)


def _fma_lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """float32 ``fma(b - a, t, a)``: the product is exact in long double
    and the sum rounds once there, then to float32."""
    d = (b - a).astype(np.longdouble)
    return (d * t + a).astype(np.float32)


def resize_linear(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, dsize)`` (INTER_LINEAR), ``dsize=(width,
    height)``, for a (H, W) or (H, W, C) uint8 image or a (H, W) float32
    one."""
    h, w = img.shape[:2]
    ow, oh = int(dsize[0]), int(dsize[1])
    if img.dtype == np.float32 and img.ndim == 2:
        if (oh, ow) == (h, w):
            return img.copy()
        (cx, tx), (cy, ty) = linear_taps_f32(w, ow), linear_taps_f32(h, oh)
        r = _fma_lerp(img[:, cx[:, 0]], img[:, cx[:, 1]], tx[None, :])
        return _fma_lerp(r[cy[:, 0]], r[cy[:, 1]], ty[:, None])
    if img.dtype != np.uint8:
        raise TypeError("resize_linear takes uint8 images or one-channel "
                        f"float32 ones, not {img.dtype} of shape {img.shape}")
    if (oh, ow) == (h, w):
        return img.copy()
    (cx, ax), (cy, ay) = linear_taps_u8(w, ow, True), linear_taps_u8(h, oh, False)
    src = _as_hwc(img).astype(np.int32)
    r = (src[:, cx[:, 0]] * ax[None, :, 0, None]
         + src[:, cx[:, 1]] * ax[None, :, 1, None]) >> 4
    out = ((((ay[:, 0, None, None] * r[cy[:, 0]]) >> 16)
            + ((ay[:, 1, None, None] * r[cy[:, 1]]) >> 16) + 2) >> 2)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[:, :, 0]


# ---------------------------------------------------------------------------
# INTER_AREA resize


def _area_table(n_in: int, n_out: int, scale: float):
    """OpenCV's computeResizeAreaTab as a dense (n_out, T) table of source
    indices and float32 weights, in OpenCV's order per output; unused
    slots repeat the output's last tap at weight 0."""
    rows = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(int(np.ceil(f1)), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps.extend((s, 1.0 / cell) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    t = max(len(r) for r in rows)
    idx = np.zeros((n_out, t), np.int64)
    wt = np.zeros((n_out, t), np.float32)
    for d, taps in enumerate(rows):
        for k, (s, a) in enumerate(taps):
            idx[d, k] = s
            wt[d, k] = np.float32(a)
        idx[d, len(taps):] = taps[-1][0]
    return idx, wt


def _area_block_taps(n_in: int, n_out: int, b: int):
    """The source pixels of each b-pixel block, clipped to the image."""
    return (np.minimum(np.arange(n_out)[:, None] * b + np.arange(b), n_in - 1),)


def _area_block_mean(src: np.ndarray, oh: int, ow: int, by: int, bx: int):
    """resizeAreaFast (integer inverse scale): the mean of each by x bx
    block; a block cut by the image's edge averages the pixels it holds.
    2 x 2 blocks round half up (OpenCV's vector path), others to even."""
    h, w, c = src.shape
    ph, pw = oh * by, ow * bx
    pad = np.zeros((max(ph, h), max(pw, w), c), np.int64)
    pad[:h, :w] = src
    cnt = np.zeros((max(ph, h), max(pw, w)), np.int64)
    cnt[:h, :w] = 1
    sums = pad[:ph, :pw].reshape(oh, by, ow, bx, c).sum(axis=(1, 3))
    n = cnt[:ph, :pw].reshape(oh, by, ow, bx).sum(axis=(1, 3))[:, :, None]
    full = n == by * bx
    if by == 2 and bx == 2:
        whole = (sums + 2) >> 2
    else:
        whole = np.rint(sums.astype(np.float32) * np.float32(1.0 / (by * bx)))
    part = np.rint(sums.astype(np.float32) / np.maximum(n, 1).astype(np.float32))
    out = np.where(full, whole, np.where(n > 0, part, 0))
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_grow_taps(n_in: int, n_out: int, scale: float, inv: float,
                    columns: bool):
    """The 2-tap INTER_LINEAR table OpenCV builds for INTER_AREA when
    growing: source floor(d * scale), weight of the second tap from the
    cell overlap, both weights rounded to 1/2048 on their own.  Along
    columns an output whose first tap is the last source pixel takes it at
    full weight; along rows the second tap is clamped to the last row."""
    d = np.arange(n_out)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    if columns:
        f = np.where(s >= n_in - 1, np.float32(0), f)
        s = np.minimum(s, n_in - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    if columns:
        w0 = np.where(s == n_in - 1, 2048, w0)
    return np.stack([s, np.minimum(s + 1, n_in - 1)], axis=1), np.stack([w0, w1], axis=1)


def _area_grow(src: np.ndarray, cols, rows):
    (x, a), (y, b) = cols, rows
    s = src.astype(np.int64)
    r = s[:, x[:, 0]] * a[None, :, 0, None] + s[:, x[:, 1]] * a[None, :, 1, None]
    r0, r1 = r[y[:, 0]], r[y[:, 1]]
    b0, b1 = b[:, 0, None, None], b[:, 1, None, None]
    # VResizeLinear's vector form: (hi16(b0 * (r0 >> 4)) + hi16(b1 *
    # (r1 >> 4)) + 2) >> 2
    out = (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def area_taps(h: int, w: int, fx: float, fy: float):
    """The output size, the path ('block', 'shrink' or 'grow') and the
    per-axis tap tables (columns, rows) of cv2's INTER_AREA resize of an
    (h, w) image; the first entry of each table is its (outputs, T) source
    indices."""
    oh, ow = out_size(h, fy), out_size(w, fx)
    sx, sy = 1.0 / fx, 1.0 / fy
    if sx >= 1 and sy >= 1:
        bx, by = int(np.rint(sx)), int(np.rint(sy))
        eps = np.finfo(np.float64).eps
        if abs(sx - bx) < eps and abs(sy - by) < eps:
            path, tables = "block", (_area_block_taps(w, ow, bx),
                                     _area_block_taps(h, oh, by))
        else:
            path, tables = "shrink", (_area_table(w, ow, sx), _area_table(h, oh, sy))
    else:
        path, tables = "grow", (_area_grow_taps(w, ow, sx, fx, True),
                                _area_grow_taps(h, oh, sy, fy, False))
    return (oh, ow), path, tuple(_frozen(*t) for t in tables)


def resize_area_u8(img: np.ndarray, fx: float, fy: float = None,
                   window: Optional[Window] = None) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=fx, fy=fy, interpolation=INTER_AREA)``
    for a (H, W) or (H, W, C) uint8 image (only ``window`` of it, when
    given)."""
    fy = fx if fy is None else fy
    if img.dtype != np.uint8:
        raise TypeError(f"resize_area_u8 takes uint8, not {img.dtype}")
    h, w = img.shape[:2]
    (oh, ow), path, (col_taps, row_taps) = area_taps(h, w, fx, fy)
    if (oh, ow) == (h, w):
        y0, y1, x0, x1 = window or (0, oh, 0, ow)
        return img[y0:y1, x0:x1].copy()

    def run(src, cols, rows, c0, r0):
        src = _as_hwc(src)
        if path == "block":
            return _area_block_mean(src, rows[0].shape[0], cols[0].shape[0],
                                    int(np.rint(1.0 / fy)), int(np.rint(1.0 / fx)))
        cols = (cols[0] - c0, cols[1])
        rows = (rows[0] - r0, rows[1])
        if path == "shrink":
            out = _separable(_planes(src), cols[0], cols[1], rows[0], rows[1])
            return np.moveaxis(np.clip(np.rint(out), 0, 255).astype(np.uint8), 0, 2)
        return _area_grow(src, cols, rows)

    return _windowed(img, window, oh, ow, col_taps, row_taps, run)


# ---------------------------------------------------------------------------
# rotation


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the (2, 3) float64 matrix rotating by
    ``angle`` degrees (counter-clockwise) about ``center``."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = np.deg2rad(angle)
    alpha = np.cos(a) * scale
    beta = np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def warp_affine_cubic(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                      border_value) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=INTER_CUBIC,
    borderMode=BORDER_CONSTANT, borderValue=border_value)`` for a (H, W) or
    (H, W, C) uint8 image; ``dsize`` is (width, height)."""
    if img.dtype != np.uint8:
        raise TypeError(f"warp_affine_cubic takes uint8, not {img.dtype}")
    return warp_window(lambda r0, r1, c0, c1: img[r0:r1, c0:c1], img.shape, m,
                       (0, int(dsize[1]), 0, int(dsize[0])), border_value,
                       content_box(img, border_value))


def warp_window(source: Callable[[int, int, int, int], np.ndarray],
                src_shape: Sequence[int], m: np.ndarray, window: Window,
                border_value, content: Optional[Window]) -> np.ndarray:
    """``window`` of ``warp_affine_cubic``'s output for a source image of
    ``src_shape`` that ``source(y0, y1, x0, x1)`` gives a region of, as
    uint8.  ``content`` bounds the source pixels that differ from the
    border value (None: none do); only the output pixels whose 4 x 4 taps
    reach it are summed, the others are the border value."""
    h, w = src_shape[:2]
    c = src_shape[2] if len(src_shape) == 3 else 1
    cval = np.broadcast_to(np.asarray(border_value, np.float32).reshape(-1)[:c], (c,))
    oy0, oy1, ox0, ox1 = window
    oh, ow = max(oy1 - oy0, 0), max(ox1 - ox0, 0)
    out = np.empty((c, oh * ow), np.float32)
    out[:] = cval[:, None]

    # the inverse map, as warpAffine inverts m
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    if content is not None and oh and ow:
        # source coordinates in float32: each row's start, then x times
        # the row step, one rounding each
        a11, a12, b1, a21, a22, b2 = (np.float32(v) for v in (a11, a12, b1, a21, a22, b2))
        xs = np.arange(ox0, ox1, dtype=np.float32)[None, :]
        ys = np.arange(oy0, oy1, dtype=np.float32)[:, None]
        sx = (a11 * xs + (a12 * ys + b1)).reshape(-1)
        sy = (a21 * xs + (a22 * ys + b2)).reshape(-1)
        fx, fy = np.floor(sx), np.floor(sy)
        # first tap of each 4 x 4 window
        tx = fx.astype(np.int64) - 1
        ty = fy.astype(np.int64) - 1
        cy0, cy1, cx0, cx1 = content
        hit = (tx > cx0 - 4) & (tx < cx1) & (ty > cy0 - 4) & (ty < cy1)
        sel = slice(None) if hit.all() else np.flatnonzero(hit)
        if isinstance(sel, slice) or sel.size:
            tx, ty = tx[sel], ty[sel]
            # the source region the taps read inside the content box; taps
            # outside it read the border value from a 4-pixel frame
            ry0, ry1 = max(int(ty.min()), cy0), min(int(ty.max()) + 4, cy1)
            rx0, rx1 = max(int(tx.min()), cx0), min(int(tx.max()) + 4, cx1)
            wp = rx1 - rx0 + 8
            planes = np.empty((c, ry1 - ry0 + 8, wp), np.float32)
            planes[:] = cval[:, None, None]
            planes[:, 4:-4, 4:-4] = np.moveaxis(_as_hwc(source(ry0, ry1, rx0, rx1)), 2, 0)
            planes = planes.reshape(c, -1)
            wx = _cubic_weights(sx[sel] - fx[sel], axis=0).astype(np.float32)
            wy = _cubic_weights(sy[sel] - fy[sel], axis=0).astype(np.float32)
            base = (ty - ry0 + 4) * wp + (tx - rx0 + 4)
            acc = np.zeros((c, tx.size), np.float32)
            row = np.empty_like(acc)
            tap = np.empty_like(acc)
            for ky in range(4):
                np.take(planes, base + ky * wp, axis=1, out=row)
                row *= wx[0]
                for kx in range(1, 4):
                    np.take(planes, base + (ky * wp + kx), axis=1, out=tap)
                    tap *= wx[kx]
                    row += tap
                row *= wy[ky]
                acc += row
            if isinstance(sel, slice):
                out = acc
            else:
                for ch in range(c):
                    np.put(out[ch], sel, acc[ch])
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    out = np.ascontiguousarray(out.T).reshape(oh, ow, c)
    return out if len(src_shape) == 3 else out[:, :, 0]


# ---------------------------------------------------------------------------
# polygon fill


def _trunc_div(a: int, b: int) -> int:
    """C integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's clipLine to [0, w-1] x [0, h-1]: the clipped endpoints
    (integer, the shift along an axis truncated toward zero) and whether
    any part of the segment is inside."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1), (x2, y2), (c1 | c2) == 0


def _line_pixels(w: int, h: int, p1, p2):
    """LineIterator(p1, p2, 8-connected, left to right) after clipping to
    the image: (xs, ys) of the pixels it visits, or None."""
    inside = 0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h
    if not inside:
        p1, p2, ok = _clip_line(w, h, p1, p2)
        if not ok:
            return None
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # Bresenham's minor step count after k major steps, in closed form:
    # ceil((2 * minor * k - major) / (2 * major))
    mk = -((major - 2 * minor * k) // (2 * major)) if major else k * 0
    if steep:
        return x1 + mk, y1 + sy * k
    return x1 + k, y1 + sy * mk


def fill_poly(mask: np.ndarray, polys: Sequence[np.ndarray], value) -> np.ndarray:
    """``cv2.fillPoly(mask, polys, value)`` in place on a (H, W) array:
    ``polys`` are (N, 2) integer (x, y) vertex arrays, filled together
    under the even-odd rule, with their edges drawn as lines."""
    h, w = mask.shape[:2]
    lines_x, lines_y = [], []
    edges = []                                    # (y0, x, dx, y1)
    for poly in polys:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        prev = pts[-1]
        for cur in pts:
            px = _line_pixels(w, h, prev, cur)
            if px is not None:
                lines_x.append(px[0])
                lines_y.append(px[1])
            # the edge through pixel centres in 16.16 fixed point; an edge
            # with an end outside the image runs along its clipped segment
            # (a segment clipped to a point leaves a vertical edge at it)
            (a_x, a_y), (b_x, b_y) = prev, cur
            if not (0 <= prev[0] < w and 0 <= cur[0] < w
                    and 0 <= prev[1] < h and 0 <= cur[1] < h):
                c0, c1, _ = _clip_line(w, h, prev, cur)
                a_x, b_x = c0[0], c1[0]
                if c0[1] != c1[1]:
                    a_y, b_y = c0[1], c1[1]
            a_x <<= _XY_SHIFT
            b_x <<= _XY_SHIFT
            if prev[1] != cur[1]:
                edx = _trunc_div(b_x - a_x, b_y - a_y)
                if prev[1] < cur[1]:
                    edges.append((prev[1], a_x + (prev[1] - a_y) * edx, edx, cur[1]))
                else:
                    edges.append((cur[1], b_x + (cur[1] - b_y) * edx, edx, prev[1]))
            prev = cur
    if lines_x:
        mask[np.concatenate(lines_y), np.concatenate(lines_x)] = value
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, np.int64)
    y0, x0, dx, y1 = e.T
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= (w << _XY_SHIFT)):
        return mask
    # the active edges of row y sit at x0 + (y - y0) * dx: each row of a
    # closed polygon crosses an even number of edges, all of them paired
    # and stepped every row; pairs of the row's x order bound its spans
    y_hi = min(int(y1.max()), h)
    n = np.clip(np.minimum(y1, y_hi) - np.maximum(y0, 0), 0, None)
    if n.sum() == 0:
        return mask
    eid = np.repeat(np.arange(len(e)), n)
    first = np.repeat(np.cumsum(n) - n, n)
    ys = np.maximum(y0, 0)[eid] + (np.arange(eid.size) - first)
    xs = x0[eid] + (ys - y0[eid]) * dx[eid]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    # the pixels whose centres lie in [left, right]
    left = -((-xs[0::2]) >> _XY_SHIFT)
    right = xs[1::2] >> _XY_SHIFT
    rows = ys[0::2]
    keep = (left < w) & (right >= 0)
    left = np.clip(left[keep], 0, w - 1)
    right = np.clip(right[keep], 0, w - 1)
    rows = rows[keep]
    span = np.zeros((h, w + 1), np.int32)
    np.add.at(span, (rows, left), 1)
    np.add.at(span, (rows, right + 1), -1)
    mask[np.cumsum(span[:, :w], axis=1) > 0] = value
    return mask
