"""cv2-exact resize operators in numpy — the port's copy of
multiposenet_tpu/ops/resize.py, bit-equal to its arrays.

The reference resizes every scale's stride-4 heatmap to the original
resolution with cv2 INTER_CUBIC on the host (reference
evaluate/tester.py:299-305: x4 upsample, un-pad, resize to original).
Bicubic resize is a separable linear map, so the chain composes into one
dense matrix per axis (``heatmap_resize_mats``), and the evaluator applies it
as two matmuls per scale on the device.  ``linear_resize_coeffs`` gives cv2's
INTER_LINEAR taps and quantised weights for the image pyramid.

``cubic_resize_matrix`` reproduces OpenCV's float path: source coordinate
(i + 0.5) * n_in / n_out - 0.5, 4 taps with the Keys kernel at A = -0.75
(cv2's interpolateCubic), replicate borders.
"""

from __future__ import annotations

import functools

import numpy as np

_A = -0.75  # cv2's bicubic coefficient (modules/imgproc/src/resize.cpp)


def _cubic_weights(t, axis: int = -1) -> np.ndarray:
    """cv2 interpolateCubic in float64: the weights of the 4 taps at
    fractional offset(s) ``t``, stacked along ``axis`` (last: shape
    ``t.shape + (4,)``)."""
    t = np.asarray(t, np.float64)
    w0 = ((_A * (t + 1) - 5 * _A) * (t + 1) + 8 * _A) * (t + 1) - 4 * _A
    w1 = ((_A + 2) * t - (_A + 3)) * t * t + 1
    w2 = ((_A + 2) * (1 - t) - (_A + 3)) * (1 - t) * (1 - t) + 1
    return np.stack([w0, w1, w2, 1.0 - w0 - w1 - w2], axis=axis)


@functools.lru_cache(maxsize=256)
def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) operator == cv2.resize(..., INTER_CUBIC) along
    one axis for float inputs.  Read-only (lru_cache shares the instance)."""
    scale = n_in / n_out
    g = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        fx = (i + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        t = fx - sx
        for k, wv in enumerate(_cubic_weights(t)):
            j = min(max(sx - 1 + k, 0), n_in - 1)  # replicate border
            g[i, j] += wv
    g32 = g.astype(np.float32)
    g32.flags.writeable = False
    return g32


@functools.lru_cache(maxsize=1024)
def linear_resize_coeffs(ssize: int, dsize: int):
    """cv2 INTER_LINEAR tap indices + quantized weights along one axis.

    Per dst position j: source coordinate (j + 0.5) * ssize/dsize - 0.5
    (float64), 2 taps clamped to [0, ssize-1] with cv2's edge handling
    (sx < 0 -> weight 1 on tap 0; sx >= ssize-1 -> weight 1 on tap 1), and
    the tap-0 weight quantized to cv2's 1/2048 fixed-point grid.  Verified
    against cv2's own per-position tables via impulse probes; final-rounding
    differences vs cv2 builds are <=1 u8 LSB (cv2's own IPP vs scalar paths
    differ by the same amount).

    Returns (i0, i1, w0): int32 (dsize,), int32 (dsize,), float32 (dsize,)
    with the tap-1 weight = 1 - w0.
    """
    scale = ssize / dsize
    i0 = np.empty(dsize, np.int32)
    i1 = np.empty(dsize, np.int32)
    w0 = np.empty(dsize, np.float32)
    for j in range(dsize):
        s = (j + 0.5) * scale - 0.5
        sx = int(np.floor(s))
        f = s - sx
        if sx < 0:
            sx, f = 0, 0.0
        if sx >= ssize - 1:
            sx, f = ssize - 2, 1.0
        i0[j] = max(sx, 0)
        i1[j] = min(sx + 1, ssize - 1)
        w0[j] = np.round((1.0 - f) * 2048.0) / 2048.0
    for a in (i0, i1, w0):
        a.flags.writeable = False
    return i0, i1, w0


@functools.lru_cache(maxsize=256)
def heatmap_resize_mats(s4_h: int, s4_w: int, real_h: int, real_w: int,
                        orig_h: int, orig_w: int,
                        pad_h: int = 0, pad_w: int = 0):
    """Compose the reference eval resize chain into one matrix per axis.

    Chain (reference tester.py:299-305): x4 bicubic upsample of the (s4_h, s4_w)
    stride-4 map -> crop to the valid (real_h, real_w) region -> bicubic
    resize to (orig_h, orig_w).  Returns (Rh, Rw): Rh is (max(pad_h, orig_h),
    s4_h) with zero rows past orig_h, Rw is (s4_w, max(pad_w, orig_w))
    (already transposed for `Rh @ X @ Rw`).
    """
    up_h = cubic_resize_matrix(s4_h, 4 * s4_h)[:real_h]
    up_w = cubic_resize_matrix(s4_w, 4 * s4_w)[:real_w]
    rh = cubic_resize_matrix(real_h, orig_h) @ up_h          # (orig_h, s4_h)
    rw = cubic_resize_matrix(real_w, orig_w) @ up_w          # (orig_w, s4_w)
    if pad_h > orig_h:
        rh = np.pad(rh, ((0, pad_h - orig_h), (0, 0)))
    if pad_w > orig_w:
        rw = np.pad(rw, ((0, pad_w - orig_w), (0, 0)))
    rh = np.ascontiguousarray(rh, np.float32)
    rwt = np.ascontiguousarray(rw.T, np.float32)
    rh.flags.writeable = False
    rwt.flags.writeable = False
    return rh, rwt
