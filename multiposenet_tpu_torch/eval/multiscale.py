"""Multi-scale evaluation helpers — the port's copy of
multiposenet_tpu/eval/multiscale.py (reference evaluate/tester.py:38-81,
256-331): scale selection, crop/pad to factor-divisible, bucketed shapes,
and the host chain of the reference: each scale's heatmaps resized to the
original resolution, the flip average, and a numpy peak finder for the
averaged maps.  The cv2 resizes are data/imgproc's, which equal cv2's
(INTER_LINEAR on uint8 images; INTER_CUBIC on the 18-joint heatmaps).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from multiposenet_tpu_torch.data.imgproc import resize_cubic, resize_linear

# L/R channel swap for flip averaging, 18-joint order (tester.py:326-327)
SWAP_HEAT_18 = [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 15, 14, 17, 16]


def get_multipliers(img_h: int, inp_size: int,
                    scale_search: Sequence[float] = (0.5, 1.0, 1.5, 2.0, 2.5)
                    ) -> List[float]:
    """Scales relative to the image height (reference tester.py:256-262)."""
    return [x * inp_size / float(img_h) for x in scale_search]


def _factor_closest(num: float, factor: int, is_ceil: bool = True) -> int:
    num = float(num) / factor
    num = np.ceil(num) if is_ceil else np.floor(num)
    return int(num) * factor


def crop_shape_only(shape_hw: Tuple[int, int], dest_size: float,
                    factor: int = 32, basedon: str = "min",
                    bucket: int = 0) -> Tuple[Tuple[int, int], float,
                                              Tuple[int, int]]:
    """The shape arithmetic of the reference's crop_with_factor
    (tester.py:38-81): returns (padded (H, W), im_scale, real (H, W)).  The
    ``basedon`` side is scaled to ``dest_size`` with cv2's rounding
    (round-half-to-even of dim * scale), and both sides are padded up to a
    multiple of max(factor, bucket)."""
    h, w = int(shape_hw[0]), int(shape_hw[1])
    base = {"min": min(h, w), "max": max(h, w), "w": w, "h": h}[basedon]
    im_scale = float(dest_size) / base
    rh = int(np.round(h * im_scale))
    rw = int(np.round(w * im_scale))
    eff = max(factor, bucket)
    return (_factor_closest(rh, eff), _factor_closest(rw, eff)), \
        im_scale, (rh, rw)


def crop_with_factor(im: np.ndarray, dest_size: float, factor: int = 32,
                     pad_val: int = 0, basedon: str = "min",
                     bucket: int = 0) -> Tuple[np.ndarray, float, Tuple]:
    """Scale the ``basedon`` side to ``dest_size`` with ``cv2.resize(im,
    (rw, rh))`` (INTER_LINEAR, the dsize form) and pad with ``pad_val`` to
    a multiple of max(factor, bucket) (reference tester.py:38-81).
    Returns (padded image, im_scale, the resized image's shape)."""
    (new_h, new_w), im_scale, (rh, rw) = crop_shape_only(
        im.shape[:2], dest_size, factor=factor, basedon=basedon,
        bucket=bucket)
    im = resize_linear(im, (rw, rh))
    shape = [new_h, new_w] if im.ndim < 3 else [new_h, new_w, im.shape[-1]]
    padded = np.full(shape, pad_val, dtype=im.dtype)
    padded[:rh, :rw] = im
    return padded, im_scale, im.shape


def resize_heatmap_to_original(heatmap_s4: np.ndarray, cropped_shape,
                               real_shape, orig_shape) -> np.ndarray:
    """Stride-4 float32 heatmaps -> the original resolution (reference
    tester.py:299-305): x4 INTER_CUBIC, cut to the resized image's region,
    INTER_CUBIC to the original size."""
    hm = heatmap_s4[: cropped_shape[0] // 4, : cropped_shape[1] // 4, :]
    hm = resize_cubic(hm, 4.0)
    hm = hm[: real_shape[0], : real_shape[1], :]
    return resize_cubic(hm, dsize=(orig_shape[1], orig_shape[0]))


def average_flip_heat(normal_heat: np.ndarray, flipped_heat: np.ndarray
                      ) -> np.ndarray:
    """(H, W, 18) average with the mirrored map un-flipped and its
    left/right joints swapped (reference tester.py:318-331)."""
    return (normal_heat + flipped_heat[:, ::-1, :][:, :, SWAP_HEAT_18]) / 2.0


# ---------------------------------------------------------------------------
# the reference's peak finder (joint_utils.NMS / get_joint_list) on the host


def local_max_cross(hm: np.ndarray) -> np.ndarray:
    """(H, W, C) -> bool mask of the pixels >= their 4 neighbours, an edge
    pixel's missing neighbour being itself: ``maximum_filter(m,
    footprint=cross) == m`` per channel with scipy's 'reflect' border
    (reference joint_utils.py:28)."""
    p = np.pad(hm, ((1, 1), (1, 1)) + ((0, 0),) * (hm.ndim - 2), mode="edge")
    c = p[1:-1, 1:-1]
    return ((c >= p[:-2, 1:-1]) & (c >= p[2:, 1:-1])
            & (c >= p[1:-1, :-2]) & (c >= p[1:-1, 2:]))


def _compute_resized_coords(coords, factor):
    return (np.asarray(coords, float) + 0.5) * factor - 0.5


def _peak_sites(heatmaps: np.ndarray, thre1: float):
    """(ys, xs, cs) of the local maxima above ``thre1``, y-major then
    channel: ``local_max_cross`` at the pixels above the threshold only."""
    h, w, _ = heatmaps.shape
    ys, xs, cs = np.nonzero(heatmaps > thre1)
    v = heatmaps[ys, xs, cs]
    keep = ((v >= heatmaps[np.maximum(ys - 1, 0), xs, cs])
            & (v >= heatmaps[np.minimum(ys + 1, h - 1), xs, cs])
            & (v >= heatmaps[ys, np.maximum(xs - 1, 0), cs])
            & (v >= heatmaps[ys, np.minimum(xs + 1, w - 1), cs]))
    return ys[keep], xs[keep], cs[keep]


def _refine_peak_batch(patches: np.ndarray, factor: float
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(K, ph, pw) windows around K peaks -> the (row, col) of each
    window's maximum after an x``factor`` INTER_CUBIC upsample, and its
    value.  The windows ride one resize as the channels of one image; the
    C-order argmax keeps the reference's first-maximum rule."""
    k = patches.shape[0]
    stack = np.ascontiguousarray(np.moveaxis(patches, 0, -1))
    if factor != 1.0:
        stack = resize_cubic(stack, factor)
    uh, uw = stack.shape[:2]
    flat = stack.reshape(uh * uw, k)
    am = flat.argmax(axis=0)
    return am // uw, am % uw, flat[am, np.arange(k)]


def find_peaks_np(heatmaps: np.ndarray, thre1: float = 0.1,
                  upsamp_factor: float = 1.0, refine: bool = True,
                  win_size: int = 2) -> List[np.ndarray]:
    """The reference's peak finder (joint_utils.py NMS): per joint, rows
    [x, y, score, id] at the upsampled resolution, joints in order and a
    joint's peaks y-major.  Each peak is refined in its (2 * win_size + 1)
    window, cut at the borders, the windows of one size upsampled
    together (``_refine_peak_batch``)."""
    h, w, num_j = heatmaps.shape
    ys, xs, cs = _peak_sites(heatmaps, thre1)
    order = np.argsort(cs, kind="stable")
    ys, xs, cs = ys[order], xs[order], cs[order]
    n = len(ys)

    d_yx = np.zeros((n, 2))
    scores = heatmaps[ys, xs, cs].astype(np.float64)
    if refine and n:
        y0 = np.maximum(ys - win_size, 0)
        y1 = np.minimum(ys + win_size, h - 1)
        x0 = np.maximum(xs - win_size, 0)
        x1 = np.minimum(xs + win_size, w - 1)
        ph, pw = y1 - y0 + 1, x1 - x0 + 1
        for hh, ww in set(zip(ph.tolist(), pw.tolist())):
            g = np.nonzero((ph == hh) & (pw == ww))[0]
            gy = y0[g, None, None] + np.arange(hh)[None, :, None]
            gx = x0[g, None, None] + np.arange(ww)[None, None, :]
            ly, lx, val = _refine_peak_batch(
                heatmaps[gy, gx, cs[g, None, None]], upsamp_factor)
            centers = _compute_resized_coords(
                np.stack([ys[g] - y0[g], xs[g] - x0[g]], 1), upsamp_factor)
            d_yx[g, 0] = ly - centers[:, 0]
            d_yx[g, 1] = lx - centers[:, 1]
            scores[g] = val

    base = _compute_resized_coords(np.stack([xs, ys], 1), upsamp_factor)
    # half to even, as the reference's python round
    xy = np.round(base + d_yx[:, ::-1])
    rows_all = np.concatenate(
        [xy, scores[:, None], np.arange(n, dtype=float)[:, None]], axis=1)
    return [rows_all[cs == j] for j in range(num_j)]


def joint_list_from_heatmaps(heatmaps: np.ndarray, img_h: int, scale: float,
                             thre1: float = 0.1,
                             refine: bool = True) -> np.ndarray:
    """get_joint_list (reference joint_utils.py:141-152): rows
    [x, y, score, id, joint_type]."""
    per_type = find_peaks_np(heatmaps, thre1,
                             img_h / float(heatmaps.shape[0]),
                             refine=refine)
    for peaks in per_type:
        peaks[:, :2] *= scale
    rows = [tuple(p) + (j,) for j, peaks in enumerate(per_type) for p in peaks]
    return np.array(rows).reshape(-1, 5)
