"""Host-side image augmentation of the keypoint and detection datasets —
the port's copy of multiposenet_tpu/data/augment.py, with cv2's operators
replaced by their numpy counterparts in ``data/imgproc``.

Same transform semantics as the reference (datasets/coco_data/
ImageAugmentation.py:25-340): scale -> rotate -> crop/pad -> flip, with the
keypoint variant carrying (joints, mask_miss) and the detection variant
carrying instance-mask lists.  Randomness comes from an explicit
``np.random.Generator``, drawn in the JAX package's order, so one seed gives
both packages the same choices and the same geometry.

Constants (COCO_data_pipeline.py:25-40): scale in [0.8, 1.2] * target_dist
0.6 / scale_provided, rotation +/-40 deg, centre perturbation +/-40 px, flip
p=0.3, pad values img 128 / mask_miss 255 / instance masks 0.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from multiposenet_tpu_torch.config import DataConfig
from multiposenet_tpu_torch.data.imgproc import (
    area_taps,
    content_box,
    cubic_taps,
    out_size,
    reach,
    resize_area_u8,
    resize_cubic,
    rotation_matrix_2d,
    warp_affine_cubic,
    warp_window,
)

# L/R joint swap for horizontal flip, 18-joint internal order
# (reference ImageAugmentation.py:148-149)
FLIP_ORDER_18 = [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 15, 14, 17, 16]


@dataclasses.dataclass
class KeypointSample:
    """Mutable working record for one keypoint training sample."""
    img: np.ndarray            # (H, W, 3) uint8 BGR
    mask_miss: np.ndarray      # (H, W) uint8
    joints: np.ndarray         # (P, 18, 3) float; row 0 is the 'self' person
    objpos: np.ndarray         # (2,) float, self person center
    scale_provided: float


def _scale_factor(s, cfg: DataConfig, rng: np.random.Generator) -> float:
    if rng.random() > cfg.scale_prob:
        mult = 1.0
    else:
        mult = (cfg.scale_max - cfg.scale_min) * rng.random() + cfg.scale_min
    return cfg.target_dist / s.scale_provided * mult


def _rotation_degree(cfg: DataConfig, rng: np.random.Generator) -> float:
    return (rng.random() - 0.5) * 2 * cfg.max_rotate_degree


def aug_scale(s: KeypointSample, cfg: DataConfig, rng: np.random.Generator):
    scale = _scale_factor(s, cfg, rng)
    s.img = resize_cubic(s.img, scale)
    s.mask_miss = resize_cubic(s.mask_miss, scale)
    s.objpos = s.objpos * scale
    s.joints[:, :, :2] *= scale
    return s


def _bound_rotation(h: int, w: int, angle: float):
    """The matrix that rotates an (h, w) image by ``angle`` about its
    centre into a canvas that holds all of it, and the canvas's (w, h)
    (reference ImageAugmentation.py:179-201)."""
    cx, cy = w // 2, h // 2
    m = rotation_matrix_2d((cx, cy), -angle, 1.0)
    cos, sin = abs(m[0, 0]), abs(m[0, 1])
    nw = int(h * sin + w * cos)
    nh = int(h * cos + w * sin)
    m[0, 2] += nw / 2 - cx
    m[1, 2] += nh / 2 - cy
    return m, (nw, nh)


def _rotate_bound(image: np.ndarray, angle: float, border_value
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate keeping the whole image in frame."""
    m, dsize = _bound_rotation(*image.shape[:2], angle)
    return warp_affine_cubic(image, m, dsize, border_value), m


def _rotate_points(s: KeypointSample, m: np.ndarray) -> None:
    pts = np.concatenate([s.objpos[None], s.joints[:, :, :2].reshape(-1, 2)])
    rot = pts @ m[:, :2].T + m[:, 2]
    s.objpos = rot[0]
    s.joints[:, :, :2] = rot[1:].reshape(s.joints.shape[0], -1, 2)


def aug_rotate(s: KeypointSample, cfg: DataConfig, rng: np.random.Generator):
    degree = _rotation_degree(cfg, rng)
    s.img, m = _rotate_bound(s.img, degree, (128, 128, 128))
    s.mask_miss, _ = _rotate_bound(s.mask_miss, degree, 255)
    _rotate_points(s, m)
    return s


def _crop_origin(objpos: np.ndarray, cfg: DataConfig,
                 rng: np.random.Generator) -> Tuple[np.ndarray, int, int]:
    """The perturbed crop centre and the crop's first row and column in an
    image padded by a full crop on each side."""
    crop = cfg.inp_size
    x_off = int((rng.random() - 0.5) * 2 * cfg.center_perturb_max)
    y_off = int((rng.random() - 0.5) * 2 * cfg.center_perturb_max)
    center = (objpos + np.array([x_off, y_off])).astype(int)
    return center, center[1] + crop // 2, center[0] + crop // 2


def _window(fetch, shape, dtype, pad_value, y0: int, x0: int, hh: int,
            ww: int, pad: int) -> np.ndarray:
    """``np.pad(a, pad, constant_values=pad_value)[y0:y0+hh, x0:x0+ww]``
    for the (h, w[, C]) image ``a`` that ``fetch(r0, r1, c0, c1)`` gives
    regions of, computing only the region the window keeps (numpy
    slicing's clipping included)."""
    h, w = shape[:2]
    ys = slice(*slice(y0, y0 + hh).indices(h + 2 * pad)[:2])
    xs = slice(*slice(x0, x0 + ww).indices(w + 2 * pad)[:2])
    out = np.full((max(ys.stop - ys.start, 0), max(xs.stop - xs.start, 0))
                  + tuple(shape[2:]), pad_value, dtype)
    sy0, sy1 = max(ys.start - pad, 0), min(ys.stop - pad, h)
    sx0, sx1 = max(xs.start - pad, 0), min(xs.stop - pad, w)
    if sy1 > sy0 and sx1 > sx0:
        out[sy0 + pad - ys.start: sy1 + pad - ys.start,
            sx0 + pad - xs.start: sx1 + pad - xs.start] = fetch(sy0, sy1, sx0, sx1)
    return out


def _crop_array(a: np.ndarray, pad_value, y0: int, x0: int, size: int, pad: int):
    return _window(lambda r0, r1, c0, c1: a[r0:r1, c0:c1], a.shape, a.dtype,
                   pad_value, y0, x0, size, size, pad)


def _crop_points(s: KeypointSample, center: np.ndarray, crop: int) -> None:
    offset = np.array([crop / 2 - center[0], crop / 2 - center[1]])
    s.objpos = s.objpos + offset
    s.joints[:, :, :2] += offset
    out = ((s.joints[:, :, 0] >= crop) | (s.joints[:, :, 0] < 0) |
           (s.joints[:, :, 1] >= crop) | (s.joints[:, :, 1] < 0))
    s.joints[out, 2] = 2


def aug_croppad(s: KeypointSample, cfg: DataConfig, rng: np.random.Generator):
    crop = cfg.inp_size
    center, y0, x0 = _crop_origin(s.objpos, cfg, rng)
    # padded row `crop` is original row 0, so the reference's slice
    # [center + crop//2, center + crop//2 + crop) of the image padded by a
    # full crop covers original rows [center - crop//2, center + crop//2)
    s.img = _crop_array(s.img, 128, y0, x0, crop, crop)
    # the exact crop for the mask too (the JAX package's choice; the
    # reference's crop+1 mask slice is swallowed by the stride resize)
    s.mask_miss = _crop_array(s.mask_miss, 255, y0, x0, crop, crop)
    _crop_points(s, center, crop)
    return s


def aug_flip(s: KeypointSample, cfg: DataConfig, rng: np.random.Generator):
    if rng.random() > cfg.flip_prob:
        return s
    s.img = s.img[:, ::-1].copy()
    s.mask_miss = s.mask_miss[:, ::-1].copy()
    w = s.img.shape[1]
    s.objpos[0] = w - 1 - s.objpos[0]
    s.joints[:, :, 0] = w - 1 - s.joints[:, :, 0]
    s.joints = s.joints[:, FLIP_ORDER_18, :]
    return s


def _cubic_tables(a: np.ndarray, scale: float):
    h, w = a.shape[:2]
    return (cubic_taps(w, out_size(w, scale), scale)[0],
            cubic_taps(h, out_size(h, scale), scale)[0])


def _area_tables(a: np.ndarray, scale: float):
    _, _, (cols, rows) = area_taps(*a.shape[:2], scale, scale)
    return cols[0], rows[0]


def _scaled_rotated_window(a: np.ndarray, scale: float, degree: float, resize,
                           tables, border, sparse: bool, y0: int, x0: int,
                           size: int, pad: int) -> np.ndarray:
    """The crop ``[y0, y0 + size)`` (rows and columns, in the canvas padded
    by ``pad`` with the border value) of ``a`` resized by ``scale`` then
    rotated in bounds by ``degree`` over ``border``: what the step chain
    (scale, rotate, crop) gives, computed only where the crop keeps it.
    ``tables(a, scale)`` gives the resize's column and row source indices;
    with ``sparse`` only the pixels that differ from the border (a mask's
    foreground) are followed through the rotation."""
    cols, rows = tables(a, scale)
    rh, rw = len(rows), len(cols)
    m, (nw, nh) = _bound_rotation(rh, rw, degree)
    content = (0, rh, 0, rw)
    if sparse:
        box = content_box(a, border)
        content = None
        if box is not None:
            (r0, r1), (c0, c1) = reach(rows, box[0], box[1]), reach(cols, box[2], box[3])
            content = (r0, r1, c0, c1) if r1 > r0 and c1 > c0 else None
    src_shape = (rh, rw) + a.shape[2:]

    def source(r0, r1, c0, c1):
        return resize(a, scale, window=(r0, r1, c0, c1))

    def canvas(r0, r1, c0, c1):
        return warp_window(source, src_shape, m, (r0, r1, c0, c1), border, content)

    pad_value = np.asarray(border).reshape(-1)[0]
    return _window(canvas, (nh, nw) + a.shape[2:], a.dtype, pad_value, y0, x0,
                   size, size, pad)


def augment_keypoint_sample(s: KeypointSample, cfg: DataConfig,
                            rng: np.random.Generator) -> KeypointSample:
    """aug_scale, aug_rotate, aug_croppad and aug_flip in one pass: the
    same draws, geometry and pixels, with the resize and the rotation
    computed only where the crop keeps them."""
    scale = _scale_factor(s, cfg, rng)
    degree = _rotation_degree(cfg, rng)
    h, w = s.img.shape[:2]
    m, _ = _bound_rotation(out_size(h, scale), out_size(w, scale), degree)
    s.objpos = s.objpos * scale
    s.joints[:, :, :2] *= scale
    _rotate_points(s, m)
    crop = cfg.inp_size
    center, y0, x0 = _crop_origin(s.objpos, cfg, rng)
    s.img = _scaled_rotated_window(s.img, scale, degree, resize_cubic,
                                   _cubic_tables, (128, 128, 128), False,
                                   y0, x0, crop, crop)
    s.mask_miss = _scaled_rotated_window(s.mask_miss, scale, degree,
                                         resize_cubic, _cubic_tables, 255, True,
                                         y0, x0, crop, crop)
    _crop_points(s, center, crop)
    return aug_flip(s, cfg, rng)


def remove_illegal_joints(joints: np.ndarray, crop: int) -> np.ndarray:
    """Joints outside the crop become (1, 1, 2)
    (reference COCO_data_pipeline.py:176-194)."""
    out = ((joints[:, :, 0] >= crop) | (joints[:, :, 0] < 0) |
           (joints[:, :, 1] >= crop) | (joints[:, :, 1] < 0))
    joints = joints.copy()
    joints[out] = (1.0, 1.0, 2.0)
    return joints


# ---------------------------------------------------------------------------
# detection variant: image + list of instance masks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BBoxSample:
    img: np.ndarray                 # (H, W, 3) uint8 BGR
    masks: List[np.ndarray]         # instance masks, uint8
    classes: List[int]              # 0 person / -1 crowd
    objpos: np.ndarray
    scale_provided: float


def augment_bbox_sample(s: BBoxSample, cfg: DataConfig,
                        rng: np.random.Generator) -> BBoxSample:
    """The reference's scale (aug_scale_bbox:234-259; masks INTER_AREA),
    rotation (aug_rotate_bbox:328-340; mask border 0), crop
    (aug_croppad_bbox:262-310; the centre is only scaled) and flip
    (aug_flip_bbox:313-325), with the resize and the rotation computed only
    where the crop keeps them."""
    scale = _scale_factor(s, cfg, rng)
    s.objpos = s.objpos * scale
    degree = _rotation_degree(cfg, rng)
    crop = cfg.inp_size
    _, y0, x0 = _crop_origin(s.objpos, cfg, rng)
    s.img = _scaled_rotated_window(s.img, scale, degree, resize_cubic,
                                   _cubic_tables, (128, 128, 128), False,
                                   y0, x0, crop, crop)
    # the reference keeps the +1 slice for masks; box extents are identical
    s.masks = [_scaled_rotated_window(m, scale, degree, resize_area_u8,
                                      _area_tables, 0, True, y0, x0, crop + 1,
                                      crop) for m in s.masks]
    if rng.random() <= cfg.flip_prob:
        s.img = s.img[:, ::-1].copy()
        s.masks = [m[:, ::-1].copy() for m in s.masks]
    return s


def boxes_from_masks(masks: List[np.ndarray], classes: List[int]) -> np.ndarray:
    """GT boxes from post-augmentation mask extents
    (reference COCO_data_pipeline.py:382-405).  Crowds (-1) are skipped;
    empty masks yield a -1 row."""
    rows = []
    for m, c in zip(masks, classes):
        if c == -1:
            continue
        hor = np.where(m.any(axis=0))[0]
        ver = np.where(m.any(axis=1))[0]
        if hor.size:
            rows.append([hor[0], ver[0], hor[-1] + 1, ver[-1] + 1, 0])
        else:
            rows.append([-1, -1, -1, -1, -1])
    return np.asarray(rows, np.float32).reshape(-1, 5)


def pad_boxes(boxes: np.ndarray, max_n: int) -> np.ndarray:
    """Pad to (max_n, 5) with -1 (reference bbox_collater,
    COCO_data_pipeline.py:444-457)."""
    out = np.full((max_n, 5), -1.0, np.float32)
    n = min(len(boxes), max_n)
    if n:
        out[:n] = boxes[:n]
    return out
