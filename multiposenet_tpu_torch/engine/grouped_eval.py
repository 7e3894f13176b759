"""Grouped multi-image eval dispatch (``eval.group_size > 1``) — the port of
multiposenet_tpu/engine/grouped_eval.py.

G images whose bucketed scale shapes agree (``group_signature``) go through
one pyramid pass (ops/pyramid.build_pyramid_group), one forward per scale
at batch G * nb (nb = 2 with the flip: each image, then its mirror), and one
fold + peak search over the G images, so each op is enqueued once per group
instead of once per image.  Each image keeps its own size, resize taps and
matrices, flip mirror and padding mask; the detections of image g are batch
row g * nb.  A partial group is filled with replicas of its last image,
whose rows are dropped; an image whose peak slots fill is dispatched again
alone at the escalated tier (``Evaluator._finish_escalating``).

It needs the whole device path (device_resize, device_peaks,
device_image_resize).  Every function takes the ``Evaluator`` first; its
caches live in the evaluator's bounded ``_lru``.  The reference evaluates
strictly per image (evaluate/tester.py:131-193).
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np
import torch

from multiposenet_tpu_torch.config import PeakConfig
from multiposenet_tpu_torch.engine.evaluator import (
    _swap_index,
    det_scale_idx,
)
from multiposenet_tpu_torch.engine.inference import full_fp32_matmul
from multiposenet_tpu_torch.eval.multiscale import crop_shape_only, get_multipliers
from multiposenet_tpu_torch.ops.nms import rounded_to
from multiposenet_tpu_torch.ops.peaks import PeakSet, find_peaks_refined_batched
from multiposenet_tpu_torch.ops.pyramid import build_pyramid_group, group_pyramid_taps
from multiposenet_tpu_torch.ops.resize import heatmap_resize_mats

logger = logging.getLogger(__name__)


def use_groups(ev) -> bool:
    """Whether coco_eval dispatches in groups: ``group_size > 1`` on the
    whole device path.  With a host switch on, the size is ignored with a
    warning and images go one by one."""
    e = ev.cfg.eval
    on = (e.group_size > 1 and e.device_resize and e.device_peaks
          and e.device_image_resize)
    if e.group_size > 1 and not on:
        logger.warning(
            "group_size=%d ignored: grouped dispatch needs the whole device "
            "path (device_resize, device_peaks, device_image_resize); "
            "dispatching per image", e.group_size)
    return on


def group_signature(ev, h: int, w: int, bucket: int) -> tuple:
    """The padded shape of every scale of an (h, w) image and its padded
    original: images with one signature share every batch shape of the
    device path and can ride one dispatch."""
    pad_to = max(bucket, 1)
    shapes = tuple(
        crop_shape_only((h, w), m * h, factor=32, bucket=bucket)[0]
        for m in get_multipliers(h, ev.cfg.eval.inp_size, ev.cfg.eval.scale_search))
    return shapes + ((-(-h // pad_to) * pad_to, -(-w // pad_to) * pad_to),)


def fold_heat_group(hms: Sequence[torch.Tensor],
                    mats: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    hw: torch.Tensor, with_flip: bool, inv_n: float
                    ) -> torch.Tensor:
    """``evaluator.fold_heat`` of G images at once: per scale (G * nb, s4h,
    s4w, 18) heatmaps and stacked matrices (Rh (G, hp, s4h), Rwt (G, s4w,
    wp)), each image's valid (h, w) in ``hw`` (G, 2) -> (G, hp, wp, 18)."""
    g_n = hw.shape[0]
    acc = None
    with full_fp32_matmul():
        for hm, (rh, rwt) in zip(hms, mats):
            x = hm.float().permute(0, 3, 1, 2)
            x = x.reshape((g_n, -1) + x.shape[1:])            # (G,nb,18,s4h,s4w)
            r = rh[:, None, None] @ x @ rwt[:, None, None]    # (G,nb,18,hp,wp)
            acc = r if acc is None else acc + r
    v = acc * inv_n
    hp, wp = v.shape[3], v.shape[4]
    dev = v.device
    if with_flip:
        cols = (hw[:, 1, None] - 1 - torch.arange(wp, device=dev)).clamp(0, wp - 1)
        mirror = torch.gather(v[:, 1][:, _swap_index(dev)], 3,
                              cols[:, None, None, :].expand(g_n, 18, hp, wp))
        heat = (v[:, 0] + mirror) / 2.0
    else:
        heat = v[:, 0]
    valid = ((torch.arange(hp, device=dev)[None, :, None] < hw[:, 0, None, None])
             & (torch.arange(wp, device=dev)[None, None, :] < hw[:, 1, None, None]))
    heat = torch.where(valid[:, None], heat, 0.0)
    return heat.permute(0, 2, 3, 1)


def fold_peaks_group(hms, mats, hw: torch.Tensor, with_flip: bool,
                     inv_n: float, peaks_cfg: PeakConfig) -> PeakSet:
    """``fold_heat_group`` then the peak finder: a (G, J, P) PeakSet in
    each image's original pixels, at the base capacity."""
    return find_peaks_refined_batched(
        fold_heat_group(hms, mats, hw, with_flip, inv_n),
        thre1=peaks_cfg.thre1, max_peaks=peaks_cfg.max_peaks_per_joint,
        upsamp_factor=1, win_size=peaks_cfg.win_size, refine=peaks_cfg.refine)


def _group_resize_mats(ev, keys) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scale's resize matrices of every image of a group, stacked and
    uploaded once per group composition."""
    def make():
        mats = [heatmap_resize_mats(*k) for k in keys]
        return tuple(torch.from_numpy(np.stack([m[i] for m in mats])).to(ev.device)
                     for i in (0, 1))
    return ev._lru("group_resize_mats", tuple(keys), make,
                   maxn=max(1, ev._DEV_CACHE_MAX // len(keys)))


def dispatch_group_device(ev, imgs: List[np.ndarray], bucket: int,
                          with_flip: bool):
    """Enqueue all device work of a group of images of one signature, and
    the copies of each image's peaks and scale-1.0 boxes; returns the
    handle for ``fetch_group_device``."""
    sizes = [tuple(int(v) for v in img.shape[:2]) for img in imgs]
    sig = group_signature(ev, *sizes[0], bucket)
    if any(group_signature(ev, h, w, bucket) != sig for h, w in sizes[1:]):
        raise ValueError(f"images of sizes {sizes} do not share one signature")
    g_n, nb = len(imgs), 2 if with_flip else 1
    hp, wp = sig[-1]
    ecfg = ev.cfg.eval
    dests = [[m * h for m in get_multipliers(h, ecfg.inp_size, ecfg.scale_search)]
             for h, _ in sizes]
    taps = ev._lru("group_pyramid_taps", (tuple(sizes), bucket, with_flip),
                   lambda: group_pyramid_taps(sizes, dests, bucket, with_flip,
                                              ev.device),
                   maxn=max(1, ev._DEV_CACHE_MAX // g_n))
    hw = ev._lru("group_hw", tuple(sizes),
                 lambda: torch.tensor(sizes, device=ev.device),
                 maxn=max(1, ev._DEV_CACHE_MAX // g_n))
    srcs = np.zeros((g_n, hp, wp, 3), np.uint8)
    for g, img in enumerate(imgs):
        srcs[g, :img.shape[0], :img.shape[1]] = img[:, :, ::-1]
    with ev._stage("pyramid"):
        batches = build_pyramid_group(ev._upload(srcs), taps)
    det_idx = det_scale_idx(len(taps))
    hms, mats = [], []
    for s, (t, batch) in enumerate(zip(taps, batches)):
        dh, dw = t.padded_hw
        mats.append(_group_resize_mats(ev, [
            (dh // 4, dw // 4, *crop_shape_only((h, w), dests[g][s], factor=32,
                                                bucket=bucket)[2], h, w, hp, wp)
            for g, (h, w) in enumerate(sizes)]))
        wd = s == det_idx or not ecfg.detect_scale1_only
        with ev._stage(f"forward {s}"):
            out = ev.pipeline((dh, dw), with_peaks=False, with_detections=wd)(batch)
        hms.append(out.heatmaps)
        if s == det_idx:
            dets = out.detections
    im_scales = [crop_shape_only(hw_g, d[det_idx], factor=32, bucket=bucket)[1]
                 for hw_g, d in zip(sizes, dests)]
    with ev._stage("fold_peaks"):
        pk = fold_peaks_group(hms, mats, hw, with_flip, 1.0 / len(taps), ev.cfg.peaks)
        # each image's own row, not its mirror's
        keep = dets.scores[::nb] > rounded_to(ev.cfg.detection.test_score_thresh,
                                              dets.scores.dtype)
        fetched = ev._to_host([pk.coords, pk.scores, pk.valid,
                               dets.boxes[::nb].float(), keep])
    return fetched, im_scales


def fetch_group_device(ev, handle) -> List[tuple]:
    """-> per image of the group, as ``Evaluator._fetch_image_device``:
    (scale-1.0 boxes x1y1x2y2 in original pixels, (coords, scores, valid))."""
    fetched, im_scales = handle
    coords, scores, valid, boxes, keep = ev._wait(fetched)
    return [((boxes[g][keep[g]] / s).tolist(), (coords[g], scores[g], valid[g]))
            for g, s in enumerate(im_scales)]
