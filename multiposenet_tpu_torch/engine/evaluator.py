"""Evaluator — the multi-scale COCO evaluator and the single-scale demo
path, PyTorch port of multiposenet_tpu/engine/evaluator.py (reference
evaluate/tester.py:106-581).

  coco_eval()  multi-scale + flip COCO keypoint evaluation (OKS AP)
  test()       single-scale demo inference over an image directory
  run_image()  one image of test()

By default every step runs on the device, as on the JAX evaluator's default
path.  Per image: one upload of the original; the scale pyramid built on the
device (ops/pyramid.py); one forward per scale with the mirrored image in
the same batch, with detections (and so NMS kernel K1) on the scale-1.0
forward only; every scale's heatmaps resized to the original resolution by
two matmuls, summed, flip-folded and searched for peaks on the device
(``fold_peaks``); then the PRN stage and the greedy assignment on the
device, and the result rows on the host.  An image whose peak top-k fills
every slot of some joint is dispatched again at
``cfg.peaks.escalate_max_peaks``; a crowd beyond the base PRN capacity is
grouped at the escalated (peaks, people) tier.

The JAX package's switches turn steps back to the reference's host chain
(eval/multiscale.py, eval/grouping.py), the oracle of the device path:
``device_image_resize=False`` resizes each scale on the host and uploads
it; ``detect_scale1_only=False`` runs detections on every scale;
``device_peaks=False`` fetches the folded map and finds peaks on the host;
``device_resize=False`` runs the whole reference chain (host-resized scales,
every scale's heatmaps fetched, resized, averaged and flip-averaged on the
host, then host peaks); ``prn.device_grouping=False`` assigns on the host.
``group_size > 1`` dispatches images of one scale-shape signature together
(engine/grouped_eval.py).

Images come from ``load_image(file_name) -> (H, W, 3) uint8 BGR`` (or None
for a missing file); the default, ``read_image_bgr``, reads from the image
directory with ``data/image_io.read_image`` (PNG without cv2).

``coco_eval`` overlaps images: the calling thread loads and dispatches image
n + 1 while one worker thread fetches image n's peaks and boxes, groups its
people and formats them; at most two images (or groups) are in flight.  The
host chain fetches on the calling thread and finishes on the worker.
Inside a process group of several processes ``coco_eval`` shards the images
by itself and gathers the rows on process 0, which scores them.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multiposenet_tpu_torch.config import Config, PeakConfig, resolve_device
from multiposenet_tpu_torch.data.coco_json import COCOIndex
from multiposenet_tpu_torch.data.image_io import read_image, write_png
from multiposenet_tpu_torch.data.imgproc import resize_linear
from multiposenet_tpu_torch.engine.inference import (
    FullPipeline,
    PRNPipeline,
    full_fp32_matmul,
    make_full_pipeline,
)
from multiposenet_tpu_torch.eval.cocoeval import KeypointEval
from multiposenet_tpu_torch.eval.grouping import (
    drop_neck_reindex,
    format_assignment,
    group_peaks,
    to_coco_order,
)
from multiposenet_tpu_torch.eval.multiscale import (
    SWAP_HEAT_18,
    average_flip_heat,
    crop_with_factor,
    get_multipliers,
    joint_list_from_heatmaps,
    resize_heatmap_to_original,
)
from multiposenet_tpu_torch.eval.render import plot_results
from multiposenet_tpu_torch.models.posenet import PoseNet, build_posenet
from multiposenet_tpu_torch.ops.grouping import Assignment, assign_peaks
from multiposenet_tpu_torch.ops.nms import rounded_to
from multiposenet_tpu_torch.ops.peaks import PeakSet, find_peaks_refined_batched
from multiposenet_tpu_torch.ops.pyramid import (
    build_pyramid,
    lerp_taps,
    pyramid_taps,
    resize_u8,
)
from multiposenet_tpu_torch.ops.resize import heatmap_resize_mats

logger = logging.getLogger(__name__)

NUM_J17 = 17


def det_scale_idx(n_scales: int) -> int:
    """Index of the one scale whose detections coco_eval reads: scale 1.0,
    scale_search index 1 (reference tester.py:169), or 0 when only one
    scale is configured."""
    return min(1, n_scales - 1)


def _joints_to_peak_arrays(joint_list: Sequence[Sequence[float]],
                           max_peaks: int, context: str = ""
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[x, y, score, id, joint_type(17)] rows -> padded (17, P, 2)/(17, P)
    arrays for the PRN stage, peaks of a joint in input order.  Peaks over
    the capacity are dropped with a warning."""
    peak_xy = np.zeros((NUM_J17, max_peaks, 2), np.float32)
    peak_valid = np.zeros((NUM_J17, max_peaks), bool)
    counts = [0] * NUM_J17
    dropped = 0
    for row in joint_list:
        t = int(row[4])
        if counts[t] < max_peaks:
            peak_xy[t, counts[t]] = (row[0], row[1])
            peak_valid[t, counts[t]] = True
            counts[t] += 1
        else:
            dropped += 1
    if dropped:
        logger.warning(
            "%s: dropped %d peak(s) over the per-joint capacity %d — raise "
            "cfg.peaks.escalate_max_peaks (or max_peaks_per_joint) to "
            "process this crowd fully", context or "image", dropped,
            max_peaks)
    # the reference enters every peak with confidence 1 (tester.py:345)
    peak_score = np.where(peak_valid, 1.0, -1.0).astype(np.float32)
    return peak_xy, peak_score, peak_valid


def peak_arrays_to_joint_list(coords: np.ndarray, scores: np.ndarray,
                              valid: np.ndarray, scale: float = 1.0
                              ) -> List[List[float]]:
    """(J, P, 2)/(J, P) peak arrays -> reference joint-list rows
    [x, y, score, id, joint_type] (joint_utils.py:141-152), ids in
    (joint, slot) order."""
    full = np.asarray(valid).all(axis=1)
    if full.any():
        logger.warning(
            "peak capacity saturated for joint type(s) %s (capacity %d): "
            "the top-k may have truncated lower-scoring peaks — raise "
            "cfg.peaks.escalate_max_peaks (coco_eval re-dispatches saturated "
            "images at that tier when it is set)",
            np.where(full)[0].tolist(), valid.shape[1])
    joint_list = []
    pid = 0
    for j in range(coords.shape[0]):
        for p in range(coords.shape[1]):
            if valid[j, p]:
                joint_list.append([float(coords[j, p, 0]) * scale,
                                   float(coords[j, p, 1]) * scale,
                                   float(scores[j, p]), pid, j])
                pid += 1
    return joint_list


def drop_neck(joint_list: np.ndarray) -> List[List[float]]:
    """18-joint rows -> 17-joint rows (reference tester.py:160-167)."""
    out = []
    for row in np.asarray(joint_list).reshape(-1, 5).tolist():
        t = drop_neck_reindex(int(row[-1]))
        if t is not None:
            row[-1] = t
            out.append(row)
    return out


@functools.lru_cache(maxsize=8)
def _swap_index(device: torch.device) -> torch.Tensor:
    # uploaded once per device: a pageable upload per image would block the
    # host until the device has drained its queue
    return torch.tensor(SWAP_HEAT_18, device=device)


def fold_heat(hms: Sequence[torch.Tensor],
              mats: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              h: int, w: int, with_flip: bool, inv_n: float) -> torch.Tensor:
    """Per scale (nb, s4h, s4w, 18) heatmaps and their resize matrices
    (Rh (hp, s4h), Rwt (s4w, wp)) -> the (hp, wp, 18) float32 map at the
    original resolution: each scale resized as ``Rh @ hm @ Rwt`` in float32
    without TF32, summed in scale order, times ``inv_n``; with flip the
    mean with row 1 mirrored about the valid width ``w`` and its
    left/right joints swapped (reference tester.py:318-331); zero outside
    (h, w)."""
    acc = None
    with full_fp32_matmul():
        for hm, (rh, rwt) in zip(hms, mats):
            r = rh @ hm.float().permute(0, 3, 1, 2) @ rwt       # (nb,18,hp,wp)
            acc = r if acc is None else acc + r
    v = acc * inv_n
    wp = v.shape[3]
    if with_flip:
        cols = (w - 1 - torch.arange(wp, device=v.device)).clamp(0, wp - 1)
        heat = (v[0] + v[1][_swap_index(v.device)][:, :, cols]) / 2.0
    else:
        heat = v[0]
    # the mirror brings the padding's columns into view: zero them before
    # the peak finder sees them
    heat[:, h:, :] = 0.0
    heat[:, :, w:] = 0.0
    return heat.permute(1, 2, 0)


def fold_peaks(hms, mats, h: int, w: int, with_flip: bool, inv_n: float,
               peaks_cfg: PeakConfig, max_peaks: Optional[int] = None
               ) -> PeakSet:
    """``fold_heat`` then the peak finder at the original resolution
    (upsample factor 1): a (J, P) PeakSet in original-image pixels.
    ``max_peaks`` overrides the per-joint capacity (crowd escalation)."""
    heat = fold_heat(hms, mats, h, w, with_flip, inv_n)
    peaks = find_peaks_refined_batched(
        heat[None], thre1=peaks_cfg.thre1,
        max_peaks=max_peaks or peaks_cfg.max_peaks_per_joint, upsamp_factor=1,
        win_size=peaks_cfg.win_size, refine=peaks_cfg.refine)
    return PeakSet(*(t[0] for t in peaks))


class FoldedHeat(NamedTuple):
    """One image's (h, w, 18) float32 heatmap average at its original
    resolution, fetched for the host peak finder: the device's folded map,
    or the host chain's average of the image's rows with, under flip, the
    mirrored rows' average apart in ``flip`` (None when folded in)."""
    heat: np.ndarray
    flip: Optional[np.ndarray] = None


def read_image_bgr(directory: str, file_name: str) -> Optional[np.ndarray]:
    """``cv2.imread(directory/file_name)``: (H, W, 3) uint8 BGR, or None
    when there is no such file (``data/image_io.read_image``: PNG without
    cv2, other formats through cv2)."""
    try:
        return read_image(os.path.join(directory, file_name))
    except RuntimeError as e:
        raise RuntimeError(f"{e}; or pass load_image(file_name) -> (H, W, 3) "
                           "uint8 BGR array") from None


class StageTimes:
    """Where an evaluation's time goes, when the caller sets
    ``Evaluator.stage_times = StageTimes()``: CUDA events around each
    device stage's work (``device_ms``; the span between a stage's events
    includes any time the device waits for the host to enqueue the stage),
    and the host clock (``host_s``) around each stage's enqueue
    (``"enqueue <stage>"``) and around the host's own work: ``"finish"``
    (joint lists, PRN inputs, result rows), and on the host chains
    ``"host_crop"`` (resizing the scales), ``"host_resize"`` (resizing and
    averaging the heatmaps), ``"host_peaks"`` and ``"host_grouping"``.
    Device stages: ``"pyramid"``, ``"upload"`` (host-resized scales),
    ``"forward <scale>"``, ``"fold_peaks"``, ``"fold"`` (without peaks),
    ``"fetch"`` (the host chain's heatmap copies), ``"prn_assign"`` and
    ``"prn"`` (without the assignment)."""

    def __init__(self):
        self.events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = \
            collections.defaultdict(list)
        self.host_s: Dict[str, float] = collections.defaultdict(float)

    def device_ms(self) -> Dict[str, float]:
        """Total device ms per stage; synchronises."""
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.events.items()}


class Evaluator:
    """Multi-scale COCO evaluation and single-scale demo inference.

    The model comes from ``state_dict`` (loaded strictly into a new PoseNet)
    or is passed ready-built as ``model``.  Runs on ``cuda`` unless
    ``device`` names another device; without a GPU and without an explicit
    ``device="cpu"`` it raises.
    """

    # bound on each cache of device-resident constants (resize matrices,
    # pyramid taps): LRU-evicted, so a set with hundreds of image sizes
    # cannot grow them without limit
    _DEV_CACHE_MAX = 256

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 device=None, model: Optional[PoseNet] = None):
        self.device = resolve_device(device)
        if model is None:
            if state_dict is None:
                raise ValueError("Evaluator needs a state_dict or a model")
            model = build_posenet(cfg.model, self.device, state_dict)
        self.cfg = cfg
        self.model = model
        self._pipelines: Dict[Tuple[int, int, bool, bool], FullPipeline] = {}
        self._prn: Optional[PRNPipeline] = None
        self._prn_assign: Optional[Callable[..., Assignment]] = None
        self._caches: Dict[str, collections.OrderedDict] = {}
        self._cache_lock = threading.RLock()
        # the dispatching thread and the worker share one stream; a stage's
        # work is enqueued under this lock, so its events bracket only it.
        # The lock also serialises full_fp32_matmul, which swaps the
        # process-wide TF32 flags and puts them back: taken with timing
        # off too, it keeps one thread's exit from turning TF32 back on in
        # the middle of the other's float32 convs and matmuls
        self._enqueue_lock = threading.Lock()
        self.stage_times: Optional[StageTimes] = None
        # ids of the images coco_eval dispatched again at the escalated
        # peak capacity
        self.escalated: List[int] = []

    # ------------------------------------------------------------------
    # pipelines and device caches

    def pipeline(self, hw: Tuple[int, int], with_peaks: bool = True,
                 with_detections: bool = True) -> FullPipeline:
        key = (int(hw[0]), int(hw[1]), with_peaks, with_detections)
        with self._cache_lock:
            if key not in self._pipelines:
                self._pipelines[key] = make_full_pipeline(
                    self.model, self.cfg, key[:2], device=self.device,
                    with_peaks=with_peaks, with_detections=with_detections)
            return self._pipelines[key]

    def prn_pipeline(self) -> Callable[..., tuple]:
        """(peak_xy, peak_score, peak_valid, boxes_xywh, box_valid) of one
        image -> (table, inside, prn_out, x0, y0), the PRN stage alone."""
        with self._cache_lock:
            if self._prn is None:
                self._prn = PRNPipeline(self.model, self.cfg)
            prn = self._prn

        def run(*args):
            with full_fp32_matmul():
                return prn(*args)
        return run

    def prn_assign_pipeline(self) -> Callable[..., Assignment]:
        """(peak_xy, peak_score, peak_valid, boxes_xywh, box_valid) of one
        image -> the PRN stage followed by the greedy assignment."""
        with self._cache_lock:
            if self._prn_assign is None:
                prn = self.prn_pipeline()

                def run(peak_xy, peak_score, peak_valid, boxes, box_valid):
                    table, inside, prn_out, x0, y0 = prn(
                        peak_xy, peak_score, peak_valid, boxes, box_valid)
                    return assign_peaks(table, inside, x0, y0, prn_out, boxes)
                self._prn_assign = run
            return self._prn_assign

    def _lru(self, name: str, key, make, maxn: Optional[int] = None):
        """Bounded LRU cache ``name``; ``maxn`` (default _DEV_CACHE_MAX)
        bounds its entries: a group's entries are G stacked and take
        _DEV_CACHE_MAX // G."""
        with self._cache_lock:
            cache = self._caches.setdefault(name, collections.OrderedDict())
            if key in cache:
                cache.move_to_end(key)
            else:
                cache[key] = make()
                while len(cache) > (maxn or self._DEV_CACHE_MAX):
                    cache.popitem(last=False)
            return cache[key]

    def _resize_mats_dev(self, s4h: int, s4w: int, real_h: int, real_w: int,
                         h: int, w: int, hp: int, wp: int):
        """(Rh (hp, s4h), Rwt (s4w, wp)) on the device: one scale's stride-4
        heatmap to the original resolution (ops/resize.heatmap_resize_mats)."""
        key = (s4h, s4w, real_h, real_w, h, w, hp, wp)
        return self._lru("resize_mats", key, lambda: tuple(
            torch.from_numpy(np.array(m)).to(self.device)
            for m in heatmap_resize_mats(*key)))

    def _pyramid_taps(self, h: int, w: int, dests: Sequence[float],
                      bucket: int, with_flip: bool):
        key = (h, w, tuple(round(float(d), 6) for d in dests), bucket,
               bool(with_flip))
        return self._lru("pyramid_taps", key, lambda: pyramid_taps(
            h, w, dests, bucket, with_flip, self.device))

    # ------------------------------------------------------------------
    # host <-> device and stage accounting

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        # from pinned memory the copy queues behind the device's work
        # instead of waiting for it
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, tensors: Sequence[torch.Tensor]):
        """Enqueue the copies of ``tensors`` to the host; ``_wait`` on the
        returned handle before reading them."""
        if self.device.type != "cuda":
            return [t.cpu() for t in tensors], None
        out = [t.to("cpu", non_blocking=True) for t in tensors]
        done = torch.cuda.Event()
        done.record()
        return out, done

    @staticmethod
    def _wait(fetched) -> List[np.ndarray]:
        tensors, done = fetched
        if done is not None:
            done.synchronize()
        return [t.numpy() for t in tensors]

    @contextlib.contextmanager
    def _stage(self, name: str):
        times = self.stage_times
        with self._enqueue_lock:
            if times is None:
                yield
                return
            t0 = time.perf_counter()
            if self.device.type != "cuda":
                yield
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                times.events[name].append((start, end))
            times.host_s[f"enqueue {name}"] += time.perf_counter() - t0

    @contextlib.contextmanager
    def _host_stage(self, name: str):
        times = self.stage_times
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if times is not None:
                times.host_s[name] += time.perf_counter() - t0

    # ------------------------------------------------------------------
    # one image of the multi-scale eval

    def _boxes_kept(self, dets, row: int = 0) -> List[torch.Tensor]:
        """[boxes (K, 4) float32, keep (K,)] of one batch row's detections:
        x1y1x2y2 boxes of the resized image and whether each scores above
        the test threshold (reference tester.py:169, 233-241)."""
        keep = dets.scores[row] > rounded_to(
            self.cfg.detection.test_score_thresh, dets.scores.dtype)
        return [dets.boxes[row].float(), keep]

    def _host_scales(self, multipliers: Sequence[float], img: np.ndarray,
                     bucket: int, with_flip: bool):
        """Each scale resized and padded on the host (``crop_with_factor``,
        reference tester.py:285-291), with the mirrored image's in the same
        batch, and uploaded: ((padded (H, W), resized (h, w), im_scale) per
        scale, the (1 or 2, H, W, 3) uint8 RGB batches on the device)."""
        img_f = img[:, ::-1] if with_flip else None
        scales, batches = [], []
        for m in multipliers:
            with self._host_stage("host_crop"):
                dest = m * img.shape[0]
                cropped, im_scale, real = crop_with_factor(
                    img, dest, factor=32, pad_val=128, bucket=bucket)
                rows = [cropped[:, :, ::-1]]
                if with_flip:
                    rows.append(crop_with_factor(img_f, dest, factor=32, pad_val=128,
                                                 bucket=bucket)[0][:, :, ::-1])
                batch = np.stack(rows)
            with self._stage("upload"):
                batches.append(self._upload(batch))
            scales.append((cropped.shape[:2], tuple(real[:2]), im_scale))
        return scales, batches

    def _dispatch_image_device(self, multipliers: Sequence[float],
                               img: np.ndarray, bucket: int = 64,
                               with_flip: bool = False,
                               max_peaks: Optional[int] = None):
        """Enqueue all of one image's device work and the copies of what the
        host reads — its peaks (or, with ``device_peaks`` off, its folded
        map) and scale-1.0 boxes; returns the handle for
        ``_fetch_image_device``."""
        ecfg = self.cfg.eval
        h, w = img.shape[:2]
        pad_to = max(bucket, 1)
        hp = -(-h // pad_to) * pad_to
        wp = -(-w // pad_to) * pad_to
        if ecfg.device_image_resize:
            taps = self._pyramid_taps(h, w, [m * h for m in multipliers], bucket,
                                      with_flip)
            with self._stage("pyramid"):
                batches = build_pyramid(self._upload(img[:, :, ::-1]), taps)
            scales = [(t.padded_hw, t.real_hw, t.im_scale) for t in taps]
        else:
            scales, batches = self._host_scales(multipliers, img, bucket, with_flip)
        det_idx = det_scale_idx(len(scales))
        hms, mats = [], []
        for s, (((dh, dw), (rh, rw), im_scale), batch) in enumerate(
                zip(scales, batches)):
            mats.append(self._resize_mats_dev(dh // 4, dw // 4, rh, rw, h, w,
                                              hp, wp))
            # the other scales' boxes, with detect_scale1_only off, are
            # computed and not read, as in the reference
            wd = s == det_idx or not ecfg.detect_scale1_only
            with self._stage(f"forward {s}"):
                out = self.pipeline((dh, dw), with_peaks=False,
                                    with_detections=wd)(batch)
            hms.append(out.heatmaps)
            if s == det_idx:
                dets, det_scale = out.detections, im_scale
        inv_n = 1.0 / len(multipliers)
        if ecfg.device_peaks:
            with self._stage("fold_peaks"):
                pk = fold_peaks(hms, mats, h, w, with_flip, inv_n, self.cfg.peaks,
                                max_peaks)
                fetched = self._to_host([pk.coords, pk.scores, pk.valid]
                                        + self._boxes_kept(dets))
            return fetched, det_scale, None
        with self._stage("fold"):
            heat = fold_heat(hms, mats, h, w, with_flip, inv_n)
            fetched = self._to_host([heat] + self._boxes_kept(dets))
        return fetched, det_scale, (h, w)

    def _fetch_image_device(self, handle):
        """-> (scale-1.0 boxes x1y1x2y2 in original pixels, the (coords,
        scores, valid) peak arrays in original pixels or, with
        ``device_peaks`` off, the folded map as a ``FoldedHeat``)."""
        fetched, im_scale, hw = handle
        *found, boxes, keep = self._wait(fetched)
        boxes = (boxes[keep] / im_scale).tolist()
        if hw is None:
            return boxes, tuple(found)
        # the padded map cut to the image on the host
        return boxes, FoldedHeat(found[0][:hw[0], :hw[1]])

    def _get_outputs_device(self, multipliers: Sequence[float],
                            img: np.ndarray, bucket: int = 64,
                            with_flip: bool = False):
        return self._fetch_image_device(self._dispatch_image_device(
            multipliers, img, bucket=bucket, with_flip=with_flip))

    def _get_outputs_host(self, multipliers: Sequence[float], img: np.ndarray,
                          bucket: int = 64, with_flip: bool = False):
        """The reference's chain (``device_resize`` off; reference
        tester.py:131-193, 264-316): each scale resized on the host and
        uploaded, one forward with detections per scale, one fetch of every
        scale's heatmaps, each resized to the original resolution on the
        host and averaged, the mirrored rows apart.  -> (scale-1.0 boxes,
        ``FoldedHeat(average, mirrored average or None)``)."""
        scales, batches = self._host_scales(multipliers, img, bucket, with_flip)
        det_idx = det_scale_idx(len(scales))
        hms = []
        for s, ((hw, _, im_scale), batch) in enumerate(zip(scales, batches)):
            with self._stage(f"forward {s}"):
                out = self.pipeline(hw, with_peaks=False)(batch)
            hms.append(out.heatmaps)
            if s == det_idx:
                dets, det_scale = out.detections, im_scale
        with self._stage("fetch"):
            fetched = self._to_host([hm.float() for hm in hms]
                                    + self._boxes_kept(dets))
        *maps, boxes, keep = self._wait(fetched)
        with self._host_stage("host_resize"):
            n = len(multipliers)
            heat = np.zeros(img.shape[:2] + (18,), np.float32)
            flip = np.zeros_like(heat) if with_flip else None
            for hm, (hw, real, _) in zip(maps, scales):
                heat += resize_heatmap_to_original(hm[0], hw, real, img.shape) / n
                if with_flip:
                    flip += resize_heatmap_to_original(hm[1], hw, real, img.shape) / n
        return (boxes[keep] / det_scale).tolist(), FoldedHeat(heat, flip)

    def _peak_escalation_tier(self) -> int:
        """The escalated per-joint peak capacity, or 0 when it is off (or
        peaks are found on the host, whose lists are unbounded)."""
        esc = self.cfg.peaks.escalate_max_peaks
        if (self.cfg.eval.device_peaks and self.cfg.eval.device_resize
                and esc > self.cfg.peaks.max_peaks_per_joint):
            return esc
        return 0

    def _fetch_finish_escalating(self, handle, img: np.ndarray,
                                 multipliers: Sequence[float], bucket: int,
                                 name: str, img_id: int) -> List[Dict]:
        """Fetch one dispatched image and finish it (``_finish_escalating``)."""
        return self._finish_escalating(self._fetch_image_device(handle), img,
                                       multipliers, bucket, name, img_id)

    def _finish_escalating(self, outputs, img: np.ndarray,
                           multipliers: Sequence[float], bucket: int,
                           name: str, img_id: int) -> List[Dict]:
        """Finish one fetched image — after dispatching it again alone at
        the escalated peak capacity when some joint filled every slot of
        the base tier (the reference's peak lists are unbounded,
        tester.py:338-350)."""
        boxes, peaks = outputs
        esc = self._peak_escalation_tier()
        if esc and bool(peaks[2].all(axis=-1).any()):
            logger.info("%s: peak capacity %d saturated — re-dispatching at "
                        "the escalated tier %d", name or f"image {img_id}",
                        self.cfg.peaks.max_peaks_per_joint, esc)
            self.escalated.append(img_id)
            boxes, peaks = self._fetch_image_device(self._dispatch_image_device(
                multipliers, img, bucket=bucket, with_flip=self.cfg.eval.flip,
                max_peaks=esc))
        return self._finish_image(boxes, peaks, name, img_id)

    def _finish_image(self, boxes: List[List[float]], found, name: str,
                      img_id: int) -> List[Dict]:
        """Peak arrays, or a ``FoldedHeat`` to find peaks in on the host, +
        scale-1.0 boxes -> the image's COCO result rows (reference
        tester.py:151-177)."""
        if isinstance(found, FoldedHeat):
            with self._host_stage("host_peaks"):
                heat = (found.heat if found.flip is None
                        else average_flip_heat(found.heat, found.flip))
                jl = joint_list_from_heatmaps(
                    heat[:, :, :18], heat.shape[0], 1.0, self.cfg.peaks.thre1,
                    refine=self.cfg.peaks.refine)
        else:
            with self._host_stage("finish"):
                jl = np.asarray(peak_arrays_to_joint_list(*found)).reshape(-1, 5)
        with self._host_stage("finish"):
            joints = drop_neck(jl)
        results = self.prn_process(joints, boxes, name, img_id)
        with self._host_stage("finish"):
            for r in results:
                r["keypoints"] = to_coco_order(r["keypoints"])
                r.pop("file_name", None)
        return results

    # ------------------------------------------------------------------
    # PRN stage

    def _prn_capacities(self, joint_list, n_boxes: int,
                        context: str = "") -> Tuple[int, int]:
        """The (max_peaks, max_people) tier of one image: the base
        capacities, or both escalated together when the crowd overflows
        either and an escalated tier is set (reference tester.py:338-350,
        400-406 are unbounded)."""
        maxp = self.cfg.peaks.max_peaks_per_joint
        maxb = self.cfg.prn.max_people
        esc_p = self.cfg.peaks.escalate_max_peaks
        esc_b = self.cfg.prn.escalate_max_people
        counts = [0] * NUM_J17
        for row in joint_list:
            counts[int(row[4])] += 1
        need_p = max(counts)
        if ((need_p > maxp and esc_p > maxp)
                or (n_boxes > maxb and esc_b > maxb)):
            logger.info(
                "%s: crowd overflow (%d peaks/joint, %d boxes) — escalating "
                "PRN capacity to (%d peaks, %d people)",
                context, need_p, n_boxes, max(maxp, esc_p), max(maxb, esc_b))
            return max(maxp, esc_p), max(maxb, esc_b)
        return maxp, maxb

    def prn_process(self, joint_list: List[List[float]],
                    boxes_xyxy: Sequence[Sequence[float]], file_name: str = "",
                    image_id: int = 0) -> List[Dict]:
        """PRN grouping of one image (reference tester.py:333-513): 17-joint
        rows and x1y1x2y2 person boxes in original pixels -> result rows."""
        with self._host_stage("finish"):
            boxes = np.asarray(
                [[b[0], b[1], b[2] - b[0], b[3] - b[1]] for b in boxes_xyxy],
                np.float32).reshape(-1, 4)
            if len(boxes) == 0:
                # with boxes but no peaks the reference still emits one
                # all-v=0 row per box; without boxes, nothing
                return []
            context = file_name or f"image {image_id}"
            maxp, maxb = self._prn_capacities(joint_list, len(boxes), context)
            nb = min(len(boxes), maxb)
            if len(boxes) > maxb:
                logger.warning(
                    "%s: %d person boxes exceed the PRN person capacity %d; "
                    "the %d lowest-ranked are dropped — raise "
                    "cfg.prn.max_people / escalate_max_people to group this "
                    "crowd fully", context, len(boxes), maxb, len(boxes) - maxb)
            boxes_pad = np.zeros((maxb, 4), np.float32)
            boxes_pad[:nb] = boxes[:nb]
            box_valid = np.zeros(maxb, bool)
            box_valid[:nb] = True
            peak_xy, peak_score, peak_valid = _joints_to_peak_arrays(
                joint_list, maxp, context=context)

        args = (peak_xy, peak_score, peak_valid, boxes_pad, box_valid)
        if not self.cfg.prn.device_grouping:
            with self._stage("prn"):
                table, inside, prn_out, x0, y0 = self.prn_pipeline()(
                    *(self._upload(x) for x in args))
                fetched = self._to_host([table, inside, prn_out.float(), x0, y0])
            table, inside, prn_out, x0, y0 = self._wait(fetched)
            with self._host_stage("host_grouping"):
                return group_peaks(
                    table[:nb], inside[:nb], x0[:nb], y0[:nb], prn_out[:nb],
                    peak_xy, peak_valid, boxes[:nb], file_name=file_name,
                    image_id=image_id)
        with self._stage("prn_assign"):
            a = self.prn_assign_pipeline()(*(self._upload(x) for x in args))
            fetched = self._to_host([a.chosen, a.active, a.fallback_xy])
        chosen, active, fallback_xy = self._wait(fetched)
        with self._host_stage("finish"):
            # only the real boxes decide whether a joint type has any peak
            active = active[:nb]
            return format_assignment(
                chosen[:nb], active.any(axis=(0, 2)), active, fallback_xy[:nb],
                peak_xy, boxes[:nb], file_name=file_name, image_id=image_id)

    # ------------------------------------------------------------------
    # single-scale demo path (reference tester.py:195-254)

    @torch.no_grad()
    def run_image(self, img_bgr: np.ndarray, file_name: str = "",
                  image_id: int = 0) -> Tuple[List[Dict], np.ndarray]:
        """One BGR image -> (result rows, (inp/4, inp/4, 18) heatmaps): pad
        to a square at the bottom/right, resize to ``inp_size`` with cv2's
        INTER_LINEAR taps (within one uint8 step of cv2.resize), one
        forward with detections and peaks, PRN grouping."""
        cfg = self.cfg
        inp = cfg.eval.inp_size
        shape_dst = int(np.max(img_bgr.shape[:2]))
        scale = float(shape_dst) / inp
        pad = np.abs(img_bgr.shape[1] - img_bgr.shape[0])
        sq = np.pad(img_bgr, ([0, pad], [0, pad], [0, 0]),
                    "constant")[:shape_dst, :shape_dst]
        taps = self._lru("demo_taps", shape_dst, lambda: lerp_taps(
            shape_dst, inp, self.device))
        resized = resize_u8(self._upload(sq[:, :, ::-1]), taps, taps)
        out = self.pipeline((inp, inp))(resized[None])
        dets, pk = out.detections, out.peaks
        keep = dets.scores[0] > rounded_to(cfg.detection.test_score_thresh,
                                           dets.scores.dtype)
        heatmaps, coords, scores, valid, dboxes, keep = self._wait(self._to_host(
            [out.heatmaps[0].float(), pk.coords[0], pk.scores[0], pk.valid[0],
             dets.boxes[0].float(), keep]))
        # peaks from the pipeline are at input resolution (factor 4)
        joints = drop_neck(np.asarray(
            peak_arrays_to_joint_list(coords, scores, valid, scale)))
        bboxes = (dboxes[keep] * scale).tolist()
        return self.prn_process(joints, bboxes, file_name, image_id), heatmaps

    def test(self, testdata_dir: Optional[str] = None,
             testresult_dir: Optional[str] = None,
             load_image: Optional[Callable[[str], Optional[np.ndarray]]] = None
             ) -> List[Dict]:
        """``run_image`` over every readable file of ``testdata_dir`` in
        name order.  With ``cfg.eval.write_image`` each image's heatmap (the
        joints' maximum, INTER_LINEAR to the image's size, times 256, to
        uint8 as cv2.imwrite converts float32) and its people drawn on it
        are written to ``testresult_dir/<stem>_1heatmap.png`` and
        ``<stem>_2canvas.png``; with ``cfg.eval.write_json`` the rows to
        ``testresult_dir/multipose_results.json``."""
        cfg = self.cfg.eval
        testdata_dir = testdata_dir or cfg.testdata_dir
        testresult_dir = testresult_dir or cfg.testresult_dir
        load_image = load_image or functools.partial(read_image_bgr,
                                                     testdata_dir)
        all_results = []
        for name in sorted(os.listdir(testdata_dir)):
            img = load_image(name)
            if img is None:
                continue
            results, heatmaps = self.run_image(img, name)
            all_results.extend(results)
            if cfg.write_image:
                os.makedirs(testresult_dir, exist_ok=True)
                stem = os.path.join(testresult_dir, name.split(".", 1)[0])
                hm = resize_linear(np.max(heatmaps, 2), (img.shape[1], img.shape[0]))
                write_png(stem + "_1heatmap.png",
                          np.clip(np.rint(hm * 256), 0, 255).astype(np.uint8))
                write_png(stem + "_2canvas.png", plot_results(img.copy(), results))
        if cfg.write_json:
            os.makedirs(testresult_dir, exist_ok=True)
            with open(os.path.join(testresult_dir, "multipose_results.json"),
                      "w") as f:
                json.dump(all_results, f)
        return all_results

    # ------------------------------------------------------------------
    # multi-scale COCO eval (reference tester.py:131-193, 264-316)

    def coco_eval(self, coco_root: Optional[str] = None,
                  ann_file: Optional[str] = None, img_dir: Optional[str] = None,
                  max_images: Optional[int] = None,
                  result_file: Optional[str] = None, bucket: int = 64,
                  shard: Tuple[int, int] = (0, 1), skip_metrics: bool = False,
                  load_image: Optional[Callable[[str], Optional[np.ndarray]]]
                  = None) -> Dict[str, float]:
        """OKS AP of the multi-scale + flip protocol over the person images
        of ``ann_file``.  ``shard=(i, n)`` evaluates every n-th image from
        the i-th; ``result_file`` receives the result rows; with
        ``skip_metrics`` (a shard) nothing is scored.

        Inside a process group of several processes and with no explicit
        shard, each process takes its stride of the images by itself
        (``img_ids[i::n]``), the rows are gathered over the group's own
        collectives (``parallel.distributed.gather_objects``; no shared
        filesystem), and process 0 scores the merged set; the others return
        ``{}``.  A process whose loop raises still joins the gather, with
        its error in place of rows, and then raises: otherwise the others
        would wait in the collective forever.  Process 0 refuses to score a
        partial set."""
        from multiposenet_tpu_torch.parallel import distributed as pdist

        cfg = self.cfg
        coco_root = coco_root or cfg.data.coco_root
        ann_file = ann_file or os.path.join(
            coco_root, "annotations/person_keypoints_val2017.json")
        img_dir = img_dir or os.path.join(coco_root, "images/val2017")
        load_image = load_image or functools.partial(read_image_bgr, img_dir)

        gt = COCOIndex(ann_file)
        img_ids = gt.get_img_ids(cat_ids=[1])
        if max_images:
            img_ids = img_ids[:max_images]
        auto_dist = shard == (0, 1) and pdist.process_count() > 1
        if auto_dist:
            shard = (pdist.process_index(), pdist.process_count())
        full_img_ids = list(img_ids)
        if shard != (0, 1):
            img_ids = img_ids[shard[0]::shard[1]]
            logger.info("eval shard %d/%d: %d images%s", shard[0], shard[1],
                        len(img_ids),
                        " (distributed auto-shard)" if auto_dist else "")
        self.escalated = []
        results: List[Dict] = []
        eval_error: Optional[BaseException] = None
        try:
            results = self._coco_eval_loop(gt, img_ids, load_image, bucket)
        except BaseException as e:
            if not auto_dist:
                raise
            eval_error = e
            logger.exception("eval shard %d/%d failed; joining the result "
                             "gather before raising", *shard)

        if auto_dist:
            payload = {"results": results,
                       "error": repr(eval_error) if eval_error else None}
            gathered = pdist.gather_objects(payload, decode=pdist.is_primary())
            if eval_error is not None:
                raise eval_error
            if not pdist.is_primary():
                return {}
            errs = [p["error"] for p in gathered if p["error"]]
            if errs:
                raise RuntimeError(
                    f"{len(errs)} eval shard(s) failed: {errs}; refusing "
                    "to score partial results")
            results = [r for p in gathered for r in p["results"]]
            img_ids = full_img_ids

        if result_file:
            with open(result_file, "w") as f:
                json.dump(results, f, indent=4)
        if skip_metrics:
            logger.info("shard done: %d results (metrics skipped; merge "
                        "shards first)", len(results))
            return {}
        if not results:
            logger.warning("coco_eval produced no detections")
            return {}
        ev = KeypointEval(gt, gt.load_res(results), img_ids=img_ids)
        metrics = ev.evaluate()
        print(ev.summarize())
        return metrics

    def _worker(self, fn, *args):
        # grad mode and the current CUDA device are thread-local
        dev = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with torch.no_grad(), dev:
            return fn(*args)

    def _coco_eval_loop(self, gt: COCOIndex, img_ids: Sequence[int],
                        load_image, bucket: int) -> List[Dict]:
        from multiposenet_tpu_torch.engine import grouped_eval

        cfg = self.cfg
        gs = cfg.eval.group_size
        use_groups = grouped_eval.use_groups(self)
        if use_groups:
            # images of one size arrive together; a group is still keyed on
            # the loaded image's size (a wrong record costs a padded flush)
            recs = {r["id"]: r for r in gt.load_imgs(img_ids)}
            img_ids = sorted(img_ids, key=lambda i: (
                int(recs[i].get("height", 0)), int(recs[i].get("width", 0))))
        results: List[Dict] = []
        futures = []
        pending: Dict[tuple, list] = {}   # signature -> [(img, name, id), ...]

        def finish_group(handle, group):
            res = []
            for out, (img, name, img_id) in zip(
                    grouped_eval.fetch_group_device(self, handle), group):
                mult = get_multipliers(img.shape[0], cfg.eval.inp_size,
                                       cfg.eval.scale_search)
                res.extend(self._finish_escalating(out, img, mult, bucket, name,
                                                   img_id))
            return res

        with ThreadPoolExecutor(max_workers=1) as pool:

            def flush(sig):
                group = pending.pop(sig)
                # replicas of the last image fill a partial group, so that
                # every group runs at one batch size; their rows are dropped
                imgs = [g[0] for g in group]
                imgs += [imgs[-1]] * (gs - len(imgs))
                with torch.no_grad():
                    handle = grouped_eval.dispatch_group_device(
                        self, imgs, bucket, cfg.eval.flip)
                futures.append(pool.submit(self._worker, finish_group, handle,
                                           group))

            for n, img_id in enumerate(img_ids):
                name = gt.load_imgs(img_id)[0]["file_name"]
                ori = load_image(name)
                if ori is None:
                    raise FileNotFoundError(f"cannot read image {name!r}")
                mult = get_multipliers(ori.shape[0], cfg.eval.inp_size,
                                       cfg.eval.scale_search)
                if use_groups:
                    sig = grouped_eval.group_signature(self, *ori.shape[:2], bucket)
                    # sorted arrival: no other signature fills any more
                    for other in [k for k in pending if k != sig]:
                        flush(other)
                    pending.setdefault(sig, []).append((ori, name, img_id))
                    if len(pending[sig]) == gs:
                        flush(sig)
                elif cfg.eval.device_resize:
                    with torch.no_grad():
                        handle = self._dispatch_image_device(
                            mult, ori, bucket=bucket, with_flip=cfg.eval.flip)
                    futures.append(pool.submit(
                        self._worker, self._fetch_finish_escalating, handle, ori,
                        mult, bucket, name, img_id))
                else:
                    with torch.no_grad():
                        boxes, heat = self._get_outputs_host(
                            mult, ori, bucket=bucket, with_flip=cfg.eval.flip)
                    futures.append(pool.submit(
                        self._worker, self._finish_image, boxes, heat, name, img_id))
                while len(futures) > 2:
                    results.extend(futures.pop(0).result())
                if (n + 1) % 50 == 0:
                    logger.info("coco_eval %d/%d images", n + 1, len(img_ids))
            for sig in list(pending):
                flush(sig)
            for f in futures:
                results.extend(f.result())
        return results
