"""The end-to-end pose pipeline — PyTorch twin of
multiposenet_tpu/engine/inference.py.

    images -> preprocess -> ResNet-FPN forward (heatmaps, cls, reg)
           -> anchor decode + clip -> NMS (CUDA kernel on the GPU)
           -> heatmap peaks -> 18->17 joint reindex -> box compaction
           -> PRN grids -> PRN -> per-peak window scores -> assignment

Everything runs on the pipeline's device with static shapes and no host
synchronisation until the caller fetches the result; only
``format_pose_batch`` (dict building) runs on the host.

``E2EPosePipeline`` splits into ``forward(images) -> (heatmaps, cls, reg)``
and ``postprocess(heatmaps, cls, reg, scales)`` so that a test can feed the
JAX model's tensors into the port's post-processing.  Every function batches
over images where the JAX package used ``vmap``; the grid marks are a
scatter and the window sums masked matmuls (the JAX one-hot contractions at
inference.py:409-464 were a TPU choice).

``make_sharded_pipeline`` and ``make_sharded_e2e_pipeline`` serve one batch
over the devices of a ``parallel.mesh.Mesh``: the weights replicated, the
batch split on dim 0, each slice run on its replica, the outputs
concatenated; there is no collective in the forward.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multiposenet_tpu_torch.config import Config, resolve_device
from multiposenet_tpu_torch.eval.grouping import format_assignment
from multiposenet_tpu_torch.models.posenet import PoseNet
from multiposenet_tpu_torch.parallel.mesh import Mesh, replicated, shard_batch
from multiposenet_tpu_torch.ops.anchors import anchors_for_shape
from multiposenet_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from multiposenet_tpu_torch.ops.gaussian import blur_matrix
from multiposenet_tpu_torch.ops.grouping import assign_peaks, rdiv
from multiposenet_tpu_torch.ops.nms import NMSResult, batched_topk_nms, rounded_to
from multiposenet_tpu_torch.ops.peaks import PeakSet, find_peaks_refined_batched

# ImageNet statistics (reference datasets/coco_data/preprocessing.py:15-26)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# 18-joint internal order -> 17 joints: drop the synthesized neck (joint 1)
NECK_DROP_17 = np.array([0] + list(range(2, 18)), np.int64)


@contextlib.contextmanager
def full_fp32_matmul():
    """Run float32 matmuls and convolutions without TF32 inside the block:
    the peak upsampling, PRN blur and window sums are compared exactly
    downstream (the JAX package pins them to Precision.HIGHEST)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@functools.lru_cache(maxsize=8)
def _cached_imagenet_stats(device: torch.device
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    # uploaded once per device: a pageable upload per call would block the
    # host until the device has drained its queue
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device),
            torch.tensor(255.0, device=device))


def _imagenet_stats(device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    # torch.export traces with fake tensors, which the cache would keep and
    # hand to every later call: a trace makes its own, which become
    # constants of the exported program
    if torch.compiler.is_exporting():
        return _cached_imagenet_stats.__wrapped__(device)
    return _cached_imagenet_stats(device)


def preprocess_on_device(img_rgb_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (B,H,W,3) -> ImageNet-normalised float32 (B,H,W,3).  Every
    divisor is a tensor: PyTorch's CUDA backend turns a division by a host
    scalar into a product with its reciprocal, so the card would round
    otherwise than the CPU."""
    mean, std, c255 = _imagenet_stats(img_rgb_u8.device)
    x = img_rgb_u8.float() / c255
    return (x - mean) / std


class PipelineOutput(NamedTuple):
    heatmaps: torch.Tensor                # (B, H/4, W/4, 18)
    detections: Optional[NMSResult]       # boxes (B,K,4) scores (B,K) input
    #                                       pixels; None without detections
    peaks: Optional[PeakSet]              # (B, J, P, ...) coords in input
    #                                       pixels; None without peaks


class PoseAssignments(NamedTuple):
    """Per-image grouping outputs; ``format_pose_batch`` turns a host copy
    into the reference's prn_result rows."""
    chosen: torch.Tensor       # (B, maxb, 17) int32 peak slot per joint, -1
    active_any: torch.Tensor   # (B, 17) bool joint type has any scored peak
    active: torch.Tensor       # (B, maxb, 17, P) bool
    fallback_xy: torch.Tensor  # (B, maxb, 17, 2) PRN-argmax fallback coords
    peak_xy: torch.Tensor      # (B, 17, P, 2) original-image pixel coords
    peak_valid: torch.Tensor   # (B, 17, P) bool
    boxes_xywh: torch.Tensor   # (B, maxb, 4) original-image scale
    box_valid: torch.Tensor    # (B, maxb) bool (a score-desc prefix)

    def cpu(self) -> "PoseAssignments":
        return PoseAssignments(*(t.cpu() for t in self))


class FullPipeline:
    """image -> (heatmaps, detections, peaks) for one static (H, W).

    ``with_detections=False`` runs ``PoseNet.keypoint_forward`` alone: no
    anchors, no detection pyramid or RetinaNet heads, no NMS, and
    ``detections`` is None (the multi-scale eval reads boxes from its
    scale-1.0 forward only).  ``with_peaks=False`` skips the peak finder
    and ``peaks`` is None.
    """

    def __init__(self, model: PoseNet, cfg: Config, image_hw: Tuple[int, int],
                 preprocess: bool = True, device=None, with_peaks: bool = True,
                 with_detections: bool = True):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.image_hw = (int(image_hw[0]), int(image_hw[1]))
        self.preprocess = preprocess
        self.with_peaks = with_peaks
        self.with_detections = with_detections
        self.anchors = (torch.from_numpy(np.array(
            anchors_for_shape(self.image_hw, cfg.anchors))).to(self.device)
            if with_detections else None)

    @torch.no_grad()
    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
        """(B,H,W,3) uint8 RGB (or float when preprocess=False) ->
        heatmaps (B,H/4,W/4,18), cls (B,A,1), reg (B,A,4); cls and reg are
        None without detections."""
        images = images.to(self.device, non_blocking=True)
        x = preprocess_on_device(images) if self.preprocess else images
        with full_fp32_matmul():
            if self.with_detections:
                return self.model.full_forward(x)
            return self.model.keypoint_forward(x)[0], None, None

    @torch.no_grad()
    def detect_and_peaks(self, heatmaps: torch.Tensor,
                         cls: Optional[torch.Tensor],
                         reg: Optional[torch.Tensor]) -> PipelineOutput:
        det, pk = self.cfg.detection, self.cfg.peaks
        h, w = self.image_hw
        dets = peaks = None
        with full_fp32_matmul():
            if self.with_detections:
                boxes = clip_boxes(decode_boxes(self.anchors[None], reg.float()),
                                   h, w)
                scores = cls.amax(dim=2)                  # (B, A) person prob
                dets = batched_topk_nms(boxes, scores, iou_thresh=det.nms_thresh,
                                        max_out=det.max_detections,
                                        score_thresh=det.score_thresh)
            if self.with_peaks:
                peaks = find_peaks_refined_batched(
                    heatmaps, thre1=pk.thre1, max_peaks=pk.max_peaks_per_joint,
                    upsamp_factor=self.cfg.data.feat_stride,
                    win_size=pk.win_size, refine=pk.refine)
        return PipelineOutput(heatmaps, dets, peaks)

    def __call__(self, images: torch.Tensor) -> PipelineOutput:
        return self.detect_and_peaks(*self.forward(images))


def make_full_pipeline(model: PoseNet, cfg: Config, image_hw: Tuple[int, int],
                       preprocess: bool = True, device=None,
                       with_peaks: bool = True,
                       with_detections: bool = True) -> FullPipeline:
    return FullPipeline(model, cfg, image_hw, preprocess, device,
                        with_peaks=with_peaks, with_detections=with_detections)


class E2EPosePipeline:
    """images -> grouped-person assignments, the whole demo path
    (reference evaluate/tester.py:195-254 incl. prn_process).

    ``scales`` maps model-input pixels back to original-image pixels per
    image; scaling happens before the PRN stage because it changes the PRN
    cell geometry through ceil(w).  Pass ones for inputs already at model
    resolution.
    """

    def __init__(self, model: PoseNet, cfg: Config, image_hw: Tuple[int, int],
                 preprocess: bool = True, device=None):
        self.base = FullPipeline(model, cfg, image_hw, preprocess, device)
        self.device = self.base.device
        self.cfg = cfg
        self.prn = PRNPipeline(self.base.model, cfg)
        self.sel = torch.from_numpy(NECK_DROP_17).to(self.device)

    def forward(self, images: torch.Tensor):
        return self.base.forward(images)

    @torch.no_grad()
    def postprocess(self, heatmaps: torch.Tensor, cls: torch.Tensor,
                    reg: torch.Tensor, scales: torch.Tensor
                    ) -> Tuple[PipelineOutput, PoseAssignments]:
        heatmaps, cls, reg = (t.to(self.device) for t in (heatmaps, cls, reg))
        out = self.base.detect_and_peaks(heatmaps, cls, reg)
        s = scales.to(self.device, torch.float32)[:, None, None]
        maxb = self.cfg.prn.max_people

        # peaks: 18 -> 17 joints; valid peaks are a score-desc prefix
        pxy = out.peaks.coords[:, self.sel] * s[..., None]
        pvalid = out.peaks.valid[:, self.sel]
        # every peak enters the PRN table with confidence 1 (tester.py:345)
        pscore = torch.where(pvalid, 1.0, -1.0)

        # detections: compact kept boxes to a score-desc prefix, apply the
        # test threshold, cap at max_people, xywh in original-image pixels
        dets = out.detections
        order = torch.argsort(-dets.scores, dim=1, stable=True)[:, :maxb]
        dsc = torch.gather(dets.scores, 1, order)
        dbx = torch.gather(dets.boxes, 1, order[..., None].expand(-1, -1, 4)) * s
        bvalid = dsc > rounded_to(self.cfg.detection.test_score_thresh, dsc.dtype)
        xywh = torch.cat([dbx[..., :2], dbx[..., 2:] - dbx[..., :2]], dim=-1)
        xywh = torch.where(bvalid[..., None], xywh, 0.0)

        with full_fp32_matmul():
            table, inside, prn_out, x0, y0 = self.prn(pxy, pscore, pvalid,
                                                      xywh, bvalid)
        a = assign_peaks(table, inside, x0, y0, prn_out, xywh)
        return out, PoseAssignments(
            chosen=a.chosen, active_any=a.active_any, active=a.active,
            fallback_xy=a.fallback_xy, peak_xy=pxy, peak_valid=pvalid,
            boxes_xywh=xywh, box_valid=bvalid)

    def __call__(self, images: torch.Tensor, scales: torch.Tensor
                 ) -> Tuple[PipelineOutput, PoseAssignments]:
        return self.postprocess(*self.forward(images), scales)


def make_e2e_pose_pipeline(model: PoseNet, cfg: Config,
                           image_hw: Tuple[int, int], preprocess: bool = True,
                           device=None) -> E2EPosePipeline:
    return E2EPosePipeline(model, cfg, image_hw, preprocess, device)


class ShardedPipeline:
    """One pipeline replica per device of a mesh: each positional tensor
    argument is split on dim 0 over the replicas (``shard_batch``), each
    replica runs its slice on its device (the launches of different GPUs
    overlap: nothing waits in between), and the outputs are concatenated on
    the mesh's first device, field by field through NamedTuples."""

    def __init__(self, replicas: Sequence, mesh: Mesh):
        self.replicas = list(replicas)
        self.mesh = mesh
        self.device = mesh.devices[0]

    def __call__(self, *args):
        slices = [shard_batch(self.mesh, a) for a in args]
        outs = [rep(*(s[i] for s in slices))
                for i, rep in enumerate(self.replicas)]
        return _concat(outs, self.device)


def _concat(parts: list, device: torch.device):
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, tuple):
        fields = [_concat([p[i] for p in parts], device)
                  for i in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    raise TypeError(f"cannot concatenate {type(first).__name__}")


def make_sharded_pipeline(model: PoseNet, cfg: Config,
                          image_hw: Tuple[int, int], mesh: Mesh,
                          preprocess: bool = True) -> ShardedPipeline:
    """``make_full_pipeline`` served over ``mesh``: ``images ->
    PipelineOutput`` with the batch (a multiple of ``mesh.size``) split over
    the replicas of ``model``."""
    return ShardedPipeline(
        [make_full_pipeline(m, cfg, image_hw, preprocess, device=d)
         for m, d in zip(replicated(mesh, model), mesh.devices)], mesh)


def make_sharded_e2e_pipeline(model: PoseNet, cfg: Config,
                              image_hw: Tuple[int, int], mesh: Mesh,
                              preprocess: bool = True) -> ShardedPipeline:
    """``make_e2e_pose_pipeline`` served over ``mesh``: ``(images, scales)
    -> (PipelineOutput, PoseAssignments)`` with the batch (a multiple of
    ``mesh.size``) split over the replicas of ``model``."""
    return ShardedPipeline(
        [make_e2e_pose_pipeline(m, cfg, image_hw, preprocess, device=d)
         for m, d in zip(replicated(mesh, model), mesh.devices)], mesh)


def format_pose_batch(assigns: PoseAssignments, file_names=None,
                      image_ids=None) -> List[List[dict]]:
    """Host tail: PoseAssignments (on the CPU, see ``PoseAssignments.cpu``)
    -> per-image person result lists (reference prn_result rows)."""
    a = PoseAssignments(*(np.asarray(t) for t in assigns))
    n = a.box_valid.shape[0]
    file_names = file_names or [""] * n
    image_ids = image_ids or [0] * n
    results = []
    for i in range(n):
        nb = int(a.box_valid[i].sum())  # valid is a prefix
        active = a.active[i, :nb]
        results.append(format_assignment(
            a.chosen[i, :nb],
            active.any(axis=(0, 2)) if nb else a.active_any[i],
            active, a.fallback_xy[i, :nb], a.peak_xy[i], a.boxes_xywh[i, :nb],
            file_name=file_names[i], image_id=image_ids[i]))
    return results


# ----------------------------------------------------------------------
# PRN stage: per-person input grids, PRN, per-peak score tables.
# ----------------------------------------------------------------------

def _grid_coords(peak_xy: torch.Tensor, box_xywh: torch.Tensor,
                 grid_h: int, grid_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak -> (x0, y0) int32 cell of a person crop grid with the reference's
    truncate-toward-zero cast and edge clamp (tester.py:374-391).  peak_xy
    (..., 2), box_xywh (..., 4), broadcast against each other.  A zero-width
    (padding) box maps to the grid edge or, for 0 * inf, cell 0, as XLA's
    saturating float->int conversion does."""
    x_scale = rdiv(grid_w, torch.ceil(box_xywh[..., 2]))
    y_scale = rdiv(grid_h, torch.ceil(box_xywh[..., 3]))
    fx = torch.trunc((peak_xy[..., 0] - box_xywh[..., 0]) * x_scale)
    fy = torch.trunc((peak_xy[..., 1] - box_xywh[..., 1]) * y_scale)
    x0 = torch.nan_to_num(fx, nan=0.0).clamp(0, grid_w - 1).to(torch.int32)
    y0 = torch.nan_to_num(fy, nan=0.0).clamp(0, grid_h - 1).to(torch.int32)
    return x0, y0


class PRNPipeline:
    """(peaks, boxes) -> PRN outputs + per-peak score tables.

    Inputs, one image as in JAX or with a leading image axis N:
      peak_xy     ([N,] J=17, P, 2) float  peak coords in image pixels
      peak_score  ([N,] J, P) float        -1 for invalid slots
      peak_valid  ([N,] J, P) bool
      boxes_xywh  ([N,] B, 4) float        person boxes
      box_valid   ([N,] B) bool
    Outputs (same leading axis):
      table   (B, J, P) float  window score of peak p of joint j in box b
      inside  (B, J, P) bool
      prn_out (B, gh, gw, 17)  PRN output grids
      x0, y0  (B, J, P) int32  grid cells
    """

    def __init__(self, model: PoseNet, cfg: Config):
        self.model = model
        self.gh, self.gw = cfg.model.prn_height, cfg.model.prn_width
        self.in_thres = cfg.prn.in_thres
        self.half = (cfg.prn.score_window - 1) // 2
        # under bf16 compute the PRN rounds its input grids to bf16 anyway,
        # so the grids are built in bf16, as the JAX package does
        # (multiposenet_tpu/engine/inference.py:381-384)
        self.grid_dt = (torch.bfloat16
                        if cfg.model.compute_dtype == torch.bfloat16
                        else torch.float32)
        dev = next(model.parameters()).device
        self.blur_y = torch.from_numpy(np.array(blur_matrix(self.gh, 1.0, "nearest"))
                                       ).to(dev, self.grid_dt)
        self.blur_x = torch.from_numpy(np.array(blur_matrix(self.gw, 1.0, "nearest"))
                                       ).to(dev, self.grid_dt)

    @torch.no_grad()
    def __call__(self, peak_xy, peak_score, peak_valid, boxes_xywh, box_valid):
        if peak_score.dim() == 2:
            out = self(peak_xy[None], peak_score[None], peak_valid[None],
                       boxes_xywh[None], box_valid[None])
            return tuple(t[0] for t in out)
        gh, gw, half = self.gh, self.gw, self.half
        n, num_j, num_p = peak_score.shape
        num_b = boxes_xywh.shape[1]
        dev = peak_score.device

        box = boxes_xywh[:, :, None, None, :]                    # (N,B,1,1,4)
        bx, by, bw, bh = box.unbind(-1)
        px = peak_xy[:, None, :, :, 0]                           # (N,1,J,P)
        py = peak_xy[:, None, :, :, 1]
        t = self.in_thres
        inside = ((px > bx - bw * t) & (px < bx + bw * (1.0 + t)) &
                  (py > by - bh * t) & (py < by + bh * (1.0 + t)) &
                  peak_valid[:, None] & box_valid[:, :, None, None])  # (N,B,J,P)
        x0, y0 = _grid_coords(peak_xy[:, None], box, gh, gw)

        # marks: 1 in every cell holding an inside peak (min(count, 1))
        m = n * num_b
        nb_idx = torch.arange(m, device=dev).view(n, num_b, 1, 1)
        j_idx = torch.arange(num_j, device=dev).view(1, 1, num_j, 1)
        flat = (((nb_idx * gh + y0.long()) * gw + x0.long()) * num_j + j_idx)
        marks = torch.zeros(m * gh * gw * num_j, dtype=torch.float32, device=dev)
        marks.scatter_reduce_(0, flat.reshape(-1),
                              inside.reshape(-1).to(torch.float32), "amax")
        marks = marks.to(self.grid_dt).view(m, gh, gw * num_j)

        # separable gaussian blur (sigma 1, 'nearest') as two matmuls, (y,x,j)
        g1 = (self.blur_y @ marks).view(m * gh, gw, num_j)
        grids = (self.blur_x @ g1).view(m, gh, gw, num_j)

        prn_out = self.model.prn_forward(grids)                  # (M,gh,gw,J)

        # score each peak: sum of the PRN output over a clipped window
        y1 = (y0 - half).clamp(0, gh)
        y2 = (y0 + half + 1).clamp(0, gh)
        x1 = (x0 - half).clamp(0, gw)
        x2 = (x0 + half + 1).clamp(0, gw)
        ay = torch.arange(gh, device=dev)
        ax = torch.arange(gw, device=dev)
        ry = ((ay >= y1[..., None]) & (ay < y2[..., None])).float()  # (N,B,J,P,gh)
        cx = ((ax >= x1[..., None]) & (ax < x2[..., None])).float()  # (N,B,J,P,gw)
        prn_jyx = prn_out.float().view(n, num_b, gh, gw, num_j).permute(0, 1, 4, 2, 3)
        rows = ry @ prn_jyx                                       # (N,B,J,P,gw)
        ws = (rows * cx).sum(dim=-1)
        table = torch.where(inside, ws * peak_score[:, None], 0.0)
        return (table, inside, prn_out.view(n, num_b, gh, gw, num_j), x0, y0)


def make_prn_pipeline(model: PoseNet, cfg: Config) -> PRNPipeline:
    return PRNPipeline(model, cfg)
