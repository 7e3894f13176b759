"""The serving pipeline after the forward, in plain PyTorch and numpy: the
benchmark's frozen reference (published algorithm: LiMeng95/
MultiPoseNet.pytorch evaluate/tester.py, network/anchors.py, network/utils.py,
lib/nms).  Imports nothing of the program.

- RetinaNet anchors, box decoding and clipping;
- the candidate filter (score > 0.05), the top 100 and greedy NMS with the
  +1-pixel IoU, strict ``>``;
- heatmap peaks: 4-neighbour local maxima above 0.1, the top 32 per joint,
  a 5x5 window upsampled x4 by OpenCV's bicubic kernel (a = -0.75,
  replicate border) and its argmax;
- the PRN stage: person grids of peak marks, a gaussian blur (sigma 1,
  'nearest'), the PRN, per-peak 15x15 window sums;
- the greedy mutual-best assignment of peaks to people (tester.py:333-513)
  and the result rows.

The float32 arithmetic of decoding, IoU and grid cells is written in the
order the published code evaluates it, so that the same float32 inputs give
the same boxes, keep masks and cells.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

NUM_JOINTS_17 = 17
# 18-joint model output -> 17 joints: the synthesized neck (joint 1) dropped
NECK_DROP = [0] + list(range(2, 18))
BBOX_STD = (0.1, 0.1, 0.2, 0.2)


# ---------------------------------------------------------------- anchors

def anchors(hw, levels=(3, 4, 5, 6, 7), ratios=(0.5, 1.0, 2.0),
            scales=(1.0, 2 ** (1 / 3), 2 ** (2 / 3))) -> np.ndarray:
    """(A, 4) float32 x1y1x2y2 anchors of an (H, W) input, level by level,
    location-major and anchor-minor (network/anchors.py)."""
    out = []
    for lv in levels:
        size, stride = 2 ** (lv + 2), 2 ** lv
        base = []
        for r in ratios:
            for s in scales:
                area = (size * s) ** 2
                w = math.sqrt(area / r)
                h = w * r
                base.append((-0.5 * w, -0.5 * h, 0.5 * w, 0.5 * h))
        base = np.array(base)
        fh = (hw[0] + stride - 1) // stride
        fw = (hw[1] + stride - 1) // stride
        sx, sy = np.meshgrid((np.arange(fw) + 0.5) * stride,
                             (np.arange(fh) + 0.5) * stride)
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
        out.append((shifts[:, None] + base[None]).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


def _exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).float()


def decode(anc: torch.Tensor, deltas: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Regression deltas (..., A, 4) -> clipped x1y1x2y2 boxes."""
    aw = anc[..., 2] - anc[..., 0]
    ah = anc[..., 3] - anc[..., 1]
    cx = anc[..., 0] + 0.5 * aw
    cy = anc[..., 1] + 0.5 * ah
    px = cx + deltas[..., 0] * BBOX_STD[0] * aw
    py = cy + deltas[..., 1] * BBOX_STD[1] * ah
    pw = _exp(deltas[..., 2] * BBOX_STD[2]) * aw
    ph = _exp(deltas[..., 3] * BBOX_STD[3]) * ah
    return torch.stack([(px - 0.5 * pw).clamp(min=0.0),
                        (py - 0.5 * ph).clamp(min=0.0),
                        (px + 0.5 * pw).clamp(max=float(w)),
                        (py + 0.5 * ph).clamp(max=float(h))], dim=-1)


def iou_plus1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]) + 1.0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]) + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4), zeros where not kept
    scores: torch.Tensor   # (B, K), -1 where not kept
    indices: torch.Tensor  # (B, K) anchor index, -1 where not kept
    keep: torch.Tensor     # (B, K) bool


def detections(cls: torch.Tensor, reg: torch.Tensor, anc: torch.Tensor,
               h: int, w: int, score_thresh=0.05, k=100,
               iou_thresh=0.5) -> Detections:
    """Scores (B, A, 1) in their own dtype and deltas (B, A, 4) -> the
    kept top-k boxes.  The threshold is rounded to the scores' dtype, as
    the published code compares a bf16 array with a Python scalar."""
    scores = cls.amax(dim=2)
    thr = float(torch.tensor(score_thresh, dtype=scores.dtype))
    masked = torch.where(scores > thr, scores, float("-inf"))
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    boxes = decode(anc[None], reg.float(), h, w)
    tb = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    valid = top > float("-inf")
    over = iou_plus1(tb, tb) > iou_thresh
    suppressed = torch.zeros_like(valid)
    for i in range(tb.shape[1]):
        alive = valid[:, i] & ~suppressed[:, i]
        suppressed[:, i + 1:] |= over[:, i, i + 1:] & alive[:, None]
    keep = valid & ~suppressed
    return Detections(torch.where(keep[..., None], tb, 0.0),
                      torch.where(keep, top, -1.0),
                      torch.where(keep, idx, -1), keep)


# ---------------------------------------------------------------- peaks

def _cubic(d: float, a: float = -0.75) -> float:
    d = abs(d)
    if d <= 1.0:
        return (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0
    if d < 2.0:
        return a * (d ** 3 - 5.0 * d ** 2 + 8.0 * d - 4.0)
    return 0.0


def upsample_matrix(src: int, f: int) -> np.ndarray:
    """(src * f, src) OpenCV INTER_CUBIC resize along one axis."""
    m = np.zeros((src * f, src))
    for j in range(src * f):
        s = (j + 0.5) / f - 0.5
        base = math.floor(s)
        t = s - base
        for tap, d in zip((base - 1, base, base + 1, base + 2),
                          (t + 1.0, t, 1.0 - t, 2.0 - t)):
            m[j, min(max(tap, 0), src - 1)] += _cubic(d)
    return m


class Peaks(NamedTuple):
    valid: torch.Tensor   # (B, J, P) bool
    up: torch.Tensor      # (B, J, P, s*f, s*f) float64 upsampled windows
    win_xy: torch.Tensor  # (B, J, P, 2) window start (x, y) in heatmap cells


def peaks(heat: torch.Tensor, thre=0.1, max_peaks=32, f=4, win=2) -> Peaks:
    """(B, H, W, J) heatmaps -> the top ``max_peaks`` local maxima per
    joint with their upsampled windows, in float64."""
    b, h, w, nj = heat.shape
    hm = heat.permute(0, 3, 1, 2).float()
    pad = torch.nn.functional.pad(hm, (1, 1, 1, 1), value=float("-inf"))
    nb = torch.maximum(torch.maximum(pad[:, :, :-2, 1:-1], pad[:, :, 2:, 1:-1]),
                       torch.maximum(pad[:, :, 1:-1, :-2], pad[:, :, 1:-1, 2:]))
    is_peak = (hm >= nb) & (hm > thre)
    flat = torch.where(is_peak, hm, -1.0).reshape(b, nj, h * w)
    top, idx = torch.sort(flat, dim=2, descending=True, stable=True)
    top, idx = top[..., :max_peaks], idx[..., :max_peaks]
    py, px = idx // w, idx % w
    s = 2 * win + 1
    wy = (py - win).clamp(0, h - s)
    wx = (px - win).clamp(0, w - s)
    ar = torch.arange(s, device=heat.device)
    cell = ((wy[..., None, None] + ar[:, None]) * w
            + wx[..., None, None] + ar[None, :]).reshape(b, nj, -1)
    patches = torch.gather(hm.reshape(b, nj, h * w), 2, cell).reshape(
        b, nj, max_peaks, s, s).double()
    m = torch.from_numpy(upsample_matrix(s, f)).to(heat.device)
    return Peaks(top > thre, (m @ patches) @ m.t(),
                 torch.stack([wx, wy], dim=-1))


def peak_coords(pk: Peaks, f: int) -> torch.Tensor:
    """(B, J, P, 2) refined [x, y] of each peak in input pixels: the
    window's start times ``f`` plus the first maximum of its upsampled
    window."""
    sf = pk.up.shape[-1]
    i = pk.up.flatten(-2).argmax(-1)
    return pk.win_xy * f + torch.stack([i % sf, i // sf], dim=-1)


# ---------------------------------------------------------------- PRN stage

def blur_matrix(n: int, sigma: float = 1.0, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d along one axis, mode 'nearest'."""
    r = int(truncate * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    g = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, kv in enumerate(k):
            g[i, min(max(i + t - r, 0), n - 1)] += kv
    return g


def grid_cells(pxy: torch.Tensor, box: torch.Tensor, gh: int, gw: int):
    """Peak (..., 2) in a box (..., 4) xywh -> its (x0, y0) grid cell of the
    person crop, truncated toward zero and clamped (tester.py:374-391)."""
    xs = torch.full_like(box[..., 2], float(gw)) / torch.ceil(box[..., 2])
    ys = torch.full_like(box[..., 3], float(gh)) / torch.ceil(box[..., 3])
    fx = torch.trunc((pxy[..., 0] - box[..., 0]) * xs)
    fy = torch.trunc((pxy[..., 1] - box[..., 1]) * ys)
    return (torch.nan_to_num(fx, nan=0.0).clamp(0, gw - 1).to(torch.int32),
            torch.nan_to_num(fy, nan=0.0).clamp(0, gh - 1).to(torch.int32))


class PRNStage(NamedTuple):
    table: torch.Tensor   # (N, B, J, P) window score of each peak in each box
    inside: torch.Tensor  # (N, B, J, P) bool
    prn_out: torch.Tensor  # (N, B, gh, gw, J)
    x0: torch.Tensor
    y0: torch.Tensor


def prn_stage(prn_run, pxy, pvalid, xywh, bvalid, gh: int, gw: int,
              in_thres=0.21, window=15) -> PRNStage:
    """Peaks (N, J, P, 2) + validity and boxes (N, B, 4) + validity ->
    the PRN's outputs and the per-peak window sums, float32."""
    n, nj, npk = pvalid.shape
    nb = xywh.shape[1]
    dev = pvalid.device
    box = xywh[:, :, None, None, :]
    bx, by, bw, bh = box.unbind(-1)
    px, py = pxy[:, None, ..., 0], pxy[:, None, ..., 1]
    t = in_thres
    inside = ((px > bx - bw * t) & (px < bx + bw * (1.0 + t)) &
              (py > by - bh * t) & (py < by + bh * (1.0 + t)) &
              pvalid[:, None] & bvalid[:, :, None, None])
    x0, y0 = grid_cells(pxy[:, None], box, gh, gw)
    marks = torch.zeros(n, nb, gh, gw, nj, device=dev)
    ni, bi, ji, pi = torch.nonzero(inside, as_tuple=True)
    marks[ni, bi, y0[ni, bi, ji, pi].long(), x0[ni, bi, ji, pi].long(), ji] = 1.0
    by_ = torch.from_numpy(blur_matrix(gh)).to(dev)
    bx_ = torch.from_numpy(blur_matrix(gw)).to(dev)
    grids = torch.einsum("yv,nbvxj->nbyxj", by_, marks)
    grids = torch.einsum("xu,nbyuj->nbyxj", bx_, grids)
    prn_out = prn_run(grids.reshape(n * nb, gh, gw, nj)).reshape(n, nb, gh, gw, nj)
    table = window_table(prn_out.float(), x0, y0, inside, pvalid, window)
    return PRNStage(table, inside, prn_out, x0, y0)


def window_table(prn_out, x0, y0, inside, pvalid, window=15) -> torch.Tensor:
    """(N, B, J, P) sums of each person's PRN output (N, B, gh, gw, J) over
    the ``window`` x ``window`` cells around each peak's cell, clipped to
    the grid, signed by the peak's validity; 0 where a peak is not in the
    box."""
    gh, gw = prn_out.shape[2], prn_out.shape[3]
    dev = prn_out.device
    half = (window - 1) // 2
    ay = torch.arange(gh, device=dev)
    ax = torch.arange(gw, device=dev)
    ry = ((ay >= (y0 - half).clamp(0, gh)[..., None])
          & (ay < (y0 + half + 1).clamp(0, gh)[..., None])).float()
    cx = ((ax >= (x0 - half).clamp(0, gw)[..., None])
          & (ax < (x0 + half + 1).clamp(0, gw)[..., None])).float()
    ws = torch.einsum("nbjpy,nbyxj,nbjpx->nbjp", ry, prn_out, cx)
    score = torch.where(pvalid, 1.0, -1.0)
    return torch.where(inside, ws * score[:, None], 0.0)


# ---------------------------------------------------------------- grouping

def group(score_table, inside, cell_x, cell_y, prn_out, peak_xy, boxes_xywh
          ) -> List[Dict]:
    """One image's greedy mutual-best assignment (tester.py:333-513) ->
    result rows with 17 (x, y, v) keypoints.  When peaks of a joint fall
    into one grid cell of a person the last one counts (tester.py:393); a
    joint type with no scored peak fills every person's unmarked joints from
    the PRN argmax with v = 0 (tester.py:461-483)."""
    num_b = boxes_xywh.shape[0]
    num_p = peak_xy.shape[1]
    if num_b == 0:
        return []
    gh, gw = prn_out.shape[1:3]
    active = np.array(inside, bool)
    for b in range(num_b):
        for j in range(NUM_JOINTS_17):
            seen = {}
            for p in range(num_p):
                if active[b, j, p]:
                    seen[(int(cell_y[b, j, p]), int(cell_x[b, j, p]))] = p
            keep = set(seen.values())
            for p in range(num_p):
                if active[b, j, p] and p not in keep:
                    active[b, j, p] = False
    table = np.where(active, np.array(score_table, np.float64), 0.0)
    kps = np.zeros((num_b, NUM_JOINTS_17, 3))
    for j in range(NUM_JOINTS_17):
        if active[:, j, :].any():
            ids = sorted({p for p in range(num_p) if active[:, j, p].any()})
            sub = np.stack([table[:, j, p] * active[:, j, p] for p in ids], 1)
            for b in range(num_b):
                row = np.argsort(-sub[b], kind="stable")
                if sub[b, row[0]] <= 0:
                    continue
                for r in row:
                    if sub[b, r] <= 0:
                        break
                    column = np.argsort(-sub[:, r], kind="stable")
                    # the competitor's row ascending, zeros included
                    # (tester.py:477); ties go to the first index
                    row2 = np.argsort(sub[column[0]], kind="stable")
                    if column[0] == b or row2[0] == r:
                        p = ids[r]
                        kps[b, j] = [peak_xy[j, p, 0], peak_xy[j, p, 1], 1]
                        break
        else:
            for b in range(num_b):
                bw, bh = boxes_xywh[b, 2], boxes_xywh[b, 3]
                xs = float(gw) / math.ceil(bw) if bw > 0 else 1.0
                ys = float(gh) / math.ceil(bh) if bh > 0 else 1.0
                for t in range(NUM_JOINTS_17):
                    if active[b, t, :].any():
                        continue
                    my, mx = np.unravel_index(np.argmax(prn_out[b, :, :, t]),
                                              (gh, gw))
                    kps[b, t] = [mx / xs + boxes_xywh[b, 0],
                                 my / ys + boxes_xywh[b, 1], 0]
    rows = []
    for b in range(num_b):
        rows.append({"bbox": [float(v) for v in boxes_xywh[b]],
                     "score": float(kps[b, :, 2].sum()) / NUM_JOINTS_17,
                     "keypoints": kps[b].reshape(-1).tolist()})
    return rows
