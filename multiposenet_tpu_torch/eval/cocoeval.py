"""COCO keypoint (OKS) evaluation — the port's copy of
multiposenet_tpu/eval/cocoeval.py (numpy), a self-contained COCOeval.

Implements the COCO keypoints protocol exactly as pycocotools.cocoeval
(which this framework does not depend on): per-image greedy matching of
detections to GT by OKS at thresholds 0.50:0.05:0.95, area ranges
all/medium/large, maxDets=20, 101-point interpolated precision, and the
standard 10-line AP/AR summary.  The reference drives pycocotools directly
(evaluate/tester.py:180-190); parity targets are README.md:38-51.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from multiposenet_tpu_torch.data.coco_json import COCOIndex

# per-joint OKS falloff constants (COCO keypoint order)
KPT_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72,
    .62, .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": [0 ** 2, 1e5 ** 2],
    "medium": [32 ** 2, 96 ** 2],
    "large": [96 ** 2, 1e5 ** 2],
}
MAX_DETS = 20


def compute_oks(dt_kps: np.ndarray, gt_kps: np.ndarray, gt_area: float,
                gt_bbox: Sequence[float]) -> float:
    """OKS between one detection and one GT (pycocotools computeOks)."""
    sigmas = KPT_SIGMAS
    k = len(sigmas)
    var = (sigmas * 2) ** 2
    xg, yg, vg = gt_kps[0::3], gt_kps[1::3], gt_kps[2::3]
    xd, yd = dt_kps[0::3], dt_kps[1::3]
    k1 = int((vg > 0).sum())
    if k1 > 0:
        dx = xd - xg
        dy = yd - yg
    else:
        # GT has no labeled keypoints: measure distance to the expanded bbox
        x0 = gt_bbox[0] - gt_bbox[2]
        x1 = gt_bbox[0] + gt_bbox[2] * 2
        y0 = gt_bbox[1] - gt_bbox[3]
        y1 = gt_bbox[1] + gt_bbox[3] * 2
        zeros = np.zeros(k)
        dx = np.maximum(zeros, x0 - xd) + np.maximum(zeros, xd - x1)
        dy = np.maximum(zeros, y0 - yd) + np.maximum(zeros, yd - y1)
    e = (dx ** 2 + dy ** 2) / var / (gt_area + np.spacing(1)) / 2
    if k1 > 0:
        e = e[vg > 0]
    return float(np.sum(np.exp(-e)) / e.shape[0]) if e.shape[0] else 0.0


class KeypointEval:
    """OKS evaluation over person category (category_id 1)."""

    def __init__(self, gt: COCOIndex, dt: COCOIndex,
                 img_ids: Optional[Sequence[int]] = None):
        self.gt = gt
        self.dt = dt
        self.img_ids = sorted(img_ids if img_ids is not None
                              else gt.get_img_ids(cat_ids=[1]))
        self.eval_imgs: Dict = {}
        self.results: Dict[str, float] = {}

    # -- per image -------------------------------------------------------

    def _evaluate_img(self, img_id: int, area_rng) -> Optional[Dict]:
        gts = [g for g in self.gt.img_to_anns.get(img_id, [])
               if g.get("category_id", 1) == 1]
        dts = [d for d in self.dt.img_to_anns.get(img_id, [])
               if d.get("category_id", 1) == 1]
        if not gts and not dts:
            return None

        for g in gts:
            ignore = g.get("ignore", 0) or g.get("iscrowd", 0) or \
                g.get("num_keypoints", 0) == 0 or \
                not (area_rng[0] <= g["area"] <= area_rng[1])
            g["_ignore"] = 1 if ignore else 0

        # sort gts: non-ignored first; dts by score desc, truncate maxDets
        gt_order = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
        gts = [gts[i] for i in gt_order]
        dts = sorted(dts, key=lambda d: -d["score"])[:MAX_DETS]

        # OKS matrix (computed only for non-empty gt sets)
        ious = np.zeros((len(dts), len(gts)))
        for di, d in enumerate(dts):
            dkp = np.asarray(d["keypoints"], np.float64)
            for gi, g in enumerate(gts):
                ious[di, gi] = compute_oks(
                    dkp, np.asarray(g["keypoints"], np.float64),
                    g["area"], g["bbox"])

        num_t = len(IOU_THRS)
        gtm = np.zeros((num_t, len(gts)), dtype=np.int64) - 1
        dtm = np.zeros((num_t, len(dts)), dtype=np.int64) - 1
        gt_ig = np.array([g["_ignore"] for g in gts])
        crowd = np.array([int(g.get("iscrowd", 0)) for g in gts], np.int64)
        dt_ig = np.zeros((num_t, len(dts)))

        for ti, t in enumerate(IOU_THRS):
            for di, d in enumerate(dts):
                iou = min(t, 1 - 1e-10)
                m = -1
                for gi, g in enumerate(gts):
                    # a matched gt is off the table UNLESS it is a crowd —
                    # crowd gts absorb any number of detections
                    # (pycocotools evaluateImg: "if this gt already
                    # matched, and not a crowd, continue"); crowd anns
                    # usually carry 0 keypoints, so their expanded-bbox
                    # OKS is 1.0 for any detection inside the region and
                    # this branch decides FP-vs-ignored for every extra
                    # detection in a crowd
                    if gtm[ti, gi] >= 0 and not crowd[gi]:
                        continue
                    # stop at ignored gts once a real match was found
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                        break
                    if ious[di, gi] < iou:
                        continue
                    iou = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ig[m]
                dtm[ti, di] = m
                gtm[ti, m] = di

        # unmatched dts outside the area range are ignored
        a = np.array([
            d.get("area", d["bbox"][2] * d["bbox"][3]) < area_rng[0] or
            d.get("area", d["bbox"][2] * d["bbox"][3]) > area_rng[1]
            for d in dts]) if dts else np.zeros(0, bool)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == -1, np.tile(a, (num_t, 1))))

        return {
            "dt_scores": np.array([d["score"] for d in dts]),
            "dtm": dtm,
            "dt_ignore": dt_ig,
            "num_gt": int((gt_ig == 0).sum()),
        }

    # -- accumulate ------------------------------------------------------

    def _accumulate(self, per_img: List[Optional[Dict]]) -> np.ndarray:
        """-> precision (T, R) and recall (T,) arrays."""
        num_t = len(IOU_THRS)
        num_r = len(REC_THRS)
        per_img = [e for e in per_img if e is not None]
        if not per_img:
            return -np.ones((num_t, num_r)), -np.ones(num_t)

        scores = np.concatenate([e["dt_scores"] for e in per_img])
        order = np.argsort(-scores, kind="mergesort")
        dtm = np.concatenate([e["dtm"] for e in per_img], axis=1)[:, order]
        dt_ig = np.concatenate([e["dt_ignore"] for e in per_img], axis=1)[:, order]
        npig = sum(e["num_gt"] for e in per_img)
        if npig == 0:
            return -np.ones((num_t, num_r)), -np.ones(num_t)

        tps = np.logical_and(dtm >= 0, np.logical_not(dt_ig))
        fps = np.logical_and(dtm < 0, np.logical_not(dt_ig))
        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

        precision = -np.ones((num_t, num_r))
        recall = -np.ones(num_t)
        for ti in range(num_t):
            tp, fp = tp_sum[ti], fp_sum[ti]
            nd = len(tp)
            rc = tp / npig
            pr = tp / (fp + tp + np.spacing(1))
            recall[ti] = rc[-1] if nd else 0
            # make precision monotonically decreasing
            pr = pr.tolist()
            for i in range(nd - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds = np.searchsorted(rc, REC_THRS, side="left")
            q = np.zeros(num_r)
            for ri, pi in enumerate(inds):
                if pi < nd:
                    q[ri] = pr[pi]
            precision[ti] = q
        return precision, recall

    # -- public API ------------------------------------------------------

    def evaluate(self) -> Dict[str, float]:
        res = {}
        for area_name, area_rng in AREA_RNGS.items():
            per_img = [self._evaluate_img(i, area_rng) for i in self.img_ids]
            precision, recall = self._accumulate(per_img)

            def ap(thr=None):
                p = precision if thr is None else precision[np.isclose(IOU_THRS, thr)]
                p = p[p > -1]
                return float(np.mean(p)) if p.size else -1.0

            def ar(thr=None):
                r = recall if thr is None else recall[np.isclose(IOU_THRS, thr)]
                r = r[r > -1]
                return float(np.mean(r)) if r.size else -1.0

            if area_name == "all":
                res["AP"] = ap()
                res["AP50"] = ap(0.5)
                res["AP75"] = ap(0.75)
                res["AR"] = ar()
                res["AR50"] = ar(0.5)
                res["AR75"] = ar(0.75)
            else:
                res[f"AP_{area_name}"] = ap()
                res[f"AR_{area_name}"] = ar()
        self.results = res
        return res

    def summarize(self) -> str:
        r = self.results or self.evaluate()
        rows = [
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets= 20 ]", r["AP"]),
            ("Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets= 20 ]", r["AP50"]),
            ("Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets= 20 ]", r["AP75"]),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets= 20 ]", r["AP_medium"]),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets= 20 ]", r["AP_large"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 20 ]", r["AR"]),
            ("Average Recall     (AR) @[ IoU=0.50      | area=   all | maxDets= 20 ]", r["AR50"]),
            ("Average Recall     (AR) @[ IoU=0.75      | area=   all | maxDets= 20 ]", r["AR75"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets= 20 ]", r["AR_medium"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets= 20 ]", r["AR_large"]),
        ]
        return "\n".join(f" {name} = {val:0.3f}" for name, val in rows)
