"""Host grouping and formatting of people — the port of
multiposenet_tpu/eval/grouping.py (reference tester.py:137, 163-177,
195-254, 333-513): ``group_peaks``, the reference's greedy assignment on
the host (the evaluator's ``prn.device_grouping=False`` path), and the
formatting of the device assignment, ``format_assignment``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

NUM_COCO_JOINTS = 17


def group_peaks(
    score_table: np.ndarray,   # (B, 17, P) peak-in-box window scores
    inside: np.ndarray,        # (B, 17, P) bool
    cell_x: np.ndarray,        # (B, 17, P) int grid cell of each peak per box
    cell_y: np.ndarray,
    prn_out: np.ndarray,       # (B, gh, gw, 17) PRN outputs
    peak_xy: np.ndarray,       # (17, P, 2) peak pixel coords
    peak_valid: np.ndarray,    # (17, P) bool
    boxes_xywh: np.ndarray,    # (B, 4) valid person boxes only
    file_name: str = "",
    image_id: int = 0,
) -> List[Dict]:
    """The reference's greedy mutual-best assignment (tester.py:333-513)
    -> result rows (image_id, category_id, bbox, score, keypoints x, y, v
    * 17 in the internal 17-joint order).  Its quirks stay: when peaks of
    one joint fall into one grid cell of a person, the last one is kept
    (numpy overwrite, tester.py:393); the competitor's row is sorted
    ascending, zeros included (tester.py:477); and a joint type with no
    scored peak anywhere fills every person's unmarked joints from the PRN
    argmax with v=0 (tester.py:461-483)."""
    num_b = boxes_xywh.shape[0]
    num_p = peak_xy.shape[1]
    if num_b == 0:
        return []

    gh, gw = prn_out.shape[1:3]

    # cell collisions: the last peak in a cell wins
    table = np.array(score_table, np.float64)
    active = np.array(inside, bool)
    for b in range(num_b):
        for j in range(NUM_COCO_JOINTS):
            seen = {}
            for p in range(num_p):
                if active[b, j, p]:
                    seen[(int(cell_y[b, j, p]), int(cell_x[b, j, p]))] = p
            keep = set(seen.values())
            for p in range(num_p):
                if active[b, j, p] and p not in keep:
                    active[b, j, p] = False
    table = np.where(active, table, 0.0)

    bbox_keypoints = np.zeros((num_b, NUM_COCO_JOINTS, 3))

    for j in range(NUM_COCO_JOINTS):
        if active[:, j, :].any():
            kp_ids = sorted({p for p in range(num_p) if active[:, j, p].any()})
            col_of = {p: i for i, p in enumerate(kp_ids)}
            sub = np.zeros((num_b, len(kp_ids)))
            for p in kp_ids:
                sub[:, col_of[p]] = table[:, j, p] * active[:, j, p]

            for b in range(num_b):
                row = np.argsort(-sub[b])
                if sub[b, row[0]] <= 0:
                    continue
                for r in row:
                    if sub[b, r] <= 0:
                        break
                    column = np.argsort(-sub[:, r])
                    if column[0] == b:
                        p = kp_ids[r]
                        bbox_keypoints[b, j] = [peak_xy[j, p, 0], peak_xy[j, p, 1], 1]
                        break
                    # among exact zero ties the pick is numpy's sort's (the
                    # device assignment, ops/grouping.py, pins the first)
                    row2 = np.argsort(sub[column[0]])
                    if row2[0] == r:
                        p = kp_ids[r]
                        bbox_keypoints[b, j] = [peak_xy[j, p, 0], peak_xy[j, p, 1], 1]
                        break
        else:
            # every joint of every person without a mark, v=0 (the
            # reference loops over all 17 here)
            for b in range(num_b):
                bw, bh = boxes_xywh[b, 2], boxes_xywh[b, 3]
                x_scale = float(gw) / math.ceil(bw) if bw > 0 else 1.0
                y_scale = float(gh) / math.ceil(bh) if bh > 0 else 1.0
                for t in range(NUM_COCO_JOINTS):
                    if active[b, t, :].any():
                        continue
                    fm = prn_out[b, :, :, t]
                    my, mx = np.unravel_index(np.argmax(fm), fm.shape)
                    bbox_keypoints[b, t] = [
                        mx / x_scale + boxes_xywh[b, 0],
                        my / y_scale + boxes_xywh[b, 1],
                        0,
                    ]

    results = []
    for b in range(num_b):
        k = np.zeros(NUM_COCO_JOINTS * 3)
        k[0::3] = bbox_keypoints[b, :, 0]
        k[1::3] = bbox_keypoints[b, :, 1]
        k[2::3] = bbox_keypoints[b, :, 2]
        results.append({
            "image_id": image_id,
            "file_name": file_name,
            "category_id": 1,
            "bbox": [float(v) for v in boxes_xywh[b]],
            "score": float(bbox_keypoints[b, :, 2].sum()) / NUM_COCO_JOINTS,
            "keypoints": k.tolist(),
        })
    return results


def format_assignment(
    chosen: np.ndarray,       # (B, 17) device-chosen peak slots, -1 none
    active_any: np.ndarray,   # (17,) joint type has any scored peak
    active: np.ndarray,       # (B, 17, P)
    fallback_xy: np.ndarray,  # (B, 17, 2)
    peak_xy: np.ndarray,      # (17, P, 2)
    boxes_xywh: np.ndarray,   # (B, 4)
    file_name: str = "",
    image_id: int = 0,
) -> List[Dict]:
    """Result dicts (the reference's prn_result rows) from the device
    assignment.  When a joint type has no scored peak anywhere, every
    person's joints without marks are filled from the PRN argmax with v=0
    (reference tester.py:461-483)."""
    num_b = boxes_xywh.shape[0]
    results = []
    any_empty_joint = bool((~active_any).any())
    for b in range(num_b):
        kp = np.zeros((NUM_COCO_JOINTS, 3))
        for j in range(NUM_COCO_JOINTS):
            p = int(chosen[b, j])
            if p >= 0:
                kp[j] = [peak_xy[j, p, 0], peak_xy[j, p, 1], 1]
            elif any_empty_joint and not active[b, j].any():
                kp[j] = [fallback_xy[b, j, 0], fallback_xy[b, j, 1], 0]
        k = np.zeros(NUM_COCO_JOINTS * 3)
        k[0::3], k[1::3], k[2::3] = kp[:, 0], kp[:, 1], kp[:, 2]
        results.append({
            "image_id": image_id,
            "file_name": file_name,
            "category_id": 1,
            "bbox": [float(v) for v in boxes_xywh[b]],
            "score": float(kp[:, 2].sum()) / NUM_COCO_JOINTS,
            "keypoints": k.tolist(),
        })
    return results


# 18-joint internal -> drop neck (joint 1) -> 17-joint internal order used by
# prn_process (reference tester.py:163-167: types > 1 shift down by one)
def drop_neck_reindex(joint_type_18: int) -> Optional[int]:
    if joint_type_18 == 1:
        return None
    return max(0, joint_type_18 - 1)


# internal 17-joint -> COCO keypoint order (reference tester.py:137)
COCO_ORDER = [0, 14, 13, 16, 15, 4, 1, 5, 2, 6, 3, 10, 7, 11, 8, 12, 9]


def to_coco_order(keypoints_51: Sequence[float]) -> List[float]:
    """Reorder a flattened 17x3 keypoint vector into COCO order
    (reference tester.py:171-177)."""
    out = []
    for i in range(NUM_COCO_JOINTS):
        out.extend(keypoints_51[COCO_ORDER[i] * 3: COCO_ORDER[i] * 3 + 3])
    return out
