"""Host formatting of grouped people — numpy twin of ``format_assignment``,
``drop_neck_reindex`` and ``to_coco_order`` in
multiposenet_tpu/eval/grouping.py (reference tester.py:137, 163-177,
195-254, 461-483).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

NUM_COCO_JOINTS = 17


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
