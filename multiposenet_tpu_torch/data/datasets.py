"""Training datasets — the port's copy of the numpy-only part of
multiposenet_tpu/data/datasets.py: the PRN stage's dataset over a COCO
person_keypoints json (``data/coco_json.COCOIndex``, no pycocotools).

The keypoint and detection datasets of the JAX package decode and augment
images with cv2 and are not ported yet; the port's trainer takes any
iterable of batch dicts.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.data.coco_json import COCOIndex

# 17-joint permutation of the PRN dataset (reference prn_data_pipeline.py:108)
OUR_ORDER_17 = [0, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3]


class PRNDataset:
    """PRN_CocoDataset equivalent (reference prn_data_pipeline.py:10-123).

    Emits sparse one-hot mark grids; the gaussian blurs run on the device
    inside the train step.  ``__getitem__`` ->
      {'weights_marks': (gh, gw, 17) f32, 'label_marks': (gh, gw, 17) f32}
    both in the internal 17-joint order.  Annotations that are not crowds
    and have more than ``cfg.prn.min_num_keypoints`` keypoints are used,
    the most complete first.
    """

    def __init__(self, coco: COCOIndex, cfg: Config):
        self.coco = coco
        self.gh = cfg.model.prn_height
        self.gw = cfg.model.prn_width
        self.threshold = cfg.prn.in_thres
        anns = [a for a in coco.anns.values()
                if a.get("iscrowd", 0) == 0
                and a.get("num_keypoints", 0) > cfg.prn.min_num_keypoints]
        self.anns = sorted(anns, key=lambda a: a["num_keypoints"], reverse=True)

    def __len__(self):
        return len(self.anns)

    def _place(self, grid: np.ndarray, kpx, kpy, x, y, x_scale, y_scale, j):
        """The reference's clamped int placement (prn_data_pipeline.py:51-70)."""
        x0 = int((kpx - x) * x_scale)
        y0 = int((kpy - y) * y_scale)
        x0 = min(max(x0, 0), self.gw - 1)
        y0 = min(max(y0, 0), self.gh - 1)
        grid[y0, x0, j] = 1.0

    def __getitem__(self, item: int, rng=None) -> Dict[str, np.ndarray]:
        ann = self.anns[item]
        weights = np.zeros((self.gh, self.gw, 17), np.float32)
        label = np.zeros((self.gh, self.gw, 17), np.float32)

        bbox = ann["bbox"]
        x, y = int(bbox[0]), int(bbox[1])
        w, h = float(bbox[2]), float(bbox[3])
        x_scale = self.gw / math.ceil(w)
        y_scale = self.gh / math.ceil(h)

        kp = ann["keypoints"]
        for j in range(17):
            if kp[3 * j + 2] > 0:
                self._place(label, kp[3 * j], kp[3 * j + 1], x, y,
                            x_scale, y_scale, j)

        for other in self.coco.img_to_anns[ann["image_id"]]:
            okp = other.get("keypoints")
            if not okp:
                continue
            for j in range(17):
                if okp[3 * j + 2] > 0:
                    kx, ky = okp[3 * j], okp[3 * j + 1]
                    if (bbox[0] - bbox[2] * self.threshold < kx <
                            bbox[0] + bbox[2] * (1 + self.threshold) and
                            bbox[1] - bbox[3] * self.threshold < ky <
                            bbox[1] + bbox[3] * (1 + self.threshold)):
                        self._place(weights, kx, ky, x, y, x_scale, y_scale, j)

        return {
            "weights_marks": weights[:, :, OUR_ORDER_17],
            "label_marks": label[:, :, OUR_ORDER_17],
        }
