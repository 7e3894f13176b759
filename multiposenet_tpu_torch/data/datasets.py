"""COCO dataset readers for the three training stages — the port's copy
of multiposenet_tpu/data/datasets.py, reading images with
``data/image_io.read_image`` and augmenting with ``data/augment`` (no cv2
for PNG files).

Keypoint records come from the Realtime-Multi-Person-style ``COCO.json``
index (reference datasets/coco.py:17-36: {'root': [records]}, minival split
by ``isValidation``); detection and PRN read standard COCO person_keypoints
jsons through ``data/coco_json.COCOIndex`` (no pycocotools).

The datasets emit compact arrays (padded joints, padded boxes, sparse PRN
marks) and the train steps build the dense targets on the device
(engine/train_steps.py).  Each takes ``__getitem__(index, rng)`` with an
``np.random.Generator`` for the augmentation.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from multiposenet_tpu_torch.config import Config, DataConfig
from multiposenet_tpu_torch.data.augment import (
    BBoxSample,
    KeypointSample,
    augment_bbox_sample,
    augment_keypoint_sample,
    boxes_from_masks,
    pad_boxes,
    remove_illegal_joints,
)
from multiposenet_tpu_torch.data.coco_json import COCOIndex
from multiposenet_tpu_torch.data.image_io import IMREAD_GRAYSCALE, read_image
from multiposenet_tpu_torch.data.imgproc import resize_cubic
from multiposenet_tpu_torch.data.rle import ann_to_mask

# COCO 17 -> internal 18-joint order with synthesized neck at index 1
# (reference COCO_data_pipeline.py:123-174)
OUR_ORDER_18 = [0, 17, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3]
# 17-joint permutation of the PRN dataset (reference prn_data_pipeline.py:108)
OUR_ORDER_17 = [0, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3]


def add_neck(joints17: np.ndarray) -> np.ndarray:
    """(..., 17, 3) COCO joints -> (..., 18, 3) internal order with neck.

    Neck = rounded midpoint of the shoulders; visibility rules per reference
    COCO_data_pipeline.py:137-151.
    """
    joints17 = np.asarray(joints17, np.float64)
    rs = joints17[..., 6, :]
    ls = joints17[..., 5, :]
    neck = (rs + ls) / 2.0
    v = np.where((rs[..., 2] == 2) | (ls[..., 2] == 2), 2.0,
                 np.where((rs[..., 2] == 1) | (ls[..., 2] == 1), 1.0,
                          rs[..., 2] * ls[..., 2]))
    neck = np.round(np.concatenate([neck[..., :2], v[..., None]], axis=-1))
    out = np.concatenate([joints17, neck[..., None, :]], axis=-2)
    return out[..., OUR_ORDER_18, :].astype(np.float32)


def load_coco_json_index(json_path: str) -> List[Dict]:
    with open(json_path) as f:
        return json.load(f)["root"]


def split_keypoint_records(records: List[Dict], training: bool) -> List[int]:
    """minival split by isValidation (reference datasets/coco.py:24-29)."""
    if training:
        return [i for i, r in enumerate(records) if r["isValidation"] == 0.0]
    return [i for i, r in enumerate(records) if r["isValidation"] != 0.0]


def _no_jitter(cfg: DataConfig) -> DataConfig:
    """The validation path's augmentation: scale only, no jitter."""
    return dataclasses.replace(cfg, scale_prob=-1.0, max_rotate_degree=0.0,
                               center_perturb_max=0.0, flip_prob=-1.0)


class KeypointDataset:
    """Cocokeypoints equivalent (reference COCO_data_pipeline.py:73-294).

    ``__getitem__`` -> dict with
      image  (S, S, 3) uint8 RGB
      joints (max_people, 18, 3) float32, padding rows have v=2
      mask   (S/stride, S/stride) float32 mask_miss in [0, 1]
    """

    def __init__(self, records: List[Dict], index_list: List[int],
                 data_dir: str, mask_dir: str, cfg: DataConfig,
                 augment: bool = True):
        self.records = records
        self.index_list = index_list
        self.data_dir = data_dir
        self.mask_dir = mask_dir
        self.cfg = cfg
        self.augment = augment

    def __len__(self):
        return len(self.index_list)

    def _load_mask_miss(self, rec: Dict) -> np.ndarray:
        img_idx = rec["img_paths"][-16:-3]
        split = "val2014" if "COCO_val" in rec["dataset"] else "train2014"
        p = os.path.join(self.mask_dir, "mask2014",
                         f"{split}_mask_miss_{img_idx}png")
        m = read_image(p, IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(p)
        return m

    def _joints_all(self, rec: Dict) -> Tuple[np.ndarray, np.ndarray, float]:
        self_j = np.asarray(rec["joint_self"], np.float32).reshape(17, 3)
        others = np.asarray(rec["joint_others"], np.float32)
        nop = int(rec["numOtherPeople"])
        if nop == 0:
            others = np.zeros((0, 17, 3), np.float32)
        else:
            others = others.reshape(nop, 17, 3)
        joints17 = np.concatenate([self_j[None], others], axis=0)
        joints = add_neck(joints17)
        objpos = np.asarray(rec["objpos"], np.float64).copy()
        return joints, objpos, float(rec["scale_provided"])

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng()
        rec = self.records[self.index_list[index]]
        path = os.path.join(self.data_dir, rec["img_paths"])
        img = read_image(path)
        if img is None:
            raise FileNotFoundError(path)
        mask_miss = self._load_mask_miss(rec)
        joints, objpos, scale_provided = self._joints_all(rec)

        s = KeypointSample(img=img, mask_miss=mask_miss, joints=joints,
                           objpos=objpos, scale_provided=scale_provided)
        if self.augment:
            s = augment_keypoint_sample(s, self.cfg, rng)
        else:
            # deterministic centre-crop path for val: scale only, no jitter
            s = augment_keypoint_sample(s, _no_jitter(self.cfg),
                                        np.random.default_rng(0))

        joints = remove_illegal_joints(s.joints, self.cfg.inp_size)

        stride = self.cfg.feat_stride
        mask = resize_cubic(s.mask_miss, 1.0 / stride).astype(np.float32) / 255.0

        maxp = self.cfg.max_people
        jp = np.full((maxp, 18, 3), (1.0, 1.0, 2.0), np.float32)
        n = min(len(joints), maxp)
        jp[:n] = joints[:n]

        return {
            "image": s.img[:, :, ::-1].copy(),  # BGR -> RGB
            "joints": jp,
            "mask": mask,
        }


class DetectionDataset:
    """Cocobbox equivalent (reference COCO_data_pipeline.py:296-442).

    ``__getitem__`` -> {'image': (S,S,3) u8 RGB, 'boxes': (max_gt, 5) f32
    pad -1}.  Records whose image file is missing are left out.
    """

    def __init__(self, records: List[Dict], index_list: List[int],
                 coco: COCOIndex, img_root: str, cfg: DataConfig,
                 augment: bool = True):
        self.records = records
        self.cfg = cfg
        self.augment = augment
        self.items = []
        for idx in index_list:
            rec = records[idx]
            info = coco.load_imgs(int(rec["image_id"]))[0]
            path = os.path.join(img_root, info["file_name"])
            if not os.path.exists(path):
                continue
            anns = coco.load_anns(coco.get_ann_ids(int(rec["image_id"])))
            self.items.append({
                "path": path, "anns": anns,
                "height": info["height"], "width": info["width"],
                "objpos": np.asarray(rec["objpos"], np.float64),
                "scale_provided": float(rec["scale_provided"]),
            })

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng()
        it = self.items[index]
        img = read_image(it["path"])
        if img is None:
            raise FileNotFoundError(it["path"])
        masks, classes = [], []
        for ann in it["anns"]:
            m = ann_to_mask(ann, it["height"], it["width"])
            if m.max() < 1:
                continue
            if ann.get("iscrowd"):
                classes.append(-1)
                if m.shape != (it["height"], it["width"]):
                    m = np.ones((it["height"], it["width"]), np.uint8)
            else:
                classes.append(0)
            masks.append(m)

        s = BBoxSample(img=img, masks=masks, classes=classes,
                       objpos=it["objpos"].copy(),
                       scale_provided=it["scale_provided"])
        if self.augment:
            s = augment_bbox_sample(s, self.cfg, rng)
        else:
            s = augment_bbox_sample(s, _no_jitter(self.cfg),
                                    np.random.default_rng(0))

        boxes = boxes_from_masks(s.masks, s.classes)
        return {
            "image": s.img[:, :, ::-1].copy(),
            "boxes": pad_boxes(boxes, self.cfg.max_gt_boxes),
        }


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
