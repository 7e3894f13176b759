"""Minimal COCO annotation index — the port's copy of
multiposenet_tpu/data/coco_json.py (pure Python), standing in for
pycocotools.coco.COCO.

It covers what the evaluator needs: ann/img lookup by id,
category-filtered image ids, and loading result lists for evaluation
(reference evaluate/tester.py:132-185).
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union


class COCOIndex:
    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[Dict] = None):
        if annotation_file is not None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset or {}
        self._build()

    def _build(self):
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.cats: Dict[int, Dict] = {}
        self.img_to_anns = defaultdict(list)
        self.cat_to_imgs = defaultdict(set)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
            if "category_id" in ann:
                self.cat_to_imgs[ann["category_id"]].add(ann["image_id"])

    # --- pycocotools-compatible accessors --------------------------------

    def get_img_ids(self, cat_ids: Sequence[int] = ()) -> List[int]:
        if not cat_ids:
            return sorted(self.imgs.keys())
        ids = None
        for c in cat_ids:
            s = self.cat_to_imgs[c]
            ids = s if ids is None else (ids & s)
        return sorted(ids or ())

    def get_ann_ids(self, img_ids: Union[int, Sequence[int], None] = None,
                    cat_ids: Sequence[int] = ()) -> List[int]:
        if img_ids is None:
            anns = list(self.anns.values())
        else:
            if isinstance(img_ids, int):
                img_ids = [img_ids]
            anns = [a for i in img_ids for a in self.img_to_anns[i]]
        if cat_ids:
            anns = [a for a in anns if a.get("category_id") in set(cat_ids)]
        return [a["id"] for a in anns]

    def load_anns(self, ids: Union[int, Sequence[int]]) -> List[Dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def load_imgs(self, ids: Union[int, Sequence[int]]) -> List[Dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    # camelCase aliases (drop-in for reference call sites)
    getImgIds = lambda self, catIds=(), **kw: self.get_img_ids(catIds)  # noqa: E731
    getAnnIds = lambda self, imgIds=None, catIds=(), **kw: self.get_ann_ids(imgIds, catIds)  # noqa: E731
    loadAnns = load_anns
    loadImgs = load_imgs
    # loadRes alias is defined after load_res below

    def load_res(self, results: Union[str, List[Dict]]) -> "COCOIndex":
        """Build a result index sharing this gt's image table.

        Exact transcription of pycocotools ``COCO.loadRes`` (cocoapi
        PythonAPI/pycocotools/coco.py) for box/keypoint result lists — the
        tool the reference scores with (evaluate/tester.py:184).  The
        branch is chosen ONCE from the FIRST result dict (pycocotools
        tests ``anns[0]``) and applied to the whole list:

        1. ``'bbox' in anns[0] and anns[0]['bbox'] != []`` — the branch the
           reference's own results take (its result dicts always carry the
           person detection box, tester.py:503-510): ``area`` is OVERWRITTEN
           with bbox w*h, a rectangle ``segmentation`` is synthesized, and
           ``iscrowd`` is forced to 0.
        2. otherwise ``'keypoints' in anns[0]`` — ``bbox``/``area`` are
           OVERWRITTEN with the x/y extents over ALL keypoint triples
           INCLUDING unlabeled (v=0) slots at (0, 0); this is what
           pycocotools does even though zeros drag the extent to the image
           origin.  A mixed list whose first dict lacks ``bbox`` takes this
           branch for EVERY dict, exactly like pycocotools.

        ``id`` is always overwritten with the 1-based enumeration index.
        Deviations (both documented, neither observable through the
        returned index on well-formed inputs): pycocotools mutates the
        caller's dicts in place, here they are copied; and an EMPTY result
        list returns an empty index where pycocotools raises IndexError
        probing ``anns[0]``.
        """
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        assert isinstance(results, list), "results must be a list of dicts"
        bad = {r["image_id"] for r in results} - set(self.imgs)
        assert not bad, f"results reference unknown image ids: {sorted(bad)[:5]}"

        bbox_branch = bool(results) and "bbox" in results[0] \
            and results[0]["bbox"] != []
        anns = []
        for i, r in enumerate(results):
            ann = dict(r)
            if bbox_branch:
                bb = ann["bbox"]
                x1, x2, y1, y2 = bb[0], bb[0] + bb[2], bb[1], bb[1] + bb[3]
                if "segmentation" not in ann:
                    ann["segmentation"] = [[x1, y1, x1, y2, x2, y2, x2, y1]]
                ann["area"] = bb[2] * bb[3]
                ann["id"] = i + 1
                ann["iscrowd"] = 0
            elif "keypoints" in results[0]:
                kp = ann["keypoints"]
                xs = kp[0::3]
                ys = kp[1::3]
                x0, x1 = min(xs), max(xs)
                y0, y1 = min(ys), max(ys)
                ann["area"] = (x1 - x0) * (y1 - y0)
                ann["id"] = i + 1
                ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
            else:
                raise ValueError("result dicts must carry 'bbox' or 'keypoints'")
            anns.append(ann)

        return COCOIndex(dataset={
            "images": list(self.imgs.values()),
            "categories": copy.deepcopy(self.dataset.get("categories", [])),
            "annotations": anns,
        })

    loadRes = load_res
