"""Build the keypoint stage's index (``COCO.json``) and its mask_miss PNGs
from standard COCO annotations, without cv2 — the port's counterpart of
tools/make_coco_json.py.

The reference pipeline reads two preprocessed artifacts inherited from
ZheC/Realtime_Multi-Person_Pose_Estimation (reference README.md,
datasets/coco.py:17-29, COCO_data_pipeline.py:240-252):

  COCO.json   {'root': [records]}: one record per annotated person with
              its augmentation metadata (objpos, scale_provided,
              joint_self, joint_others; isValidation for the first 2644
              val2014 images, the minival split)
  mask2014/   one ``*_mask_miss_*.png`` per image: 255 everywhere but on
              the people with too few labeled keypoints (their area is left
              out of the heatmap loss)

This tool writes both from person_keypoints_{train,val}2014.json, so that
the port trains from a plain COCO download on a machine without cv2.
The masks are written by data/image_io.write_png.

COCO visibility -> the index's: v=2 (visible) -> 1, v=1 (labeled,
occluded) -> 0, v=0 (unlabeled) -> 2 (never drawn).

Usage:
  python -m multiposenet_tpu_torch.tools.make_coco_json --coco-root /data/COCO \\
      --out-json /data/COCO/COCO.json --mask-dir /data/COCO/mask2014
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from multiposenet_tpu_torch.data.coco_json import COCOIndex
from multiposenet_tpu_torch.data.image_io import write_png
from multiposenet_tpu_torch.data.rle import ann_to_mask

TARGET_SIZE = 368.0   # scale_provided normaliser (ZheC's convention)
MINIVAL_COUNT = 2644  # the first N val2014 images -> isValidation=1


def vis_map(kps):
    """(17, 3) COCO keypoints -> the index's joints, visibility remapped."""
    j = np.asarray(kps, np.float64).reshape(17, 3)
    v = j[:, 2].copy()
    out_v = np.where(v == 2, 1.0, np.where(v == 1, 0.0, 2.0))
    return np.stack([j[:, 0], j[:, 1], out_v], axis=1)


def person_record(ann, others, img_info, dataset, is_val, people_index,
                  annolist_index):
    bbox = ann["bbox"]
    rec = {
        "dataset": dataset,
        "img_paths": img_info["file_name"],
        "img_height": img_info["height"],
        "img_width": img_info["width"],
        "image_id": img_info["id"],
        "isValidation": float(is_val),
        "people_index": people_index,
        "annolist_index": annolist_index,
        "objpos": [bbox[0] + bbox[2] / 2.0, bbox[1] + bbox[3] / 2.0],
        "scale_provided": bbox[3] / TARGET_SIZE,
        "joint_self": vis_map(ann["keypoints"]).tolist(),
        "numOtherPeople": len(others),
        "num_keypoints_other": [o["num_keypoints"] for o in others],
        "scale_provided_other": [o["bbox"][3] / TARGET_SIZE for o in others],
        "objpos_other": [[o["bbox"][0] + o["bbox"][2] / 2.0,
                          o["bbox"][1] + o["bbox"][3] / 2.0] for o in others],
        "bbox_other": [o["bbox"] for o in others],
        "segment_area_other": [o["area"] for o in others],
        "joint_others": [vis_map(o["keypoints"]).tolist() for o in others],
    }
    if len(others) == 1:
        # the reference expands singleton lists back to 2-D (get_anno)
        rec["joint_others"] = rec["joint_others"][0]
        rec["objpos_other"] = rec["objpos_other"][0]
    return rec


def process_split(coco: COCOIndex, dataset: str, val_ids, records,
                  mask_dir: str, annolist_base: int, min_keypoints: int = 5,
                  min_area: float = 32 * 32, img_prefix: str = ""):
    """Append one record per person of every person image of ``coco`` to
    ``records`` and write each image's mask under ``mask_dir`` (none when
    it is empty).  ``img_prefix`` is joined onto each file_name in
    img_paths: 'train2014'/'val2014' for the real COCO layout (images
    under images/<split>2014/); empty keeps bare file names."""
    img_ids = coco.get_img_ids(cat_ids=[1])
    for annolist_index, img_id in enumerate(img_ids):
        info = dict(coco.load_imgs(img_id)[0])
        if img_prefix:
            info["file_name"] = os.path.join(img_prefix, info["file_name"])
        anns = [a for a in coco.img_to_anns[img_id]
                if a.get("category_id") == 1]
        h, w = info["height"], info["width"]

        main, missing = [], []
        for a in anns:
            if a.get("iscrowd") or a.get("num_keypoints", 0) < min_keypoints \
                    or a.get("area", 0) < min_area:
                missing.append(a)
            else:
                main.append(a)

        if mask_dir:
            mask_miss = np.full((h, w), 255, np.uint8)
            for a in missing:
                # an unreadable segmentation leaves the mask as it is, as
                # the JAX tool does
                try:
                    m = ann_to_mask(a, h, w)
                    mask_miss[m > 0] = 0
                except Exception:
                    pass
            prefix = "val2014" if "val" in dataset.lower() else "train2014"
            stem = info["file_name"][-16:-4]  # zero-padded 12-digit id
            write_png(os.path.join(mask_dir, f"{prefix}_mask_miss_{stem}.png"),
                      mask_miss)

        is_val = img_id in val_ids
        for pi, ann in enumerate(main):
            others = [o for o in main if o is not ann] + \
                     [o for o in missing if o.get("num_keypoints", 0) > 0]
            records.append(person_record(
                ann, others, info, dataset, is_val, pi,
                annolist_base + annolist_index))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coco-root", required=True)
    ap.add_argument("--out-json", required=True)
    ap.add_argument("--mask-dir", default=None)
    ap.add_argument("--min-keypoints", type=int, default=5)
    args = ap.parse_args(argv)

    if args.mask_dir:
        os.makedirs(args.mask_dir, exist_ok=True)
    records = []
    ann_dir = os.path.join(args.coco_root, "annotations")
    coco_val = COCOIndex(os.path.join(ann_dir, "person_keypoints_val2014.json"))
    minival = set(coco_val.get_img_ids(cat_ids=[1])[:MINIVAL_COUNT])
    process_split(coco_val, "COCO_val", minival, records, args.mask_dir, 0,
                  args.min_keypoints, img_prefix="val2014")
    coco_train = COCOIndex(os.path.join(ann_dir, "person_keypoints_train2014.json"))
    process_split(coco_train, "COCO", set(), records, args.mask_dir,
                  10 ** 6, args.min_keypoints, img_prefix="train2014")

    with open(args.out_json, "w") as f:
        json.dump({"root": records}, f)
    print(f"wrote {len(records)} person records to {args.out_json}")
    return len(records)


if __name__ == "__main__":
    main()
