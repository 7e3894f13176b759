"""Report, per case of the data path's parity tests, how far the port's
uint8 pixels are from the JAX package's (cv2's): the largest difference in
levels and the share of pixels that differ, and how many detection samples
have boxes equal to JAX's.  The tests assert the limits (1 level, 1% of
the pixels, boxes within 1 px); this prints the measured values.

    JAX_PLATFORMS=cpu python tests/torch_port_pixel_shares.py
"""

import copy
import os
import subprocess
import sys
import tempfile

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import chip_smoke  # noqa: E402
import test_torch_port_data as tdata  # noqa: E402
import test_torch_port_image_ops as timg  # noqa: E402
from multiposenet_tpu.data import augment as jaug  # noqa: E402
from multiposenet_tpu.data import datasets as jds  # noqa: E402
from multiposenet_tpu.data.coco_json import COCOIndex as JCOCOIndex  # noqa: E402
from multiposenet_tpu_torch.data import augment, datasets, imgproc  # noqa: E402
from multiposenet_tpu_torch.data.coco_json import COCOIndex  # noqa: E402


def diff(got, want):
    d = np.abs(np.asarray(got, np.float64) - want)
    return float(d.max()), float((d > 0).mean()), d.size


def report(rows, title):
    print(f"\n{title}")
    worst = max(r[2] for r in rows)
    for name, mx, share, n in rows:
        print(f"  {name:<40} max {mx:g}  share off {share:.6f}  of {n} values")
    total = sum(r[2] * r[3] for r in rows) / sum(r[3] for r in rows)
    print(f"  worst share {worst:.6f}; over all {total:.6f}")


def resize_rows():
    rows = []
    for scale in timg.SCALES:
        for ch in (1, 3):
            img = timg._image(np.random.RandomState(int(scale * 100) + ch), 97, 131, ch)
            want = cv2.resize(img, (0, 0), fx=scale, fy=scale,
                              interpolation=cv2.INTER_CUBIC)
            rows.append((f"resize_cubic x{scale} c{ch}",
                         *diff(imgproc.resize_cubic(img, scale), want)))
    return rows


def rotate_rows():
    rows = []
    for angle in timg.ANGLES:
        rng = np.random.RandomState(3)
        for img, border, what in ((timg._image(rng, 83, 117, 3), (128, 128, 128), "image"),
                                  (timg._image(rng, 83, 117, 1), 255, "mask")):
            want, _ = jaug._rotate_bound(img, angle, border)
            got, _ = augment._rotate_bound(img, angle, border)
            rows.append((f"rotate {angle} {what}", *diff(got, want)))
    return rows


def augment_rows():
    rows = []
    for seed in range(4):
        jcfg, cfg = tdata._cfgs(flip_prob=0.5)
        state, gen = tdata._sample(seed), np.random.default_rng(seed)
        for name in tdata.STEPS:
            js = jaug.KeypointSample(**copy.deepcopy(state))
            ts = augment.KeypointSample(**copy.deepcopy(state))
            g_j, g_t = copy.deepcopy(gen), copy.deepcopy(gen)
            js = getattr(jaug, name)(js, jcfg, g_j)
            ts = getattr(augment, name)(ts, cfg, g_t)
            rows.append((f"seed {seed} {name} image", *diff(ts.img, js.img)))
            rows.append((f"seed {seed} {name} mask_miss",
                         *diff(ts.mask_miss, js.mask_miss)))
            gen = g_j
            state = dict(img=js.img, mask_miss=js.mask_miss, joints=js.joints,
                         objpos=js.objpos, scale_provided=js.scale_provided)
        js = jaug.augment_bbox_sample(tdata._bbox_sample(seed, jaug), jcfg,
                                      np.random.default_rng(seed))
        ts = augment.augment_bbox_sample(tdata._bbox_sample(seed, augment), cfg,
                                         np.random.default_rng(seed))
        rows.append((f"seed {seed} bbox image", *diff(ts.img, js.img)))
    return rows


def dataset_rows():
    rows, boxes = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        jpeg, png = os.path.join(tmp, "jpeg"), os.path.join(tmp, "png")
        subprocess.run([sys.executable, os.path.join(os.path.dirname(HERE), "tools",
                                                     "make_synth_pose_dataset.py"),
                        "--root", jpeg, "--n-train", "4", "--n-val", "2",
                        "--width", "160", "--height", "120"],
                       check=True, capture_output=True)
        chip_smoke.write_synthetic_coco(png, 4, 2, sizes=((96, 128), (128, 96)),
                                        tall=(40.0, 80.0))
        for tree, root in (("jpeg", jpeg), ("png", png)):
            records = datasets.load_coco_json_index(os.path.join(root, "COCO.json"))
            idx = datasets.split_keypoint_records(records, True)
            jcfg, cfg = tdata._cfgs()
            ann = os.path.join(root, "annotations", "person_keypoints_train2017.json")
            jcoco, coco = JCOCOIndex(ann), COCOIndex(ann)
            ids = set(coco.get_img_ids())
            didx = [i for i, r in enumerate(records) if int(r["image_id"]) in ids]
            img_dir, det_dir = os.path.join(root, "images"), os.path.join(root, "train2017")
            for aug in (True, False):
                pairs = {
                    "keypoint": (jds.KeypointDataset(records, idx, img_dir, root, jcfg, aug),
                                 datasets.KeypointDataset(records, idx, img_dir, root, cfg, aug)),
                    "detection": (jds.DetectionDataset(records, didx, jcoco, det_dir, jcfg, aug),
                                  datasets.DetectionDataset(records, didx, coco, det_dir, cfg, aug))}
                for name, (jd, td) in pairs.items():
                    for i in range(min(len(jd), 6)):
                        j = jd.__getitem__(i, np.random.default_rng(i))
                        t = td.__getitem__(i, np.random.default_rng(i))
                        tag = f"{tree} {name} augment={aug} {i}"
                        rows.append((f"{tag} image", *diff(t["image"], j["image"])))
                        if name == "keypoint":
                            rows.append((f"{tag} mask x255",
                                         *diff(t["mask"] * 255, j["mask"] * 255)))
                        else:
                            key = (tree, aug)
                            n_eq, n = boxes.get(key, (0, 0))
                            boxes[key] = (n_eq + np.array_equal(t["boxes"], j["boxes"]),
                                          n + 1)
    return rows, boxes


def main():
    report(resize_rows(), "INTER_CUBIC resize against cv2 (uint8)")
    report(rotate_rows(), "rotation in bounds against the JAX package (cv2 warpAffine)")
    report(augment_rows(), "augmentation steps against the JAX package")
    rows, boxes = dataset_rows()
    report(rows, "dataset items against the JAX package")
    for (tree, aug), (n_eq, n) in boxes.items():
        print(f"  detection boxes equal to JAX's: {tree} augment={aug}: {n_eq} of {n}")


if __name__ == "__main__":
    main()
