"""Generate a learnable synthetic pose dataset in the on-disk layout the
CLI reads for all three training stages and for ``coco-eval`` — the port's
counterpart of tools/make_synth_pose_dataset.py, without cv2.

Stick figures with one fixed colour per joint (a strong cue a convnet
learns quickly) over smooth random backgrounds; human-plausible skeleton
proportions, so the PRN sees realistic joint layouts.  A ``--crowd-frac``
share of the images are crowds of 6-10 small overlapping figures.

For one seed this writes the JAX tool's people, boxes, visibilities and
annotation files: the draw order from ``np.random.default_rng(seed)`` is
the same, and the anti-aliased lines and discs are cv2's own arithmetic
(eval/render.py).  The background's float32 INTER_CUBIC upscale is cv2's
IPP path as data/imgproc.resize_cubic models it (within 1e-6), so a few
background pixels may sit one level apart.  Images are PNG, which the
port reads without cv2, so the JAX tool's JPEG q95 noise is absent.

Layout produced under --root:
  COCO.json                                   keypoint index (CMU schema;
                                              one record per person)
  images/COCO_{train,val}2014_XXXXXXXXXXXX.png   keypoint-stage images
  mask2014/{train,val}2014_mask_miss_XXX.png     all-valid miss masks
  annotations/person_keypoints_{train,val}2017.json  standard COCO jsons
  {train2017,val2017}/XXXXXXXXXXXX.png           detection-stage images
  images/val2017/XXXXXXXXXXXX.png                coco-eval images

The same image is hard-linked into every view, so the three stages and the
evaluator see the same pixels.

Usage:  python -m multiposenet_tpu_torch.tools.make_synth_pose_dataset \\
            --root /tmp/mpn_synth_coco --n-train 320 --n-val 48 [--seed 0]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os

import numpy as np

from multiposenet_tpu_torch.data.image_io import write_png
from multiposenet_tpu_torch.data.imgproc import resize_cubic
from multiposenet_tpu_torch.eval.render import circle_aa, thick_line_aa

# COCO keypoint order (annotation category spec)
KEYPOINT_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]
# COCO category skeleton (1-indexed pairs)
SKELETON = [
    [16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13],
    [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3], [1, 2], [1, 3],
    [2, 4], [3, 5], [4, 6], [5, 7],
]
# one fixed, saturated BGR colour per joint: the learnable cue
JOINT_COLORS = [
    (0, 0, 255), (0, 128, 255), (0, 255, 255), (0, 255, 128), (0, 255, 0),
    (128, 255, 0), (255, 255, 0), (255, 128, 0), (255, 0, 0), (255, 0, 128),
    (255, 0, 255), (128, 0, 255), (64, 64, 255), (64, 255, 64),
    (255, 64, 64), (192, 128, 0), (0, 128, 192),
]

# canonical standing skeleton: (x, y) in units of body height, y down from
# the top of the head
CANON = {
    "nose": (0.00, 0.06),
    "left_eye": (0.03, 0.04), "right_eye": (-0.03, 0.04),
    "left_ear": (0.055, 0.06), "right_ear": (-0.055, 0.06),
    "left_shoulder": (0.11, 0.18), "right_shoulder": (-0.11, 0.18),
    "left_elbow": (0.17, 0.33), "right_elbow": (-0.17, 0.33),
    "left_wrist": (0.20, 0.47), "right_wrist": (-0.20, 0.47),
    "left_hip": (0.07, 0.52), "right_hip": (-0.07, 0.52),
    "left_knee": (0.09, 0.73), "right_knee": (-0.09, 0.73),
    "left_ankle": (0.09, 0.95), "right_ankle": (-0.09, 0.95),
}


def sample_person(rng, w, h, h_range=None):
    """A random plausible figure fully inside the frame: ((17, 3) joints,
    body height), or None when it does not fit.  ``h_range`` overrides the
    body-height range (crowd scenes use smaller, overlapping figures)."""
    h_max = min(360.0, h - 24.0)          # body height ~= vertical span
    if h_range is not None:
        # both bounds clamped to the frame: a small frame's h_max can fall
        # below h_range[0]
        hi_b = min(h_range[1], h_max)
        body = rng.uniform(min(h_range[0], hi_b), hi_b)
    else:
        body = rng.uniform(min(150.0, 0.6 * h_max), h_max)
    theta = np.deg2rad(rng.uniform(-15, 15))
    c, s = np.cos(theta), np.sin(theta)
    pts = np.array([CANON[n] for n in KEYPOINT_NAMES], np.float64) * body
    # limb-pose variation: swing wrists, elbows and knees a little
    jitter = rng.uniform(-0.025, 0.025, size=(17, 2)) * body
    jitter[7:11] += rng.uniform(-0.05, 0.05, size=(4, 2)) * body  # arms
    pts = pts + jitter
    # rotate about the hip center
    hip = pts[11:13].mean(axis=0)
    pts = (pts - hip) @ np.array([[c, -s], [s, c]]).T + hip
    # place so that every joint is >= 8 px inside
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = hi - lo
    if span[0] > w - 16 or span[1] > h - 16:
        return None
    off = np.array([rng.uniform(8 - lo[0], w - 8 - hi[0]),
                    rng.uniform(8 - lo[1], h - 8 - hi[1])])
    pts = pts + off
    vis = np.full((17, 1), 2.0)
    vis[rng.random(17) < 0.08] = 1.0  # now and then "labeled, not visible"
    return np.concatenate([pts, vis], axis=1), body


def _pixel(p) -> tuple:
    return tuple(int(v) for v in np.round(p).astype(int))


def limb_color(rng) -> tuple:
    return tuple(int(v) for v in rng.integers(60, 140, 3))


def draw_person(img, kp, body, color):
    """Limbs, head and joint dots, anti-aliased, onto a uint8 BGR image;
    ``color`` is the limbs' and head's (``limb_color``)."""
    t = max(2, int(body / 36))
    for a, b in SKELETON:
        thick_line_aa(img, _pixel(kp[a - 1, :2]), _pixel(kp[b - 1, :2]),
                      color, t)
    circle_aa(img, _pixel(kp[0, :2]), max(3, int(body * 0.055)), color)
    r = max(2, int(body / 45))
    for j in range(17):
        circle_aa(img, _pixel(kp[j, :2]), r, JOINT_COLORS[j])


def background(rng, w, h):
    """A smooth random gradient plus mild noise, uint8 (h, w, 3)."""
    g = rng.uniform(30, 225, size=(4, 4, 3))
    bg = resize_cubic(g.astype(np.float32), dsize=(w, h))
    bg += rng.normal(0, 6, size=bg.shape)
    return np.clip(bg, 0, 255).astype(np.uint8)


def person_ann(kp, img_id, ann_id):
    xy = kp[:, :2]
    x0, y0 = xy.min(axis=0) - 4
    x1, y1 = xy.max(axis=0) + 4
    bbox = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
    flat = []
    for j in range(17):
        flat += [float(kp[j, 0]), float(kp[j, 1]), int(kp[j, 2])]
    return {
        "id": ann_id, "image_id": img_id, "category_id": 1,
        "iscrowd": 0, "num_keypoints": int((kp[:, 2] > 0).sum()),
        "keypoints": flat, "bbox": bbox,
        "area": float(bbox[2] * bbox[3]),
        "segmentation": [[bbox[0], bbox[1], bbox[0] + bbox[2], bbox[1],
                          bbox[0] + bbox[2], bbox[1] + bbox[3],
                          bbox[0], bbox[1] + bbox[3]]],
    }


def to_cmu(kp):
    """Standard COCO visibility (2 visible, 1 occluded, 0 unlabeled) to the
    CMU COCO.json's (1 visible, 0 occluded, 2 unlabeled): the reference's
    heatmap targets draw a joint iff v <= 1 (COCO_data_pipeline.py:137-151)."""
    out = kp.copy()
    out[:, 2] = np.where(kp[:, 2] == 2.0, 1.0,
                         np.where(kp[:, 2] == 1.0, 0.0, 2.0))
    return out


def plan_scene(rng, i: int, seed: int, w: int, h: int, crowd_frac: float):
    """Every random draw of image ``i``, in the JAX tool's order: its
    background, its people [(joints, body height)] and their limb
    colours.  Drawing them (``render_scene``) takes no randomness."""
    bg = background(rng, w, h)
    people = []
    if rng.random() < crowd_frac:
        n_want, h_range = int(rng.integers(6, 11)), (55.0, 140.0)
    else:
        n_want, h_range = int(rng.integers(1, 4)), None
    for _ in range(n_want):
        p = sample_person(rng, w, h, h_range=h_range)
        if p is not None:
            people.append(p)
    retry = np.random.default_rng(seed + i)
    while not people:
        p = sample_person(retry, w, h, h_range=h_range)
        if p is not None:
            people.append(p)
    return bg, people, [limb_color(rng) for _ in people]


def render_scene(bg, people, colors) -> np.ndarray:
    img = bg.copy()
    for (kp, body), color in zip(people, colors):
        draw_person(img, kp, body, color)
    return img


def _write_image(job) -> None:
    """Render one planned image and write it (in a worker process)."""
    path, bg, people, colors = job
    write_png(path, render_scene(bg, people, colors))


def generate(root: str, n_train: int, n_val: int, seed: int = 0,
             width: int = 640, height: int = 480,
             crowd_frac: float = 0.25, workers: int = 0) -> dict:
    """Write the tree under ``root``; returns its counts.  The draws are
    made in order here, and the images drawn by ``workers`` processes
    (default: one per CPU)."""
    rng = np.random.default_rng(seed)
    w, h = width, height
    for d in ("images", "mask2014", "annotations", "train2017", "val2017",
              "images/val2017"):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    records = []
    coco = {"train2017": {"images": [], "annotations": []},
            "val2017": {"images": [], "annotations": []}}
    ann_id = 1
    mask = np.full((h, w), 255, np.uint8)
    jobs, links = [], []
    for i in range(n_train + n_val):
        is_val = i >= n_train
        split, tag = ("val2017", "val") if is_val else ("train2017", "train")
        bg, people, colors = plan_scene(rng, i, seed, w, h, crowd_frac)

        stem = f"{i:012d}"
        kp_name = f"COCO_{tag}2014_{stem}.png"
        kp_path = os.path.join(root, "images", kp_name)
        jobs.append((kp_path, bg, people, colors))
        write_png(os.path.join(root, "mask2014",
                               f"{tag}2014_mask_miss_{stem}.png"), mask)
        det_name = f"{stem}.png"
        links += [(kp_path, os.path.join(root, split, det_name))]
        if is_val:
            links += [(kp_path, os.path.join(root, "images/val2017", det_name))]

        coco[split]["images"].append(
            {"id": i, "file_name": det_name, "width": w, "height": h})
        for kp, _ in people:
            coco[split]["annotations"].append(person_ann(kp, i, ann_id))
            ann_id += 1

        # one keypoint record per person (CMU preprocessing convention)
        for pi, (kp, body) in enumerate(people):
            others = [to_cmu(people[q][0])
                      for q in range(len(people)) if q != pi]
            xy = kp[:, :2]
            center = (xy.min(axis=0) + xy.max(axis=0)) / 2.0
            records.append({
                "dataset": "COCO_val" if is_val else "COCO",
                "isValidation": 1.0 if is_val else 0.0,
                "img_paths": kp_name,
                "img_width": float(w), "img_height": float(h),
                "image_id": i,
                "objpos": [float(center[0]), float(center[1])],
                "scale_provided": float(body / 368.0),
                "joint_self": to_cmu(kp).tolist(),
                "joint_others": [o.tolist() for o in others],
                "numOtherPeople": float(len(others)),
            })

    workers = workers or os.cpu_count() or 1
    if workers > 1:
        with concurrent.futures.ProcessPoolExecutor(workers) as ex:
            list(ex.map(_write_image, jobs, chunksize=4))
    else:
        for job in jobs:
            _write_image(job)
    for src, link in links:
        if os.path.exists(link):
            os.remove(link)
        os.link(src, link)

    with open(os.path.join(root, "COCO.json"), "w") as f:
        json.dump({"root": records}, f)
    cat = {"id": 1, "name": "person", "supercategory": "person",
           "keypoints": KEYPOINT_NAMES, "skeleton": SKELETON}
    for split in ("train2017", "val2017"):
        with open(os.path.join(root, "annotations",
                               f"person_keypoints_{split}.json"), "w") as f:
            json.dump({"images": coco[split]["images"],
                       "annotations": coco[split]["annotations"],
                       "categories": [cat]}, f)
    return {"images": n_train + n_val, "records": len(records),
            "annotations": ann_id - 1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--n-train", type=int, default=320)
    ap.add_argument("--n-val", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--crowd-frac", type=float, default=0.25,
                    help="share of images drawn as crowds (6-10 small "
                         "overlapping figures): the PRN's contention and "
                         "fallback branches and the evaluator's capacity "
                         "escalation run on them")
    ap.add_argument("--workers", type=int, default=0,
                    help="processes that draw the images (0: one per CPU)")
    args = ap.parse_args(argv)
    n = generate(args.root, args.n_train, args.n_val, args.seed, args.width,
                 args.height, args.crowd_frac, args.workers)
    print(f"wrote {n['images']} images, {n['records']} keypoint records, "
          f"{n['annotations']} annotations under {args.root}")
    return n


if __name__ == "__main__":
    main()
