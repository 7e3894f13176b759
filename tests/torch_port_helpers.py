"""Shared set-up of the multiposenet_tpu_torch parity tests: one random JAX
model whose weights the port loads, and matching configurations of both
packages at a small size."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from multiposenet_tpu.config import Config as JConfig
from multiposenet_tpu.config import DataConfig as JDataConfig
from multiposenet_tpu.config import ModelConfig as JModelConfig
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch.config import Config, ModelConfig
from multiposenet_tpu_torch.models.posenet import build_posenet
from multiposenet_tpu_torch.weights import state_dict_from_flax

# std of the detection output convs: a random trunk's detection features
# are ~1e-6, so at this std logits and box deltas are of order one, scores
# and boxes differ clearly between anchors, and ~50 of the 774 anchors of a
# 64 px image score above 0.05
HEAD_STD = 2e4

LOWERED = dict(score_thresh=0.05, test_score_thresh=0.1, max_detections=32,
               thre1=1e-6, max_peaks=8, max_people=8)


def perturbed_init(backbone: str, size: int, seed: int = 0,
                   head_std: float = 0.01):
    """JAX ``init_all`` tree as numpy, with the zero-initialised detection
    output convs drawn from N(0, head_std) and the stem BN statistics drawn
    at random, so every output carries signal."""
    jm = JPoseNet(JModelConfig(backbone=backbone))
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
                jnp.zeros((1, 56, 36, 17)), method=JPoseNet.init_all)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    rng = np.random.RandomState(seed)
    for head in ("regression_head", "classification_head"):
        k = v["params"][head]["output"]["kernel"]
        v["params"][head]["output"]["kernel"] = (
            rng.randn(*k.shape) * head_std).astype(np.float32)
    bn = v["batch_stats"]["fpn"]["bn1"]
    bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.1).astype(np.float32)
    bn["var"] = (1.0 + rng.rand(*bn["var"].shape)).astype(np.float32)
    return jm, v


def _lowered(cfg, model_cfg, size):
    lo = LOWERED
    return dataclasses.replace(
        cfg,
        model=model_cfg,
        eval=dataclasses.replace(cfg.eval, inp_size=size),
        detection=dataclasses.replace(
            cfg.detection, score_thresh=lo["score_thresh"],
            test_score_thresh=lo["test_score_thresh"],
            max_detections=lo["max_detections"]),
        # random-init heatmaps sit at ~±2e-5: threshold well below that
        peaks=dataclasses.replace(cfg.peaks, thre1=lo["thre1"],
                                  max_peaks_per_joint=lo["max_peaks"]),
        prn=dataclasses.replace(cfg.prn, max_people=lo["max_people"]),
    )


def jax_config(size: int) -> JConfig:
    cfg = _lowered(JConfig(), JModelConfig(backbone="resnet50"), size)
    return dataclasses.replace(cfg, data=JDataConfig(inp_size=size))


def port_config(size: int) -> Config:
    return _lowered(Config(), ModelConfig(backbone="resnet50"), size)


def port_model(v, cfg: Config):
    return build_posenet(cfg.model, torch.device("cpu"), state_dict_from_flax(v))


class ForwardStub:
    """Stands in for the JAX PoseNet inside a JAX pipeline: ``full_forward``
    returns given (heatmaps, cls, reg) and every other method runs the real
    model.  Lets the JAX post-processing run on exactly the tensors the
    port's post-processing is given."""

    def __init__(self, model: JPoseNet):
        self.model = model

    def apply(self, params, x, *args, method=None):
        if method is JPoseNet.full_forward:
            return params["heads"]
        return self.model.apply(params["v"], x, *args, method=method)


# ---------------------------------------------------------------- multi-scale eval

def person_keypoints(cx: float, cy: float):
    """17 visible COCO keypoints spread around (cx, cy)."""
    rng = np.random.RandomState(int(cx) * 7 + int(cy))
    kps = []
    for j in range(17):
        kps += [cx + (j % 5) * 6 - 12 + rng.randint(0, 2),
                cy + (j // 5) * 8 - 12 + rng.randint(0, 2), 2]
    return kps


def image_value(img_id: int) -> int:
    """The constant pixel value of synthetic image ``img_id``: resized by
    any lerp it stays the same, so a stubbed forward reads the image's
    identity from its batch."""
    return 40 + 20 * img_id


def synthetic_coco(root: str, people_per_image, hw=(160, 224)):
    """A COCO keypoint GT with one person per entry of ``people_per_image``
    (a list of [(cx, cy), ...] per image), written as ``gt.json`` beside
    constant-valued PNG images.  Returns (ann_file, gt dict)."""
    import json
    import os

    import cv2

    h, w = hw
    imgs, anns = [], []
    aid = 1
    for img_id, centers in enumerate(people_per_image, start=1):
        name = f"{img_id}.png"
        cv2.imwrite(os.path.join(root, name),
                    np.full((h, w, 3), image_value(img_id), np.uint8))
        imgs.append({"id": img_id, "height": h, "width": w, "file_name": name})
        for cx, cy in centers:
            kps = person_keypoints(cx, cy)
            xs, ys = kps[0::3], kps[1::3]
            x0, y0 = min(xs) - 6, min(ys) - 6
            bbox = [x0, y0, max(xs) - x0 + 6, max(ys) - y0 + 6]
            anns.append({"id": aid, "image_id": img_id, "category_id": 1,
                         "iscrowd": 0, "num_keypoints": 17,
                         "area": bbox[2] * bbox[3], "bbox": bbox,
                         "keypoints": kps})
            aid += 1
    gt = {"images": imgs, "categories": [{"id": 1, "name": "person"}],
          "annotations": anns}
    ann_file = os.path.join(root, "gt.json")
    with open(ann_file, "w") as f:
        json.dump(gt, f)
    return ann_file, gt


class GTForward:
    """Stands in for the network forward of the JAX and the port evaluator
    in a multi-scale eval: for a (B, H, W, 3) batch it returns GT-derived
    stride-4 heatmaps (with ``flip``, every odd row is the mirror of the row
    before, its left/right joints swapped) and the GT boxes at the batch's
    scale, score 0.9 (padded with score-0 boxes to the batch's most).  Each
    row's image is read from its pixel value and the scale from the batch
    shape, so the stub keeps no call order, serves an escalation's second
    dispatch from the evaluator's worker thread, and serves a grouped
    dispatch's batch of several images.  ``calls`` counts the forwards
    each image rode in."""

    def __init__(self, gt: dict, inp_size: int, scale_search, bucket: int = 64,
                 flip: bool = True):
        import collections

        from multiposenet_tpu.data.augment import FLIP_ORDER_18
        from multiposenet_tpu.data.datasets import add_neck
        from multiposenet_tpu.eval.multiscale import crop_shape_only, get_multipliers

        self.flip_order = FLIP_ORDER_18
        self.flip = flip
        self.images = {}
        for rec in gt["images"]:
            h, w = rec["height"], rec["width"]
            joints, boxes = [], []
            for ann in gt["annotations"]:
                if ann["image_id"] != rec["id"]:
                    continue
                j17 = np.asarray(ann["keypoints"], np.float64).reshape(17, 3)
                # drawing convention: COCO v=2 -> internal 1 (drawn)
                j17[:, 2] = np.where(j17[:, 2] == 2, 1.0, 2.0)
                joints.append(add_neck(j17))
                b = ann["bbox"]
                boxes.append([b[0], b[1], b[0] + b[2], b[1] + b[3]])
            scales = {}
            for m in get_multipliers(h, inp_size, scale_search):
                padded, im_scale, _ = crop_shape_only((h, w), m * h, bucket=bucket)
                assert padded not in scales, "two scales share a batch shape"
                scales[padded] = im_scale
            self.images[image_value(rec["id"])] = (
                rec["id"], np.stack(joints), np.asarray(boxes, np.float32), w,
                scales)
        self.calls = collections.Counter()

    def __call__(self, batch: np.ndarray):
        from multiposenet_tpu.ops.heatmap import make_heatmaps_np

        bs, dh, dw = batch.shape[:3]
        nb = 2 if self.flip else 1
        per_row = [self.images[int(batch[row, 0, 0, 0])] for row in range(bs)]
        for img_id in {r[0] for r in per_row}:
            self.calls[img_id] += 1
        k = max(len(r[2]) for r in per_row)
        rows = []
        bx = np.zeros((bs, k, 4), np.float32)
        sc = np.zeros((bs, k), np.float32)
        for row, (_, joints, boxes, w, scales) in enumerate(per_row):
            s = scales[(dh, dw)]
            j = joints.copy()
            if row % nb == 1:
                j = j[:, self.flip_order]
                j[:, :, 0] = w - 1 - j[:, :, 0]
            j[:, :, :2] *= s
            rows.append(make_heatmaps_np(j, dh // 4, dw // 4, stride=4, sigma=6.0))
            bx[row, :len(boxes)] = boxes * np.float32(s)
            sc[row, :len(boxes)] = 0.9
        return np.stack(rows), bx, sc

    def jax_pipeline(self, hw, with_peaks=True, with_detections=True):
        """``Evaluator.pipeline`` of the JAX package."""
        import types

        def run(params, batch):
            hm, bx, sc = self(np.asarray(batch))
            return types.SimpleNamespace(
                heatmaps=jnp.asarray(hm), detections=types.SimpleNamespace(
                    scores=jnp.asarray(sc), boxes=jnp.asarray(bx)))
        return run

    def port_pipeline(self, hw, with_peaks=True, with_detections=True):
        """``Evaluator.pipeline`` of the port."""
        import types

        def run(batch):
            hm, bx, sc = (torch.from_numpy(a) for a in self(batch.numpy()))
            return types.SimpleNamespace(
                heatmaps=hm, detections=types.SimpleNamespace(scores=sc, boxes=bx))
        return run
