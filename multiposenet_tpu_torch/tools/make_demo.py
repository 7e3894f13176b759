"""Demo artifacts from a real end-to-end run of the port — the counterpart
of tools/make_demo.py, without cv2.

The reference checks demo renders into demo/output/ (its
evaluate/multipose_test.py writes ``*_1heatmap.png`` / ``*_2canvas.png``).
With no COCO images or pretrained checkpoint at hand, this tool makes the
whole experience on synthetic stick-figure scenes:

  1. draws two-person scenes with a known 18-joint skeleton layout;
  2. trains the three stages on four of them: the keypoint subnet (trunk
     and head), the detection subnet (RetinaNet heads, trunk frozen) from
     the keypoint state and its BatchNorm statistics, then the PRN from the
     detection state — the reference's staged recipe;
  3. runs the demo path (``Evaluator.test``: one forward, peaks, boxes, PRN
     grouping, the renderer) over two held-out scenes and writes
     ``<out>/test_images`` and ``<out>/output``.

For one seed the scenes, joints and training batches equal the JAX tool's
bit for bit: the same ``np.random.RandomState`` draws in the same order,
the lines and discs drawn with cv2's own integer arithmetic
(eval/render.thick_line, circle), the test images written as PNG with the
same pixels.  The keypoint model is drawn from seed 0 and the PRN's
dropout from a generator seeded 3.  (The JAX tool's seeds 1 and 2 draw
detection and PRN states whose every tensor it then replaces by the
previous stage's, so here the next stage takes the trained model itself.)

Usage:
  python -m multiposenet_tpu_torch.tools.make_demo [--steps 3000] \\
      [--size 128] [--out $TMPDIR/mpn_demo_torch] [--device cpu] [--diag]
The default ``--out`` lies outside the repository: the repository's
``demo/`` holds the JAX package's renders and is not rewritten.  The last
line of standard output is one JSON object: the people found per scene,
the files written, kernel K1's launches and the wall seconds per stage.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from multiposenet_tpu_torch.eval.render import circle, thick_line

# 18-joint internal order (reference COCO_data_pipeline.py:123-174):
# nose neck Rsho Relb Rwri Lsho Lelb Lwri Rhip Rkne Rank Lhip Lkne Lank
# Reye Leye Rear Lear — template in unit coords (x, y)
TEMPLATE_18 = np.array([
    [0.50, 0.10], [0.50, 0.25],
    [0.35, 0.25], [0.28, 0.45], [0.25, 0.62],
    [0.65, 0.25], [0.72, 0.45], [0.75, 0.62],
    [0.40, 0.55], [0.38, 0.75], [0.36, 0.95],
    [0.60, 0.55], [0.62, 0.75], [0.64, 0.95],
    [0.45, 0.06], [0.55, 0.06], [0.40, 0.09], [0.60, 0.09]], np.float32)
LIMBS_18 = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7),
            (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13),
            (0, 14), (0, 15), (14, 16), (15, 17)]
LIMB_COLORS = [(200, 60, 40), (40, 160, 220), (60, 200, 80), (230, 180, 40),
               (180, 60, 200)]
N_TRAIN = 4            # training scenes
N_TEST = 2             # held-out scenes
PRN_LR = 1e-3          # reference multipose_prn_train.py:79
LOG_EVERY = 500


def draw_scene(size, persons, rng):
    """persons: list of (cx, top_y, height) in pixels.  Returns (img_bgr u8,
    joints (P, 18, 3) with v=1, boxes (P, 4) xyxy)."""
    img = (rng.rand(size, size, 3) * 40 + 200).astype(np.uint8)
    joints, boxes = [], []
    for pi, (cx, ty, h) in enumerate(persons):
        w = h * 0.55
        j = TEMPLATE_18.copy()
        j[:, 0] = (j[:, 0] - 0.5) * w + cx
        j[:, 1] = j[:, 1] * h + ty
        j += rng.randn(18, 2) * 0.8
        col = LIMB_COLORS[pi % len(LIMB_COLORS)]
        # pixels by astype(int), which truncates, as the JAX tool's
        for a, b in LIMBS_18:
            thick_line(img, tuple(j[a].astype(int)), tuple(j[b].astype(int)),
                       col, 3)
        for t in range(18):
            circle(img, tuple(j[t].astype(int)), 2,
                   (int(col[2]), int(col[0]), int(col[1])))
        joints.append(np.concatenate([j, np.ones((18, 1), np.float32)], 1))
        x1, y1 = j.min(0) - 4
        x2, y2 = j.max(0) + 4
        boxes.append([x1, y1, x2, y2])
    return img, np.stack(joints), np.asarray(boxes, np.float32)


def scene_batch(size, n, rng, max_p=2):
    """``n`` two-person training scenes: (RGB images, joints padded to
    ``max_p`` people with v=2 rows)."""
    imgs, joints = [], []
    for _ in range(n):
        pers = [(size * 0.28 + rng.randn() * 3, size * 0.08 + rng.randn() * 3,
                 size * 0.72),
                (size * 0.72 + rng.randn() * 3, size * 0.25 + rng.randn() * 3,
                 size * 0.55)]
        im, jt, _ = draw_scene(size, pers, rng)
        imgs.append(im[:, :, ::-1])  # the train pipeline takes RGB
        jpad = np.full((max_p, 18, 3), 2.0, np.float32)
        jpad[:len(jt)] = jt
        joints.append(jpad)
    return np.stack(imgs), np.stack(joints).astype(np.float32)


def held_out_scenes(size, n=N_TEST):
    """The held-out scenes (BGR), drawn from ``RandomState(99)`` at the
    training layout without its position jitter."""
    rng = np.random.RandomState(99)
    return [draw_scene(size, [(size * 0.28, size * 0.08, size * 0.72),
                              (size * 0.72, size * 0.25, size * 0.55)], rng)[0]
            for _ in range(n)]


def keypoint_batch(imgs, joints):
    n, size = imgs.shape[0], imgs.shape[1]
    return {"image": imgs, "joints": joints,
            "mask": np.ones((n, size // 4, size // 4), np.float32)}


def detection_batch(imgs, joints):
    """Each person's joint extent grown by 4 px as its GT box, class 0;
    four box slots per image, pad rows -1."""
    n, people = joints.shape[:2]
    boxes = np.full((n, 4, 5), -1.0, np.float32)
    for b in range(n):
        for p in range(people):
            j = joints[b, p, :, :2]
            boxes[b, p] = [j[:, 0].min() - 4, j[:, 1].min() - 4,
                           j[:, 0].max() + 4, j[:, 1].max() + 4, 0]
    return {"image": imgs, "boxes": boxes}


def prn_batch(joints, gh, gw, thr):
    """One PRN sample per person box (reference multipose_prn_train.py's
    data): the one-hot marks on the (gh, gw) grid over the box of every
    person's joints within the box grown by ``thr`` of its size, and of the
    box's own person.  The 17-joint order is the 18-joint order without the
    neck."""
    weights_l, labels_l = [], []
    n, people = joints.shape[:2]
    for b in range(n):
        persons17 = [np.delete(joints[b, p, :, :2], 1, axis=0)
                     for p in range(people)]
        for p in range(people):
            j = joints[b, p]
            x1, y1 = j[:, 0].min() - 4, j[:, 1].min() - 4
            bw = j[:, 0].max() + 4 - x1
            bh = j[:, 1].max() + 4 - y1
            xs, ys = gw / np.ceil(bw), gh / np.ceil(bh)
            weights = np.zeros((gh, gw, 17), np.float32)
            label = np.zeros((gh, gw, 17), np.float32)
            for q, pj in enumerate(persons17):
                for t in range(17):
                    kx, ky = pj[t]
                    if (x1 - bw * thr < kx < x1 + bw * (1 + thr)
                            and y1 - bh * thr < ky < y1 + bh * (1 + thr)):
                        gx = min(max(int((kx - x1) * xs), 0), gw - 1)
                        gy = min(max(int((ky - y1) * ys), 0), gh - 1)
                        weights[gy, gx, t] = 1.0
                        if q == p:
                            label[gy, gx, t] = 1.0
            weights_l.append(weights)
            labels_l.append(label)
    return {"weights_marks": np.stack(weights_l),
            "label_marks": np.stack(labels_l)}


def demo_config(size: int):
    """ResNet-50 at ``size`` for training and the demo, writing the renders
    and the JSON."""
    from multiposenet_tpu_torch.config import Config, DataConfig, ModelConfig

    cfg = Config(model=ModelConfig(backbone="resnet50"),
                 data=DataConfig(inp_size=size))
    return dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, inp_size=size,
                                      write_image=True, write_json=True))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--det-steps", type=int, default=None,
                    help="detection and PRN steps (default: --steps)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--det-lr", type=float, default=1e-4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "mpn_demo_torch"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--diag", action="store_true",
                    help="print heatmap/detector stats on a TRAIN scene")
    return ap.parse_args(argv)


def train_stage(state, step, batch, lr, steps, name, *extra):
    """``steps`` train steps on one fixed batch; the last loss."""
    from multiposenet_tpu_torch.utils.logging import logger

    loss = float("nan")
    for i in range(steps):
        state, logs = step(state, batch, lr, *extra)
        if i % LOG_EVERY == 0 or i == steps - 1:
            loss = float(logs["loss"])
            if name == "keypoint":
                logger.info("keypoint step %d loss %.5f max_ht %.3f", i, loss,
                            float(logs["max_ht"]))
            else:
                logger.info("%s step %d loss %.5f", name, i, loss)
    return loss


def diag(model, cfg, imgs, device) -> None:
    """Heatmap and detector statistics on the first training scene."""
    import torch

    from multiposenet_tpu_torch.engine.inference import make_full_pipeline
    from multiposenet_tpu_torch.utils.logging import logger

    size = cfg.data.inp_size
    out = make_full_pipeline(model, cfg, (size, size), device=device)(
        torch.from_numpy(np.ascontiguousarray(imgs[:1])))
    hm = out.heatmaps[0].float().cpu().numpy()
    ds = np.sort(out.detections.scores[0].float().cpu().numpy())[::-1]
    pv = out.peaks.valid[0].cpu().numpy()
    logger.info("DIAG train scene: heatmap max %.3f per-joint max %s",
                hm.max(), np.round(hm.max((0, 1))[:8], 2))
    logger.info("DIAG top det scores %s; peaks/joint %s",
                np.round(ds[:6], 3), pv.sum(1)[:8])


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from multiposenet_tpu_torch.config import resolve_device
    from multiposenet_tpu_torch.data.image_io import write_png
    from multiposenet_tpu_torch.engine.evaluator import Evaluator
    from multiposenet_tpu_torch.engine.train_steps import (
        STEP_FACTORIES, create_train_state)
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet
    from multiposenet_tpu_torch.ops import cuda_nms
    from multiposenet_tpu_torch.utils.logging import logger

    device = resolve_device(args.device)
    size = args.size
    cfg = demo_config(size)
    det_steps = args.det_steps or args.steps
    imgs, joints = scene_batch(size, N_TRAIN, np.random.RandomState(7))

    def on_device(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}

    wall, losses = {}, {}
    model = build_trainable_posenet(cfg.model, device, seed=0)
    stages = (
        ("keypoint", keypoint_batch(imgs, joints), args.lr, args.steps, ()),
        ("detection", detection_batch(imgs, joints), args.det_lr, det_steps, ()),
        ("prn", prn_batch(joints, cfg.model.prn_height, cfg.model.prn_width,
                          cfg.prn.in_thres), PRN_LR, det_steps,
         (torch.Generator(device).manual_seed(3),)),
    )
    for name, batch, lr, steps, extra in stages:
        t0 = time.perf_counter()
        state = create_train_state(cfg, name, model=model)
        step, _ = STEP_FACTORIES[name](cfg, device=device)
        losses[name] = train_stage(state, step, on_device(batch), lr, steps,
                                   name, *extra)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall[name] = time.perf_counter() - t0
    model.eval().requires_grad_(False)

    if args.diag:
        diag(model, cfg, imgs, device)

    test_dir = os.path.join(args.out, "test_images")
    out_dir = os.path.join(args.out, "output")
    os.makedirs(test_dir, exist_ok=True)
    names = []
    for k, im in enumerate(held_out_scenes(size)):
        names.append(f"scene{k + 1}.png")
        write_png(os.path.join(test_dir, names[-1]), im)

    t0 = time.perf_counter()
    launches = cuda_nms.launches
    results = Evaluator(cfg, device=device, model=model).test(test_dir, out_dir)
    launches = cuda_nms.launches - launches
    wall["test"] = time.perf_counter() - t0
    logger.info("demo: %d person instances across %d scenes", len(results),
                len(names))
    print(f"wrote {test_dir} and {out_dir}; {len(results)} persons detected")
    out = {"persons": len(results),
           "persons_per_scene": {n: sum(r["file_name"] == n for r in results)
                                 for n in names},
           "test_dir": test_dir, "out_dir": out_dir,
           "written": sorted(os.listdir(out_dir)),
           "nms_suppress_launches": launches, "final_loss": losses,
           "wall_s": wall,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
