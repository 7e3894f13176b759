"""A reference-shaped per-image baseline on the same hardware — the port's
counterpart of tools/bench_reference_shaped.py.

    python -m multiposenet_tpu_torch.tools.bench_reference_shaped
        [--images 30] [--size 480] [--backbone resnet101]

The reference's serial pattern (evaluate/tester.py:195-254), driven
through the port's float32 graph: batch 1, one dispatch per image
(``make_full_pipeline(with_peaks=False)``: the forward, decode and NMS
kernel K1 at B = 1), the whole heatmap copied to the host, peaks found and
refined on the host (``eval/multiscale.joint_list_from_heatmaps``), the
neck dropped, the boxes above the test threshold kept, and the PRN
grouping of ``Evaluator.prn_process``.  It gives the reference every
advantage the port has (one batched PRN dispatch, no cv2 preprocessing),
so the reference itself could not run an image faster on this card: the
port's bench divides by this rate (``bench.REFERENCE_IMAGES_PER_SEC``).

Weights are drawn from seed 0, images from ``RandomState(0)``.  K1
launches once per image, plus one warm-up image.  The last line of
standard output is one JSON object; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

from multiposenet_tpu_torch.tools.benchlib import (device_name, synchronize,
                                                   tool_device)


def reference_images(n: int, size: int) -> List[np.ndarray]:
    rng = np.random.RandomState(0)
    return [(rng.rand(1, size, size, 3) * 255).astype(np.uint8)
            for _ in range(n)]


class ReferenceShaped:
    """One image at a time, as the reference runs it: ``one_image(img)``
    takes a (1, S, S, 3) uint8 RGB array and returns its person rows."""

    def __init__(self, model, cfg, size: int, dev: torch.device):
        from multiposenet_tpu_torch.engine.evaluator import Evaluator
        from multiposenet_tpu_torch.engine.inference import make_full_pipeline

        self.cfg = cfg
        self.size = size
        self.dev = dev
        self.ev = Evaluator(cfg, device=dev, model=model)
        # the forward without device peaks: the heatmaps come to the host
        self.pipeline = make_full_pipeline(model, cfg, (size, size),
                                           device=dev, with_peaks=False)

    def one_image(self, img: np.ndarray) -> List[Dict]:
        from multiposenet_tpu_torch.engine.evaluator import drop_neck
        from multiposenet_tpu_torch.eval.multiscale import joint_list_from_heatmaps

        out = self.pipeline(torch.from_numpy(img).to(self.dev))
        heat = out.heatmaps[0].float().cpu().numpy()              # whole map
        keep = out.detections.keep[0].cpu().numpy()
        boxes = out.detections.boxes[0].cpu().numpy()[keep]
        scores = out.detections.scores[0].cpu().numpy()[keep]
        jl = joint_list_from_heatmaps(heat, self.size, 1.0,
                                      thre1=self.cfg.peaks.thre1)
        jl = drop_neck(jl)
        sel = scores > self.cfg.detection.test_score_thresh
        bx = [[b[0], b[1], b[2], b[3]] for b in boxes[sel]]
        return self.ev.prn_process(jl, bx, "bench", 0)


def measure(ref: ReferenceShaped, imgs) -> Dict:
    """One warm-up image, then every image of ``imgs`` timed in turn."""
    ref.one_image(imgs[0])
    synchronize(ref.dev)
    t0 = time.perf_counter()
    rows = [ref.one_image(img) for img in imgs]
    dt = time.perf_counter() - t0
    return {"images_per_sec": len(imgs) / dt, "ms_per_image": dt / len(imgs) * 1e3,
            "rows": rows}


def reference_config(backbone: str = "resnet101"):
    """Float32, as the reference's torch graph runs."""
    from multiposenet_tpu_torch.config import Config, ModelConfig

    return Config(model=ModelConfig(backbone=backbone))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="bench_reference_shaped")
    ap.add_argument("--images", type=int, default=30)
    ap.add_argument("--size", type=int, default=480)
    ap.add_argument("--backbone", default="resnet101")
    return ap.parse_args(argv)


def main(argv=None, device=None, model=None, cfg=None) -> Dict:
    """Measure and print the JSON line.  ``model`` and ``cfg`` (built, on
    ``device``, float32) replace the seed-0 model."""
    from multiposenet_tpu_torch.models.posenet import build_posenet

    args = parse_args(argv)
    dev = tool_device(device)
    if cfg is None:
        cfg = reference_config(args.backbone)
    if cfg.model.compute_dtype != torch.float32:
        raise ValueError("the reference-shaped baseline runs the float32 graph")
    if model is None:
        model = build_posenet(cfg.model, dev, seed=0)
    ref = ReferenceShaped(model, cfg, args.size, dev)
    m = measure(ref, reference_images(args.images, args.size))
    out = {"metric": "reference_shaped_images_per_sec",
           "value": m["images_per_sec"], "ms_per_image": m["ms_per_image"],
           "images": args.images, "size": args.size,
           "backbone": cfg.model.backbone, "backend": dev.type,
           "device": device_name(dev)}
    print(json.dumps(out), flush=True)
    out["rows"] = m["rows"]
    return out


if __name__ == "__main__":
    main()
