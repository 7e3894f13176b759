"""The FPN's top convolutions over a 1x1 map, on the device: the check
behind ROADMAP §3.6 (NaN detection weights at a 64 px input).

    python -m multiposenet_tpu_torch.tools.probe_pyramid_conv [--root DIR]

1. ``TRIALS`` backward passes of ``conv7``'s convolution as PyTorch runs
   it whole (3x3, stride 2, padding 1, 256 -> 256 channels) over a batch
   of two 1x1 maps, in bfloat16 and in float32, each trial on inputs from
   its own seed: the weight gradients that are not finite, and the largest
   off-centre tap of any gradient (those taps see only padding, so their
   gradient is exactly 0). ``models/fpn.pyramid_conv`` runs this case as
   the centre tap's 1x1 conv instead;
2. the run of §3.6 through ``cli train``: a 128x96 synthetic tree (6 train
   and 2 val images, 30% crowds, seed 0), one epoch of the keypoint stage
   at 64 px, batch 2, then one epoch of the detection stage from its best,
   in bfloat16 and in float32; each detection run's best val loss and
   whether every tensor of its model is finite. Each stage's output goes
   to ``<root>/<exp>.log``.

On the GPU unless ``MPN_PLATFORM=cpu``.  The last line of standard output
is one JSON object; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import tempfile

import torch
import torch.nn.functional as F

from multiposenet_tpu_torch.tools.benchlib import device_name, tool_device

TRAIN = ("--backbone", "resnet50", "--batch-size", "2", "--max-epoch", "1",
         "--num-workers", "2", "--inp-size", "64")
TRIALS = 60
BEST_LOSS_RE = re.compile(r"ckpt_\d+_([0-9.]+|nan|inf)\.best$")


def probe_conv(trials: int, dev: torch.device) -> dict:
    """Per dtype: trials whose weight gradient is not finite, and the
    largest |off-centre tap| over the finite ones."""
    off = torch.ones(3, 3, dtype=torch.bool)
    off[1, 1] = False
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        bad, worst = 0, 0.0
        for t in range(trials):
            g = torch.Generator().manual_seed(t)
            x = torch.randn(2, 256, 1, 1, generator=g)
            w = torch.randn(256, 256, 3, 3, generator=g) * 0.05
            dy = torch.randn(2, 256, 1, 1, generator=g) * 0.01
            w = w.to(dev, dt).requires_grad_(True)
            F.conv2d(x.to(dev, dt), w, stride=2, padding=1).backward(dy.to(dev, dt))
            gw = w.grad.float().cpu()
            if not torch.isfinite(gw).all():
                bad += 1
            else:
                worst = max(worst, float(gw[..., off].abs().max()))
        out[str(dt).removeprefix("torch.")] = {"trials": trials, "not_finite": bad,
                                               "max_off_centre": worst}
    return out


def train_runs(root: str) -> dict:
    """The §3.6 recipe through ``cli train``; per detection dtype its best
    val loss and whether its model is all finite."""
    from multiposenet_tpu_torch.engine.checkpoint import load_checkpoint
    from multiposenet_tpu_torch.tools import make_synth_pose_dataset
    from multiposenet_tpu_torch.tools.synth_e2e_gate import (best_checkpoint,
                                                             run_stage)

    coco, models = os.path.join(root, "coco"), os.path.join(root, "models")
    make_synth_pose_dataset.main(["--root", coco, "--n-train", "6", "--n-val", "2",
                                  "--width", "128", "--height", "96", "--seed", "0",
                                  "--crowd-frac", "0.3", "--workers", "2"])
    base = [sys.executable, "-m", "multiposenet_tpu_torch.cli", "train",
            "--coco-root", coco, "--save-dir", models, *TRAIN]
    run_stage("keypoint", base + ["--subnet", "keypoint", "--exp-name", "kp"],
              os.environ, os.path.join(root, "kp.log"))
    init = best_checkpoint(models, "kp")
    out = {}
    for exp, extra in (("det_bf16", ["--bf16"]), ("det_f32", [])):
        run_stage(exp, base + ["--subnet", "detection", "--exp-name", exp,
                               "--init-params", init] + extra,
                  os.environ, os.path.join(root, exp + ".log"))
        best = best_checkpoint(models, exp)
        sd = load_checkpoint(best)["model"]
        out[exp] = {"val_loss": float(BEST_LOSS_RE.search(best).group(1)),
                    "all_finite": all(bool(torch.isfinite(t).all())
                                      for t in sd.values() if t.is_floating_point())}
    return out


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="where the tree, checkpoints and logs go "
                         "(default: a temporary directory, removed after)")
    args = ap.parse_args(argv)
    dev = tool_device(device)
    res = {"conv": probe_conv(TRIALS, dev)}
    if args.root:
        res["train"] = train_runs(args.root)
    else:
        with tempfile.TemporaryDirectory(prefix="mpn_probe_") as root:
            res["train"] = train_runs(root)
    res["device"] = device_name(dev)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    r = main()
    sys.exit(0 if all(math.isfinite(v["val_loss"]) and v["all_finite"]
                      for v in r["train"].values()) else 1)
