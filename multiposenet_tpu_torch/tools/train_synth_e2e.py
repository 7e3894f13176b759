"""The full staged recipe on the synthetic learnable pose dataset — the
port's counterpart of tools/train_synth_e2e.sh: the reference's three
training stages (multipose_{keypoint,detection,prn}_train.py) and its
multi-scale ``coco-eval`` through the port's CLI, on one GPU.

The recipe (train_synth_e2e.sh:18-50): ``make_synth_pose_dataset`` at its
defaults (320 train and 48 val images of 640x480, 25% crowds, seed 0);
ResNet-101 throughout; keypoint at 480 px, batch 16, 60 epochs, bf16, 4
workers; detection at 608 px, batch 8, lr 1e-4, 30 epochs, bf16, from the
keypoint stage's best checkpoint; PRN at batch 8, lr 1e-3, 20 epochs, from
the detection stage's best; then ``coco-eval`` (5 scales + flip) at the
default capacities.  It gates what the script gates: the first stage or
eval that fails ends it with a non-zero exit.  No AP floor, no ablation.

It is a second recipe table over the synthetic gate's runner
(tools/synth_e2e_gate.run_recipe): each stage a CLI subprocess with
``--deterministic --worker-processes``, its log under ``--save-dir``, a
finished stage keeping only its best checkpoint.  The tree carries a
marker with the generator flags that made it, so the recipe never trains
on the gate's 320x240 tree (nor on a smaller run's).  The last line of
standard output is one JSON object: AP, AP50, AP75, AR, the wall seconds
of each stage and of the eval, the escalated images and kernel K1's
launches in the eval.

Usage:
  python -m multiposenet_tpu_torch.tools.train_synth_e2e \\
      [--root ./extra/mpn_synth_coco] [--save-dir ./extra/mpn_synth_models] \\
      [--precision bf16|f32] [--device cpu]
The size options (--n-train, --max-epoch, ...) shrink the recipe for a
quick run.
"""

from __future__ import annotations

import json
import sys

from multiposenet_tpu_torch.tools.synth_e2e_gate import (
    GateError, Recipe, recipe_parser, run_recipe)

RECIPE = Recipe(
    "synth_e2e", "./extra/mpn_synth_coco", "./extra/mpn_synth_models",
    n_train=320, n_val=48, width=640, height=480, crowd_frac=0.25,
    backbone="resnet101",
    stages=(
        ("keypoint", {"--inp-size": 480, "--batch-size": 16, "--max-epoch": 60,
                      "--num-workers": 4}, True),
        ("detection", {"--inp-size": 608, "--batch-size": 8, "--lr": 1e-4,
                       "--max-epoch": 30, "--num-workers": 4}, True),
        ("prn", {"--batch-size": 8, "--lr": 1e-3, "--max-epoch": 20,
                 "--num-workers": 4}, False),
    ))


def main(argv=None) -> int:
    args = recipe_parser(RECIPE).parse_args(argv)
    try:
        out = run_recipe(args, RECIPE)
    except GateError as e:
        print(f"{RECIPE.name}: FAIL: {e}", flush=True)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
