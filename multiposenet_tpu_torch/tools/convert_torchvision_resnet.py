"""Convert torchvision ResNet-50/101 ImageNet weights (a ``.pth``
``state_dict``) into a checkpoint of the port's FPN trunk — the port's
counterpart of tools/convert_torchvision_resnet.py, the reference's
stage-1 init ``model.fpn.load_state_dict(model_zoo...)`` (reference
training/multipose_keypoint_train.py:73-75).

The port's FPN names its trunk as torchvision does (models/fpn.py), so the
conversion is a prefix and a filter: each key gains ``fpn.``; the
classifier (``fc.*``) and BatchNorm's ``num_batches_tracked`` are dropped;
a key or shape that the port's FPN lacks is refused.  The result is a
model checkpoint (engine/checkpoint.save_model_checkpoint) that ``cli
train --init-params`` loads partially: the trunk's weights and BatchNorm
statistics, the rest of the model as initialised.

Usage:
  python -m multiposenet_tpu_torch.tools.convert_torchvision_resnet \\
      resnet101-63fe2227.pth out_dir
Then:
  python -m multiposenet_tpu_torch.cli train --subnet keypoint \\
      --backbone resnet101 --init-params out_dir/ckpt_0
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Mapping, Tuple

import torch

from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
from multiposenet_tpu_torch.models.fpn import ResNetFPN

BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def backbone_of(state_dict: Mapping[str, torch.Tensor]) -> str:
    """resnet50 or resnet101, from the number of layer3 blocks."""
    n = len({k.split(".")[1] for k in state_dict if k.startswith("layer3.")})
    for name, blocks in BLOCKS.items():
        if blocks[2] == n:
            return name
    raise ValueError(f"a ResNet with {n} layer3 blocks is neither "
                     f"resnet50 nor resnet101")


def convert(state_dict: Mapping[str, torch.Tensor], backbone: str = None
            ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(the port's ``fpn.*`` entries, the skipped torchvision keys)."""
    backbone = backbone or backbone_of(state_dict)
    with torch.device("meta"):
        template = ResNetFPN(BLOCKS[backbone]).state_dict()
    out, skipped = {}, []
    for k, v in state_dict.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            skipped.append(k)
            continue
        if k not in template:
            raise KeyError(f"{k}: the port's {backbone} FPN has no such key")
        if tuple(v.shape) != tuple(template[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)}, the port's "
                             f"{backbone} FPN has {tuple(template[k].shape)}")
        out["fpn." + k] = v.detach().to(torch.float32).clone()
    return out, skipped


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pth_path")
    ap.add_argument("out_dir", help="the checkpoint is written as "
                                    "<out_dir>/ckpt_0")
    ap.add_argument("--backbone", default=None, choices=sorted(BLOCKS),
                    help="checked against the file (default: read from it)")
    args = ap.parse_args(argv)

    sd = torch.load(args.pth_path, map_location="cpu", weights_only=True)
    if args.backbone and backbone_of(sd) != args.backbone:
        ap.error(f"{args.pth_path} holds a {backbone_of(sd)}, not a "
                 f"{args.backbone}")
    state, skipped = convert(sd, args.backbone)
    path = ckpt_lib.save_model_checkpoint(args.out_dir, state, 0)
    print(f"converted {len(state)} entries, skipped {len(skipped)} (fc head, "
          f"num_batches_tracked); wrote {path}")
    return path


if __name__ == "__main__":
    main()
