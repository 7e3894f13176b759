"""FLOPs of the frozen reference, counted once with ``FlopCounterMode`` on
the meta device (shapes only): the yardstick of the ``mfu`` metrics, which
reads the same whatever the program folds, drops or adds."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from mpn_bench.reference import model as ref_model
from mpn_bench.reference.train import trainable


@functools.lru_cache(maxsize=8)
def _serve(cfg_json: str) -> int:
    cfg = json.loads(cfg_json)
    s = cfg["serve"]
    m = ref_model.build(cfg, "meta").eval().requires_grad_(False)
    x = torch.empty(1, s["inp_size"], s["inp_size"], 3, device="meta")
    grids = torch.empty(s["max_people"], m.prn.height, m.prn.width, 17, device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        m.full_forward(x)
        m.prn.run(grids)
    return fc.get_total_flops()


def serve_flops_per_image(cfg: dict) -> int:
    """One image's serving forward: trunk, both pyramids, the keypoint
    subnet, both RetinaNet heads, and the PRN over ``max_people`` grids."""
    return _serve(json.dumps(cfg, sort_keys=True))


@functools.lru_cache(maxsize=8)
def _train(cfg_json: str, batch: int) -> int:
    cfg = json.loads(cfg_json)
    size = cfg["train_detection"]["inp_size"]
    m = ref_model.build(cfg, "meta")
    for n, p in m.named_parameters():
        p.requires_grad_(trainable(n))
    x = torch.empty(batch, size, size, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        cls, reg = m.detection_forward(x)
        (cls.sum() + reg.sum()).backward()
    return fc.get_total_flops()


def detection_step_flops(cfg: dict, batch: int) -> int:
    """One detection train step of ``batch`` images: the frozen trunk's
    forward, the RetinaNet pyramid and heads forward, and their backward
    (the weight gradients, and the input gradients inside the trainable
    part)."""
    return _train(json.dumps(cfg, sort_keys=True), batch)
