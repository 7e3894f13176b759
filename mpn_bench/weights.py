"""Seeded weights, drawn on the device in a few large calls.

A configuration's ``init`` lists rules ``{"match": regex, "std": ..., "mean":
..., "scale": ...}``; the first rule whose regex matches a ``state_dict`` key
sets that tensor to ``mean + scale * std * N(0, 1)``.  ``std`` is a number,
``"he"`` (sqrt(2 / fan_in)) or ``"lecun"`` (sqrt(1 / fan_in)); ``scale``
defaults to 1 and ``mean`` to 0.  ``"zero_sum_taps": true`` then subtracts
from a convolution's weights their mean over the kernel's taps, so that a
feature map's constant part adds nothing to the output: an output channel's
offset then no longer depends on the draw, and neither does how many
anchors pass a score threshold.  Every floating tensor of the model is
one slice of a single normal draw from a ``torch.Generator`` on the device,
seeded with ``--seed``; integer buffers are zero.  The keys and shapes are
the reference model's, which are the published ``state_dict``'s, so the
same dict loads into the program and into the reference.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

import torch

from mpn_bench.reference import model as ref_model


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _std(rule: dict, shape) -> float:
    std = rule.get("std", 0.0)
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    if std == "he":
        std = math.sqrt(2.0 / fan_in)
    elif std == "lecun":
        std = math.sqrt(1.0 / fan_in)
    return float(std) * float(rule.get("scale", 1.0))


def _rule(rules: List[dict], key: str) -> dict:
    for r in rules:
        if re.search(r["match"], key):
            return r
    raise ValueError(f"no init rule matches {key!r}")


def make_state_dict(cfg: dict, seed: int, device, mode: str
                    ) -> Dict[str, torch.Tensor]:
    """The configuration's seeded float32 ``state_dict`` on ``device`` for
    ``mode`` (``serve`` or ``train_detection``), whose own ``init`` rules
    come before the configuration's."""
    skeleton = ref_model.build(cfg, "meta").state_dict()
    rules = cfg[mode].get("init", []) + cfg["init"]
    keys, shapes, stds, means, centred = [], [], [], [], []
    out: Dict[str, torch.Tensor] = {}
    for key, t in skeleton.items():
        if not t.is_floating_point():
            out[key] = torch.zeros(t.shape, dtype=t.dtype, device=device)
            continue
        r = _rule(rules, key)
        keys.append(key)
        shapes.append(tuple(t.shape))
        stds.append(_std(r, t.shape))
        means.append(float(r.get("mean", 0.0)))
        if r.get("zero_sum_taps"):
            centred.append(key)
    sizes = torch.tensor([math.prod(s) for s in shapes], device=device)
    flat = torch.randn(int(sizes.sum()), generator=generator(seed, device),
                       device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device), sizes))
    flat.add_(torch.repeat_interleave(torch.tensor(means, device=device), sizes))
    for key, shape, piece in zip(keys, shapes,
                                 flat.split(sizes.tolist())):
        out[key] = piece.view(shape)
    for key in centred:
        out[key].sub_(out[key].mean(dim=(2, 3), keepdim=True))
    return dict((k, out[k]) for k in skeleton)


@torch.no_grad()
def calibrate_classifier(cfg: dict, state_dict: Dict[str, torch.Tensor],
                         images_rgb: torch.Tensor) -> float:
    """Set the classifier's output bias in ``state_dict`` so that the float32
    reference, on ``images_rgb`` (packed uint8 frames), scores on average
    ``serve.calibrate.anchors_per_frame`` anchors above the test threshold:
    a fixed number of people a frame whatever the seed's draw.  Returns the
    bias."""
    from mpn_bench.reference import model as ref

    c = cfg["serve"]["calibrate"]
    m = ref.build(cfg, images_rgb.device)
    m.load_state_dict(state_dict)
    m.eval()
    key = "classificationModel.output.bias"
    bias = state_dict[key]
    cls = torch.cat([m.full_forward(ref.preprocess(images_rgb[i:i + 4]))[1]
                     for i in range(0, images_rgb.shape[0], 4)])
    # logits without the bias, per anchor (anchor type fastest)
    u = torch.logit(cls.double()).reshape(cls.shape[0], -1, bias.numel()) \
        - bias.double()
    t = float(torch.logit(torch.tensor(cfg["serve"]["test_score_thresh"],
                                       dtype=torch.float64)))
    k = int(round(c["anchors_per_frame"] * cls.shape[0]))
    top = torch.topk(u.flatten(), k + 1).values
    # halfway between the k-th and the (k+1)-th largest passes exactly k
    b = t - 0.5 * float(top[k - 1] + top[k])
    bias.fill_(b)
    return b
