"""Fold the trunk's BatchNorms into the convolutions before them (inference
only) — the port of multiposenet_tpu/models/fold_bn.py.

At inference every BatchNorm of the ResNet trunk (the only BNs in the
network; each follows a conv without bias, reference network/fpn.py:9-42)
is a fixed per-channel affine ``y = gamma * (x - mean) / sqrt(var + eps) +
beta``, which folds exactly into the conv:

    w' = w * s        (s = gamma / sqrt(var + eps), per output channel)
    b' = beta - mean * s

``fold_bn_state_dict`` rewrites a ``state_dict`` of the unfolded graph into
one of the ``fold_bn=True`` graph (``ModelConfig.fold_bn``,
models/fpn.py): each paired conv gains a ``bias`` and every trunk BN key
goes.  The fold is computed in float64 and stored in float32, as the JAX
package folds, so the result equals ``weights.state_dict_from_flax`` of
JAX ``fold_bn_variables`` bit for bit.

Unlike XLA, eager PyTorch runs each trunk BN as a kernel of its own that
reads and writes the conv's whole output; the folded graph adds the bias
inside the conv.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import torch

from multiposenet_tpu_torch.models.fpn import BN_EPS

# (conv, BN) module names: the stem at ``fpn.`` and, inside each Bottleneck,
# conv1..3 / bn1..3 and the downsample pair
_BN_TO_CONV = {"bn1": "conv1", "bn2": "conv2", "bn3": "conv3",
               "downsample.1": "downsample.0"}
_BN_KEY = re.compile(
    r"^(fpn\.(?:layer\d\.\d+\.)?)(bn[123]|downsample\.1)\."
    r"(weight|bias|running_mean|running_var|num_batches_tracked)$")


def fold_bn_state_dict(sd: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Unfolded ``state_dict`` -> the ``fold_bn=True`` graph's.

    Every trunk (conv, BN) pair is folded; every other key passes through
    unchanged.  Raises on a BN without its conv and on a paired conv that
    already has a bias."""
    bns: Dict[Tuple[str, str], Dict[str, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        m = _BN_KEY.match(key)
        if m:
            bns.setdefault((m.group(1), m.group(2)), {})[m.group(3)] = value
        else:
            out[key] = value
    for (prefix, name), p in bns.items():
        conv = prefix + _BN_TO_CONV[name]
        if f"{conv}.weight" not in out:
            raise ValueError(f"BN '{prefix}{name}' has no paired conv '{conv}'")
        if f"{conv}.bias" in out:
            raise ValueError(f"paired conv '{conv}' already has a bias")
        w = out[f"{conv}.weight"]
        s = (p["weight"].double()
             / torch.sqrt(p["running_var"].double() + BN_EPS))
        out[f"{conv}.weight"] = (w.double() * s[:, None, None, None]).to(w.dtype)
        out[f"{conv}.bias"] = (p["bias"].double()
                               - p["running_mean"].double() * s).to(w.dtype)
    return out
