"""Flax parameter trees -> the port's ``state_dict``.

The key mapping of the JAX package's reference exporter
(tools/export_torch_ckpt.py:34-117), kept here so the port reads JAX
checkpoints without importing anything of the JAX package: conv kernels go
HWIO -> OIHW, Dense kernels (in, out) -> Linear (out, in), BatchNorm
scale / bias / mean / var -> weight / bias / running_mean / running_var.
The keys are the reference poseNet's, which ``models/posenet.PoseNet`` uses
as its module names, so the result loads with ``strict=True``.

The reference's own checkpoint files are HDF5, one dataset per
``state_dict`` key plus an ``epoch`` attribute (reference
network/net_utils.py:30-66): ``write_reference_h5`` writes a port
``state_dict`` in that layout (the counterpart of the JAX package's
tools/export_torch_ckpt.py) and ``read_reference_h5`` reads one back (of
tools/convert_torch_ckpt.py).  ``h5py`` is imported when they are called.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# Flax top-level module -> attribute prefix on PoseNet; the keypoint-head
# convs sit on PoseNet itself, hence the empty prefix
_TOP_PREFIX = {
    "fpn": "fpn",
    "keypoint_head": "",
    "regression_head": "regressionModel",
    "classification_head": "classificationModel",
    "prn": "prn",
}


def torch_key(path: Tuple[str, ...], leaf: str) -> str:
    """Flax module path + torch leaf name -> state_dict key."""
    top = path[0]
    if top not in _TOP_PREFIX:
        raise KeyError(f"unknown top-level module {path}")
    if top == "fpn" and len(path) == 3:
        # fpn.layerX_N.(convY|bnY|downsample_conv|downsample_bn)
        m = re.match(r"layer(\d)_(\d+)$", path[1])
        if not m:
            raise KeyError(f"unrecognized fpn block {path}")
        mod = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}.get(path[2], path[2])
        return f"fpn.layer{m.group(1)}.{m.group(2)}.{mod}.{leaf}"
    parts = [p for p in (_TOP_PREFIX[top], ".".join(path[1:])) if p]
    return ".".join(parts + [leaf])


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (arrays or numpy) ->
    ``{key: tensor}`` for ``PoseNet.load_state_dict(..., strict=True)``.
    Float leaves become float32; each BatchNorm also gets a zero
    ``num_batches_tracked``."""
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, arr: np.ndarray) -> None:
        out[key] = torch.from_numpy(np.array(arr, np.float32))

    for path, arr in _flatten(variables["params"]):
        mod, leaf = path[:-1], path[-1]
        if leaf == "kernel" and arr.ndim == 4:
            put(torch_key(mod, "weight"), arr.transpose(3, 2, 0, 1))
        elif leaf == "kernel" and arr.ndim == 2:
            put(torch_key(mod, "weight"), arr.T)
        elif leaf == "scale":
            put(torch_key(mod, "weight"), arr)
        elif leaf == "bias":
            put(torch_key(mod, "bias"), arr)
        else:
            raise ValueError(f"unexpected param {path} of shape {arr.shape}")
    for path, arr in _flatten(variables.get("batch_stats", {})):
        mod, leaf = path[:-1], path[-1]
        if leaf == "mean":
            put(torch_key(mod, "running_mean"), arr)
        elif leaf == "var":
            put(torch_key(mod, "running_var"), arr)
            out[torch_key(mod, "num_batches_tracked")] = torch.tensor(
                0, dtype=torch.int64)
        else:
            raise ValueError(f"unexpected batch_stats leaf {path}")
    return out


def write_reference_h5(state_dict: Mapping[str, torch.Tensor], path: str,
                       epoch: int = -1) -> None:
    """Write ``state_dict`` in the reference's checkpoint layout: one HDF5
    dataset per key, floating-point values as float32 (the layout's dtype;
    the port's parameters are float32 already), integers as they are, and
    the ``epoch`` attribute."""
    import h5py

    with h5py.File(path, mode="w") as f:
        for k, v in state_dict.items():
            a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            if a.dtype.kind == "f" and a.dtype != np.float32:
                a = a.astype(np.float32)
            f.create_dataset(k, data=a)
        f.attrs["epoch"] = epoch


def read_reference_h5(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """A checkpoint in the reference's HDF5 layout -> (state_dict of CPU
    tensors, epoch; -1 without the attribute).  Keys saved from an
    ``nn.DataParallel`` model lose their ``module.`` prefix."""
    import h5py

    out: Dict[str, torch.Tensor] = {}
    with h5py.File(path, mode="r") as f:
        for k, ds in f.items():
            key = k[len("module."):] if k.startswith("module.") else k
            out[key] = torch.from_numpy(np.asarray(ds[()]))
        epoch = int(f.attrs.get("epoch", -1))
    return out, epoch
