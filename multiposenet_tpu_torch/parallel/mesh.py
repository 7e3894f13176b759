"""Devices of one process — the port's counterpart of
multiposenet_tpu/parallel/mesh.py.

In the JAX package a ``Mesh`` over every chip carries both training (the
batch sharded, parameters replicated, XLA all-reducing the gradients) and
sharded serving.  In PyTorch, training over N GPUs is N processes
(``parallel.distributed``, ``DistributedDataParallel`` in the train steps),
so a ``Mesh`` here serves one process that drives several devices: the
weights replicated on each (``replicated``), a batch split on dim 0
(``shard_batch``), each slice run on its replica
(``engine/inference.make_sharded_e2e_pipeline``).  A device may appear more
than once, so that one GPU (or the CPU) can stand in for several.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices a batch is split over, in order."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh over ``devices`` (default: every visible GPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh without devices takes every GPU, "
                               "and none is available; pass devices=")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(_indexed(torch.device(d)) for d in devices))


def _indexed(d: torch.device) -> torch.device:
    # "cuda" names the current GPU; a parameter's device always has an index
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


Batch = Union[torch.Tensor, Mapping[str, torch.Tensor]]


def shard_batch(mesh: Mesh, batch: Batch) -> List[Batch]:
    """Split a tensor, or a dict of tensors, on dim 0 into one slice per
    device of the mesh, each moved to its device (``non_blocking``: pass
    pinned host memory for copies that overlap).  The batch must divide
    evenly."""
    def split(t: torch.Tensor) -> List[torch.Tensor]:
        if t.shape[0] % mesh.size:
            raise ValueError(f"batch of {t.shape[0]} does not split over "
                             f"{mesh.size} devices")
        return [s.to(d, non_blocking=True)
                for s, d in zip(t.chunk(mesh.size), mesh.devices)]

    if isinstance(batch, torch.Tensor):
        return split(batch)
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(mesh.size)]


def replicated(mesh: Mesh, module: nn.Module) -> List[nn.Module]:
    """One copy of ``module`` per device of the mesh.  A device that appears
    more than once gets one copy, shared by its entries; the device the
    module is on gets the module itself."""
    home = next(module.parameters()).device
    copies: Dict[torch.device, nn.Module] = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = module if d == home else copy.deepcopy(module).to(d)
    return [copies[d] for d in mesh.devices]
