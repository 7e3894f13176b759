"""Serving artifacts: the whole pose pipeline as one serialized
``torch.export`` program — the port of multiposenet_tpu/engine/export_model.py.

``export_pose_pipeline`` traces ``E2EPosePipeline`` (preprocess -> FPN
forward -> decode -> NMS -> peaks -> PRN -> grouping) once, for one batch
size and input size, with the weights inside the program, and serializes it
with ``torch.export.save``.  ``load_pose_pipeline`` reads it back onto the
device asked for; it needs no config, no checkpoint and no model code.

Where it differs from the JAX artifact: that one pins the portable XLA NMS
and needs nothing of the package to run.  This program holds kernel K1 as
the operator ``mpn::nms_suppress`` (ops/nms.py), so loading it needs
``import multiposenet_tpu_torch`` (done here), and it runs the CUDA kernel
on the card and the plain twin on the CPU.

Three things the trace does not carry, and what is done about them:
- bf16 autocast is traced as a region (``wrap_with_autocast``) that names
  the export device; ``load_pose_pipeline`` names the load device in it.
  The program is kept in the form the trace gives, not lowered further: a
  lowered program writes each reshape as a view of the strides seen while
  tracing, and the strides of a convolution's output differ between the CPU
  and the GPU;
- the float32 TF32 switches are process state, not graph: the pipeline
  turns TF32 off around its forward (engine/inference.full_fp32_matmul),
  and ``ServingPipeline.__call__`` does the same around the program;
- the export device, named by every ``.to(device)`` and factory call, is
  rewritten by ``torch.export.passes.move_to_device_pass`` at load time.
The pipeline's constant tensors (anchors, PRN blur matrices, joint
selector, preprocessing statistics, peak upsampling matrix) become the
program's constants, which move with it.
"""

from __future__ import annotations

import io
import os
from typing import Union

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from multiposenet_tpu_torch.config import Config, resolve_device
from multiposenet_tpu_torch.engine.inference import (
    E2EPosePipeline,
    PoseAssignments,
    full_fp32_matmul,
)
from multiposenet_tpu_torch.models.posenet import PoseNet
from multiposenet_tpu_torch.ops import nms as _nms  # noqa: F401  registers mpn::nms_suppress


class _Serving(nn.Module):
    """(images, scales) -> the 8 PoseAssignments tensors as a plain tuple;
    the model is a submodule, so its weights are the program's state."""

    def __init__(self, pipe: E2EPosePipeline):
        super().__init__()
        self.model = pipe.base.model
        self.pipe = pipe

    def forward(self, images: torch.Tensor, scales: torch.Tensor):
        return tuple(self.pipe(images, scales)[1])


def export_program(model: PoseNet, cfg: Config, batch: int,
                   device=None) -> torch.export.ExportedProgram:
    """The traced program of ``(images uint8[batch, inp, inp, 3], scales
    float32[batch]) -> tuple(PoseAssignments)``, ``inp =
    cfg.eval.inp_size``, traced on ``device`` (``cuda`` unless the caller
    names another) with ``model``'s weights inside."""
    dev = resolve_device(device)
    inp = cfg.eval.inp_size
    pipe = E2EPosePipeline(model, cfg, (inp, inp), device=dev)
    example = (torch.zeros((batch, inp, inp, 3), dtype=torch.uint8, device=dev),
               torch.ones(batch, dtype=torch.float32, device=dev))
    return torch.export.export(_Serving(pipe), example, strict=False)


def save_program(program: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_pose_pipeline(model: PoseNet, cfg: Config, batch: int,
                         device=None) -> bytes:
    """``export_program`` serialized: the artifact's bytes."""
    return save_program(export_program(model, cfg, batch, device))


class ServingPipeline:
    """A loaded artifact: ``(images, scales) -> PoseAssignments``.  Batch
    size and input size come from the program's own input signature."""

    def __init__(self, program: torch.export.ExportedProgram,
                 device: torch.device):
        self.program = program
        self.device = device
        names = program.graph_signature.user_inputs
        shapes = {n.name: n.meta["val"].shape for n in program.graph.nodes
                  if n.op == "placeholder" and n.name in names}
        images = shapes[names[0]]
        self.batch = int(images[0])
        self.inp_size = int(images[1])
        self._module = program.module()

    def __call__(self, images: torch.Tensor, scales: torch.Tensor
                 ) -> PoseAssignments:
        with torch.no_grad(), full_fp32_matmul():
            return PoseAssignments(*self._module(images, scales))


def load_pose_pipeline(src: Union[str, bytes, os.PathLike],
                       device=None) -> ServingPipeline:
    """``src`` is the path of an ``export_pose_pipeline`` artifact or its
    bytes; the program runs on ``device`` (``cuda`` unless the caller names
    another), whatever device it was exported on."""
    dev = resolve_device(device)
    if isinstance(src, (bytes, bytearray)):
        src = io.BytesIO(src)
    program = move_to_device_pass(torch.export.load(src), dev)
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.target is torch.ops.higher_order.wrap_with_autocast:
                    node.args = (dev.type,) + tuple(node.args[1:])
            gm.recompile()
    return ServingPipeline(program, dev)
