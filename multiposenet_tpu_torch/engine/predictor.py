"""BatchPredictor — the serving front, PyTorch twin of
multiposenet_tpu/engine/predictor.py.

- letterboxes arbitrary BGR images to the model's square input on the
  host (pad to a square, then a bilinear resize like cv2.resize
  INTER_LINEAR, done here without cv2),
- packs them into fixed-size batches, zero-padding a ragged tail, and
  uploads each batch from pinned memory,
- runs the whole pose pipeline (engine/inference.E2EPosePipeline) on the
  device per batch; only dict formatting runs on the host,
- unpacks per-image person results in original-image coordinates.

Batches are dispatched two deep: PyTorch queues batch k+1 on the device
while the host formats batch k.  With a ``mesh`` each batch is split over
the mesh's devices, one replica of the model on each
(engine/inference.make_sharded_e2e_pipeline).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiposenet_tpu_torch.config import Config, resolve_device
from multiposenet_tpu_torch.engine.inference import (
    PoseAssignments,
    format_pose_batch,
    make_e2e_pose_pipeline,
    make_sharded_e2e_pipeline,
)
from multiposenet_tpu_torch.models.posenet import PoseNet, build_posenet
from multiposenet_tpu_torch.parallel.mesh import Mesh


def resize_bilinear_u8(img: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, C) uint8 -> (size, size, C) uint8 with half-pixel-centre
    bilinear taps clamped at the border, the geometry of cv2.resize
    INTER_LINEAR.  cv2 rounds fixed-point weights, so the two differ by at
    most one uint8 step."""
    x = img.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)


class BatchPredictor:
    """Serve a PoseNet: ``predict(images_bgr) -> per-image person lists``.

    The model comes from ``state_dict`` (loaded strictly into a new PoseNet)
    or is passed ready-built as ``model``.  Runs on ``cuda`` unless
    ``device`` names another device; without a GPU and without an explicit
    ``device="cpu"`` it raises.  With ``mesh`` (parallel/mesh.make_mesh)
    every batch is split over the mesh's devices, the model replicated on
    each (``device`` is then the mesh's first device, where the outputs are
    gathered); ``batch_size`` must divide by the mesh's device count.
    """

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 batch_size: int = 8, device=None,
                 model: Optional[PoseNet] = None, mesh: Optional[Mesh] = None):
        if mesh is not None:
            if batch_size % mesh.size:
                raise ValueError(
                    f"batch_size {batch_size} must be divisible by the mesh "
                    f"device count {mesh.size} (batch-axis sharding)")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if model is None:
            if state_dict is None:
                raise ValueError("BatchPredictor needs a state_dict or a model")
            model = build_posenet(cfg.model, self.device, state_dict)
        self.cfg = cfg
        self.batch_size = batch_size
        self.inp = cfg.eval.inp_size
        self.model = model
        self.mesh = mesh
        if mesh is not None:
            self._pipeline = make_sharded_e2e_pipeline(
                model, cfg, (self.inp, self.inp), mesh)
        else:
            self._pipeline = make_e2e_pose_pipeline(
                model, cfg, (self.inp, self.inp), device=self.device)

    @classmethod
    def from_exported(cls, src, device=None) -> "BatchPredictor":
        """Serve from an ``engine/export_model`` artifact (a path or its
        bytes) on ``device`` (``cuda`` unless the caller names another).
        The weights are inside the program, so there is no config and no
        model (``cfg`` and ``model`` are None); the batch size and input
        size come from the program's input signature.  Packing, the pinned
        upload and the two-deep dispatch are those of a live predictor."""
        from multiposenet_tpu_torch.engine.export_model import load_pose_pipeline

        sp = load_pose_pipeline(src, device)
        self = cls.__new__(cls)
        self.device = sp.device
        self.cfg = None
        self.model = None
        self.mesh = None
        self.batch_size = sp.batch
        self.inp = sp.inp_size
        self._pipeline = lambda images, scales: (None, sp(images, scales))
        return self

    # -- host-side packing ------------------------------------------------

    def _pack(self, img_bgr: np.ndarray) -> Tuple[torch.Tensor, float]:
        """BGR (H, W, 3) uint8 -> RGB (inp, inp, 3) uint8 on the host and
        the scale from model pixels back to original pixels.  The image is
        zero-padded to a square at the bottom/right; when that square is
        already ``inp`` wide no resize runs and the pixels are exact."""
        inp = self.inp
        shape_dst = int(np.max(img_bgr.shape[:2]))
        scale = float(shape_dst) / inp
        pad = abs(img_bgr.shape[1] - img_bgr.shape[0])
        sq = np.pad(img_bgr, ([0, pad], [0, pad], [0, 0]),
                    "constant")[:shape_dst, :shape_dst]
        t = torch.from_numpy(np.ascontiguousarray(sq))
        if shape_dst != inp:
            t = resize_bilinear_u8(t, inp)
        return t.flip(-1), scale

    # -- public API --------------------------------------------------------

    @staticmethod
    def _finish_chunk(assigns: PoseAssignments, n_real: int) -> List[List[Dict]]:
        """Fetch one dispatched chunk and format it per image."""
        return format_pose_batch(assigns.cpu())[:n_real]

    def predict(self, images_bgr: Sequence[np.ndarray]) -> List[List[Dict]]:
        """BGR images (any sizes) -> per-image person result lists."""
        results: List[List[Dict]] = []
        pending = []
        for lo in range(0, len(images_bgr), self.batch_size):
            chunk = images_bgr[lo: lo + self.batch_size]
            pin = self.device.type == "cuda"
            batch = torch.zeros((self.batch_size, self.inp, self.inp, 3),
                                dtype=torch.uint8, pin_memory=pin)
            scales = torch.ones(self.batch_size, dtype=torch.float32,
                                pin_memory=pin)
            for i, im in enumerate(chunk):
                batch[i], scales[i] = self._pack(im)
            # pinned uploads queue behind the device's work instead of
            # waiting for it; a mesh uploads each device's slice itself
            if self.mesh is None:
                batch = batch.to(self.device, non_blocking=True)
                scales = scales.to(self.device, non_blocking=True)
            _, assigns = self._pipeline(batch, scales)
            pending.append((assigns, len(chunk)))
            if len(pending) > 2:
                results.extend(self._finish_chunk(*pending.pop(0)))
        for assigns, n_real in pending:
            results.extend(self._finish_chunk(assigns, n_real))
        return results

    def predict_stream(self, images: Iterable[np.ndarray]
                       ) -> Iterable[List[Dict]]:
        buf: List[np.ndarray] = []
        for im in images:
            buf.append(im)
            if len(buf) == self.batch_size:
                yield from self.predict(buf)
                buf = []
        if buf:
            yield from self.predict(buf)
