"""The benchmark's one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and makes its inputs from ``--seed``.  The same
seed gives the same inputs; every seed gives the same set of sizes, in
another order, so that the work does not change with the seed.

Kinds:

- ``frame_stream``: a pool of ``pool_frames`` BGR uint8 frames of noise,
  an equal share of each ``sizes_hw`` entry, shuffled, which one client
  streams in order (closed loop) in batches of ``batch``;
- ``detection_batches``: ``pool_batches`` training batches of ``batch``
  square uint8 images of noise, each with 1 to ``boxes_max`` person boxes
  (geometric, parameter ``boxes_p``), sides log-uniform over
  ``[side_min, side_max]``, padded with -1 rows to ``pad_boxes``: the
  detection stage's batch layout, kept in pinned host memory as a loader
  would hand them over.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from mpn_bench.harness import derive_seed

SALT_PIXELS, SALT_ORDER, SALT_BOXES = 11, 12, 13


def _pixels(seed: int, shape, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, SALT_PIXELS))
    return torch.randint(0, 256, shape, generator=g, device=device,
                         dtype=torch.uint8)


def frame_pool(spec: dict, seed: int, device) -> List[np.ndarray]:
    """The ``frame_stream`` pool: a list of (h, w, 3) uint8 BGR frames."""
    sizes = [tuple(s) for s in spec["sizes_hw"]]
    n = int(spec["pool_frames"])
    if n % len(sizes):
        raise ValueError("pool_frames must be a multiple of the number of sizes")
    order = np.random.default_rng(derive_seed(seed, SALT_ORDER)).permutation(
        np.repeat(np.arange(len(sizes)), n // len(sizes)))
    hmax = max(h for h, _ in sizes)
    wmax = max(w for _, w in sizes)
    buf = _pixels(seed, (n, hmax, wmax, 3), device).cpu().numpy()
    return [buf[i, :sizes[k][0], :sizes[k][1]] for i, k in enumerate(order)]


def detection_boxes(spec: dict, seed: int, image_size: int) -> np.ndarray:
    """(pool_batches, batch, pad_boxes, 5) float32 x1y1x2y2 + class 0,
    padding rows -1."""
    if spec["side_max"] > image_size or spec["boxes_max"] > spec["pad_boxes"]:
        raise ValueError("boxes must fit the image and the padded rows")
    rng = np.random.default_rng(derive_seed(seed, SALT_BOXES))
    nb, b, pad = int(spec["pool_batches"]), int(spec["batch"]), int(spec["pad_boxes"])
    out = np.full((nb, b, pad, 5), -1.0, np.float32)
    lo, hi = np.log(spec["side_min"]), np.log(spec["side_max"])
    for i in range(nb):
        for j in range(b):
            k = int(min(rng.geometric(spec["boxes_p"]), spec["boxes_max"]))
            w, h = np.exp(rng.uniform(lo, hi, (2, k)))
            x1 = rng.uniform(0.0, image_size - w)
            y1 = rng.uniform(0.0, image_size - h)
            out[i, j, :k] = np.stack([x1, y1, x1 + w, y1 + h, np.zeros(k)], 1)
    return out


def detection_pool(spec: dict, seed: int, image_size: int, device
                   ) -> List[Dict[str, torch.Tensor]]:
    """The ``detection_batches`` pool: dicts ``{'image': (B, S, S, 3)
    uint8, 'boxes': (B, N, 5) float32}`` in pinned host memory (plain host
    memory when ``device`` is the CPU)."""
    nb, b = int(spec["pool_batches"]), int(spec["batch"])
    pin = torch.device(device).type == "cuda"
    imgs = _pixels(seed, (nb, b, image_size, image_size, 3), device).cpu()
    boxes = torch.from_numpy(detection_boxes(spec, seed, image_size))
    if pin:
        imgs, boxes = imgs.pin_memory(), boxes.pin_memory()
    return [{"image": imgs[i], "boxes": boxes[i]} for i in range(nb)]
