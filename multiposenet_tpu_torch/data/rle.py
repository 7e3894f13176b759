"""COCO mask utilities — the port's copy of multiposenet_tpu/data/rle.py
(standing in for pycocotools.maskUtils), in numpy, with polygons filled by
``data/imgproc.fill_poly`` instead of ``cv2.fillPoly``.

- ``decode_rle``: compressed (COCO's LEB128-style string) or uncompressed
  (counts list) RLE -> binary mask.  Counts are run lengths of
  alternating 0/1 in column-major (Fortran) order.
- ``encode_rle``: mask -> compressed RLE (for writing results).
- ``ann_to_mask``: polygon / RLE annotation -> mask (reference
  datasets/coco_data/COCO_data_pipeline.py:43-71 annToRLE/annToMask).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from multiposenet_tpu_torch.data.imgproc import fill_poly


def _decode_counts(counts_str: Union[str, bytes]) -> List[int]:
    """Decode COCO's compressed counts string (signed LEB128 variant)."""
    if isinstance(counts_str, str):
        counts_str = counts_str.encode("ascii")
    counts: List[int] = []
    i = 0
    n = len(counts_str)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = counts_str[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_counts(counts: Sequence[int]) -> str:
    """Inverse of ``_decode_counts`` (pycocotools rleToString)."""
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def decode_rle(rle: Dict) -> np.ndarray:
    """RLE dict {'size': [h, w], 'counts': str|bytes|list} -> (h, w) uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_counts(counts)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1  # runs alternate 0,1,0,1,...
    flat = np.repeat(vals, counts)
    if total < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - total, np.uint8)])
    return flat[: h * w].reshape((w, h)).T  # column-major


def encode_rle(mask: np.ndarray) -> Dict:
    """(h, w) binary mask -> compressed RLE dict (pycocotools-compatible)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    # run-length encode with a leading zero-run
    change = np.flatnonzero(np.diff(flat)) + 1
    idx = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(idx).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    if not flat.size:
        runs = [0]
    return {"size": [h, w], "counts": _encode_counts(runs)}


def polys_to_mask(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterise a COCO polygon list (merged, even-odd) -> (h, w) uint8."""
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polys if len(p) >= 6]
    if pts:
        fill_poly(mask, pts, 1)
    return mask


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """COCO annotation (polygon, uncompressed or compressed RLE) -> mask."""
    segm = ann["segmentation"]
    if isinstance(segm, list):
        return polys_to_mask(segm, h, w)
    if isinstance(segm["counts"], list):
        return decode_rle({"size": segm["size"], "counts": segm["counts"]})
    return decode_rle(segm)


def mask_area(rle_or_mask) -> int:
    if isinstance(rle_or_mask, dict):
        return int(decode_rle(rle_or_mask).sum())
    return int(np.asarray(rle_or_mask).sum())
