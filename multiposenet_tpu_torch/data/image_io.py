"""Image files for the port's datasets and evaluator: the counterpart of
``cv2.imread(path, flags)``, whose pixels the JAX package reads.

PNG is decoded here, with ``zlib`` and numpy: 8-bit gray, gray + alpha,
RGB, RGBA and palette images, not interlaced, with any of the five row
filters (libpng, which wrote the reference's ``mask_miss`` files, picks
Average and Paeth rows among the others).  As cv2 does, colour is returned
as BGR, alpha is dropped, and ``flags=0`` turns colour into gray with
libpng's integer weights, as cv2 does.  What the decoder does not take (16-bit samples,
bit depths below 8, interlacing, a chunk whose CRC is wrong) raises.

Any other format (COCO's JPEGs) goes to cv2 when it is installed; without
it the read raises a ``RuntimeError`` that names the file.  A missing file
gives None, as ``cv2.imread`` does.

``write_png`` is ``cv2.imwrite``'s counterpart for PNG: a uint8 gray or BGR
image as an 8-bit PNG that reads back as the same pixels.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1
# channels per colour type: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# cv2's gray from colour PNG samples: libpng's rgb_to_gray with 0.299 and
# 0.587, truncated to 1/32768 (blue takes the rest), and the sum truncated
_GRAY_WEIGHTS = (9797, 19234, 3737)


class PNGError(ValueError):
    """A PNG file this decoder cannot or may not read."""


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc_at = pos + 8 + length
        if len(body) != length or crc_at + 4 > len(data):
            raise PNGError("truncated chunk")
        (crc,) = struct.unpack(">I", data[crc_at: crc_at + 4])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise PNGError(f"CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise PNGError("no IEND chunk")


def _wavefront(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo any row filters of a whole image along its anti-diagonals:
    pixel (r, x) follows (r, x - 1), (r - 1, x) and (r - 1, x - 1), so
    diagonal k = r + x is one vectorised step over all rows.  The image
    is held skewed, pixel (r, x) at [r + x + 2, r + 1] with zero padding
    above and to the left, so that every step reads and writes contiguous
    slices."""
    h, w, bpp = filt.shape
    rr, xx = np.mgrid[0:h, 0:w]
    skew = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    fs = np.zeros_like(skew)
    fs[rr + xx + 2, rr + 1] = filt
    ft = ftype[:, None]
    avg, paeth = (ftype == 3).any(), (ftype == 4).any()
    for k in range(h + w - 1):
        lo, hi = max(0, k - w + 1), min(h - 1, k) + 1
        a = skew[k + 1, lo + 1: hi + 1]
        b = skew[k + 1, lo: hi]
        c = skew[k, lo: hi]
        zero = np.zeros_like(a)
        choices = [zero, a, b, (a + b) >> 1 if avg else zero, zero]
        if paeth:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            choices[4] = np.where((pa <= pb) & (pa <= pc), a,
                                  np.where(pb <= pc, b, c))
        pred = np.choose(ft[lo: hi], choices)
        skew[k + 2, lo + 1: hi + 1] = (fs[k + 2, lo + 1: hi + 1] + pred) & 255
    return skew[rr + xx + 2, rr + 1].astype(np.uint8)


def _average_paeth_row(f: int, line: np.ndarray, prev: np.ndarray, bpp: int):
    """Undo one Average (3) or Paeth (4) row byte by byte."""
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if f == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 255
            continue
        c = up[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return np.frombuffer(bytes(out), np.uint8).reshape(line.shape)


def _undo_up(out: np.ndarray, filt: np.ndarray, up: np.ndarray, a: int, b: int):
    """Undo the Up rows among rows [a, b) in place, every other row there
    and row a - 1 being known: an Up row is the last known row above it
    plus the sum of the filtered rows since, all rows in one step (uint8
    sums wrap modulo 256, as the filter's do)."""
    seg = up[a:b]
    if not seg.any():
        return
    n = b - a
    step = filt[a:b].copy()
    step[~seg] = 0
    csum = np.empty((n + 1,) + filt.shape[1:], np.uint8)
    csum[0] = 0
    np.cumsum(step, axis=0, dtype=np.uint8, out=csum[1:])
    # for each row, its last known row: 0 is row a - 1, k is row a + k - 1
    # (a known row is its own, so it keeps its value)
    last = np.maximum.accumulate(np.where(seg, 0, np.arange(1, n + 1)))
    known = np.empty_like(csum)
    known[0] = out[a - 1] if a else 0
    known[1:] = out[a:b]
    out[a:b] = known[last] + csum[1:] - csum[last]


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the row filters: ``raw`` holds h rows of a filter byte and
    w * bpp bytes.  None and Sub rows stand alone and are undone all at
    once, then the Up rows between Average and Paeth rows (``_undo_up``);
    Average and Paeth rows depend on their left neighbours, and are undone
    byte by byte when few, else the whole image goes along its
    anti-diagonals (``_wavefront``)."""
    rows = raw.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise PNGError(f"unknown row filter {int(ftype.max())}")
    filt = rows[:, 1:].reshape(h, w, bpp)
    slow = np.flatnonzero(ftype >= 3)
    # a row byte by byte costs ~1 us per byte, a diagonal step ~40 us
    if slow.size * w * bpp > 40 * (h + w):
        return _wavefront(filt, ftype)
    out = np.empty_like(filt)
    out[ftype == 0] = filt[ftype == 0]
    out[ftype == 1] = np.cumsum(filt[ftype == 1], axis=1, dtype=np.int64).astype(np.uint8)
    up = ftype == 2
    a = 0
    for r in slow.tolist() + [h]:
        _undo_up(out, filt, up, a, r)
        if r < h:
            prev = out[r - 1] if r else np.zeros((w, bpp), np.uint8)
            out[r] = _average_paeth_row(ftype[r], filt[r], prev, bpp)
        a = r + 1
    return out


def decode_png(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 BGR, or (H, W) gray for ``flags=0``,
    as ``cv2.imdecode`` gives them."""
    if not data.startswith(PNG_SIGNATURE):
        raise PNGError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise PNGError(f"unknown colour type {ctype}")
    if depth != 8:
        raise PNGError(f"{depth}-bit samples are not supported (8-bit only)")
    if interlace:
        raise PNGError("interlaced PNGs are not supported")
    if ctype == 3 and palette is None:
        raise PNGError("palette image without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise PNGError(f"image data holds {raw.size} bytes, expected "
                       f"{h * (1 + w * bpp)}")
    px = _unfilter(raw, h, w, bpp)
    if ctype == 3:
        if px.max(initial=0) >= len(palette):
            raise PNGError("palette index out of range")
        px = palette[px[:, :, 0]]
    elif ctype in (4, 6):
        px = px[:, :, :-1]                        # drop alpha, as cv2 does
    if px.shape[2] == 1:
        gray = px[:, :, 0]
        if flags == IMREAD_GRAYSCALE:
            return gray.copy()
        return np.repeat(gray[:, :, None], 3, axis=2)
    if flags == IMREAD_GRAYSCALE:
        wr, wg, wb = _GRAY_WEIGHTS
        rgb = px.astype(np.int32)
        return ((wr * rgb[:, :, 0] + wg * rgb[:, :, 1] + wb * rgb[:, :, 2])
                >> 15).astype(np.uint8)
    return np.ascontiguousarray(px[:, :, ::-1])


def read_image(path: str, flags: int = IMREAD_COLOR) -> Optional[np.ndarray]:
    """``cv2.imread(path, flags)`` for ``flags`` 1 (BGR) or 0 (gray):
    None when the file does not exist (or, as cv2 gives it, when cv2
    cannot decode a file that is not a PNG)."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"read_image takes flags 0 or 1, not {flags}")
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        try:
            return decode_png(data, flags)
        except PNGError as e:
            raise PNGError(f"{path}: {e}") from None
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: not a PNG file, and reading other formats needs cv2, "
            "which is not installed") from None
    return cv2.imread(path, flags)


def write_png(path: str, img: np.ndarray, filters: Sequence[int] = (1,)) -> None:
    """Write a uint8 (H, W) gray or (H, W, 3) BGR image as an 8-bit PNG
    whose row r is filtered with ``filters[r % len(filters)]`` (0 None,
    1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rgb = img[:, :, ::-1] if img.ndim == 3 else img[:, :, None]
    bpp = rgb.shape[2]
    x = rgb.reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                         # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                                   # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]                      # up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    ftype = np.asarray(filters)[np.arange(h) % len(filters)]
    pred = np.choose(ftype[:, None], [np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    rows = np.concatenate([ftype[:, None], (x - pred) & 255], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             2 if bpp == 3 else 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes(), 6))
                + chunk(b"IEND", b""))
