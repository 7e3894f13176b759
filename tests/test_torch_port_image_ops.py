"""multiposenet_tpu_torch's cv2-free image operators (data/imgproc.py) and
PNG reader (data/image_io.py) against cv2 itself, which this environment
has and the JAX package calls: INTER_CUBIC and INTER_AREA resizes, the
rotation the augmentation applies (JAX ``_rotate_bound``: the matrix of
cv2.getRotationMatrix2D and cv2.warpAffine INTER_CUBIC), cv2.fillPoly, and
cv2.imread of PNG files.

Limits: resized and warped uint8 images within 1 level, on at most 1% of
the pixels (cv2 hands the cubic resize to IPP, which sums in float32; the
port equals it but where a sum lands within ~1e-5 of x.5); area resizes,
the rotation matrix, output sizes, polygon fills and PNG decodes exact."""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from multiposenet_tpu.data import augment as jaug

import chip_smoke
from multiposenet_tpu_torch.data import augment, image_io, imgproc
from multiposenet_tpu_torch.engine.evaluator import read_image_bgr

SCALES = (0.37, 0.8, 1.0, 1.34, 1.9)
ANGLES = (-40.0, -13.7, 0.0, 25.0, 40.0)


def _image(rng, h, w, channels):
    """Blurred noise with some flat regions: gradients and edges both."""
    shape = (h, w, channels) if channels == 3 else (h, w)
    img = cv2.GaussianBlur(rng.randint(0, 256, shape).astype(np.uint8), (5, 5), 1.5)
    img[h // 3: h // 2, w // 4: w // 2] = 200
    return img


def _within_one_level(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.abs(got.astype(np.int64) - want)
    share = float((diff > 0).mean())
    assert diff.max() <= 1, (what, int(diff.max()))
    assert share <= 0.01, (what, share)
    return share


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("scale", SCALES)
def test_resize_cubic_matches_cv2(scale, channels):
    rng = np.random.RandomState(int(scale * 100) + channels)
    img = _image(rng, 97, 131, channels)
    want = cv2.resize(img, (0, 0), fx=scale, fy=scale, interpolation=cv2.INTER_CUBIC)
    _within_one_level(imgproc.resize_cubic(img, scale), want, f"u8 x{scale}")
    f32 = img.astype(np.float32) / 7.0
    want32 = cv2.resize(f32, (0, 0), fx=scale, fy=scale, interpolation=cv2.INTER_CUBIC)
    got32 = imgproc.resize_cubic(f32, scale)
    assert got32.shape == want32.shape
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-4)


@pytest.mark.parametrize("scale", [0.37, 0.5, 1 / 3, 0.25, 0.8, 1.34, 1.9])
def test_resize_area_matches_cv2(scale):
    """Shrink (area weights), integer inverse scales (block means) and
    growth (2-tap fixed point), on a binary mask and on an image."""
    rng = np.random.RandomState(7)
    mask = (rng.rand(61, 83) < 0.3).astype(np.uint8)
    for img in (mask, _image(rng, 61, 83, 3)):
        want = cv2.resize(img, (0, 0), fx=scale, fy=scale, interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(imgproc.resize_area_u8(img, scale), want)


@pytest.mark.parametrize("angle", ANGLES)
def test_rotate_bound_matches_jax(angle):
    """The port's rotation against the JAX package's (cv2) on an image
    (border 128) and a mask (border 255): matrix and canvas exact."""
    rng = np.random.RandomState(3)
    for img, border in ((_image(rng, 83, 117, 3), (128, 128, 128)),
                        (_image(rng, 83, 117, 1), 255)):
        want, m_want = jaug._rotate_bound(img, angle, border)
        got, m_got = augment._rotate_bound(img, angle, border)
        np.testing.assert_array_equal(m_got, m_want)
        _within_one_level(got, want, f"rotate {angle}")
        np.testing.assert_array_equal(
            imgproc.rotation_matrix_2d((58, 41), angle, 1.0),
            cv2.getRotationMatrix2D((58, 41), angle, 1.0))


def _random_polys(rng, kind, h, w):
    if kind == "concave":
        t = np.sort(rng.uniform(0, 2 * np.pi, 12))
        r = np.where(np.arange(12) % 2, 0.45, 0.2) * min(h, w)
        return [np.stack([w / 2 + r * np.cos(t), h / 2 + r * np.sin(t)], 1)]
    if kind == "self_intersecting":
        return [rng.uniform(0, [w, h], (9, 2))]
    if kind == "out_of_frame":
        return [rng.uniform([-20, -20], [w + 20, h + 20], (6, 2))]
    # several polygons at once, overlapping (even-odd) and touching edges
    return [rng.uniform(0, [w, h], (5, 2)) for _ in range(3)] + [
        np.array([[0, 0], [w, 0], [w, h / 3]])]


@pytest.mark.parametrize("kind", ["concave", "self_intersecting",
                                  "out_of_frame", "several"])
def test_fill_poly_matches_cv2(kind):
    rng = np.random.RandomState(len(kind))
    for trial in range(20):
        h, w = rng.randint(20, 90, 2)
        polys = [p.round().astype(np.int32) for p in _random_polys(rng, kind, h, w)]
        got = imgproc.fill_poly(np.zeros((h, w), np.uint8), polys, 1)
        want = cv2.fillPoly(np.zeros((h, w), np.uint8), polys, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {trial}")


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "mask"])
def test_read_png_written_by_cv2(kind, tmp_path):
    rng = np.random.RandomState(1)
    img = {"gray": _image(rng, 45, 67, 1), "bgr": _image(rng, 45, 67, 3),
           "bgra": rng.randint(0, 256, (45, 67, 4)).astype(np.uint8),
           "mask": (rng.rand(45, 67) < 0.5).astype(np.uint8) * 255}[kind]
    for level in (0, 9):
        path = str(tmp_path / f"{kind}{level}.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        for flags in (1, 0):
            np.testing.assert_array_equal(image_io.read_image(path, flags),
                                          cv2.imread(path, flags))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     chip_smoke.PNG_FILTERS, (4, 3, 4, 2),
                                     (1, 2, 2, 0, 2, 3, 2, 2)])
def test_read_png_every_row_filter(filters, tmp_path):
    """PNGs whose rows carry each filter (the smoke test's writer): the
    byte-by-byte rows, runs of Up rows below them, and the anti-diagonal
    path when Average and Paeth rows are many."""
    rng = np.random.RandomState(2)
    for img in (_image(rng, 37, 53, 3), _image(rng, 37, 53, 1)):
        path = str(tmp_path / "f.png")
        chip_smoke.write_png(path, img, filters)
        for flags in (1, 0):
            np.testing.assert_array_equal(image_io.read_image(path, flags),
                                          cv2.imread(path, flags))


def _png_bytes(ihdr, rows, crc_ok=True):
    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc if crc_ok else crc ^ 1)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["16bit", "interlaced", "bad_crc", "palette_4bit"])
def test_unsupported_png_raises(case, tmp_path):
    path = str(tmp_path / "x.png")
    if case == "16bit":
        cv2.imwrite(path, np.arange(12, dtype=np.uint16).reshape(3, 4) * 1000)
    else:
        depth, ctype, interlace = {"interlaced": (8, 0, 1), "bad_crc": (8, 0, 0),
                                   "palette_4bit": (4, 3, 0)}[case]
        ihdr = struct.pack(">IIBBBBB", 4, 3, depth, ctype, 0, 0, interlace)
        with open(path, "wb") as f:
            f.write(_png_bytes(ihdr, bytes(3 * 5), crc_ok=case != "bad_crc"))
    with pytest.raises(image_io.PNGError):
        image_io.read_image(path)


def test_read_image_missing_and_without_cv2(tmp_path, monkeypatch):
    """A missing file is None (as cv2.imread); a JPEG without cv2 raises
    naming the file; a PNG needs no cv2, in the evaluator's reader too."""
    assert image_io.read_image(str(tmp_path / "none.png")) is None
    img = _image(np.random.RandomState(4), 20, 30, 3)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="a.jpg"):
        image_io.read_image(str(tmp_path / "a.jpg"))
    np.testing.assert_array_equal(read_image_bgr(str(tmp_path), "a.png"), img)
    assert read_image_bgr(str(tmp_path), "none.png") is None


@pytest.mark.parametrize("op", ["cubic", "area", "warp"])
def test_windows_equal_the_full_output(op):
    """An operator's window equals the same window of its whole output, so
    the datasets may compute only what their crop keeps."""
    rng = np.random.RandomState(5)
    for trial in range(12):
        h, w = rng.randint(8, 60, 2)
        img = _image(rng, h, w, 3 if trial % 2 else 1)
        scale = (0.31, 0.5, 1.7, 1 / 3)[trial % 4]
        if op == "warp":
            border = (128, 128, 128) if img.ndim == 3 else 0
            if img.ndim == 2:
                img = (img > 150).astype(np.uint8)
            m, (nw, nh) = augment._bound_rotation(h, w, rng.uniform(-40, 40))
            full = imgproc.warp_affine_cubic(img, m, (nw, nh), border)
            y0, x0 = rng.randint(0, nh), rng.randint(0, nw)
            win = imgproc.warp_window(lambda r0, r1, c0, c1: img[r0:r1, c0:c1],
                                      img.shape, m, (y0, nh, x0, nw), border,
                                      imgproc.content_box(img, border))
            np.testing.assert_array_equal(win, full[y0:, x0:])
            continue
        fn = imgproc.resize_cubic if op == "cubic" else imgproc.resize_area_u8
        full = fn(img, scale)
        y0, x0 = rng.randint(0, full.shape[0]), rng.randint(0, full.shape[1])
        y1, x1 = rng.randint(y0, full.shape[0] + 1), rng.randint(x0, full.shape[1] + 1)
        np.testing.assert_array_equal(fn(img, scale, window=(y0, y1, x0, x1)),
                                      full[y0:y1, x0:x1])
