"""multiposenet_tpu_torch's renderer (eval/render.py), PNG writer
(data/image_io.write_png) and ``Evaluator.test``'s image output against cv2
and the JAX package on the CPU:

(d) the cv2-free primitives against cv2's (filled circle, thick rectangle,
    ellipse2Poly, fillConvexPoly at shift 0 and 16), fuzzed with points off
    the canvas, degenerate shapes and negative angles; ``plot_results``
    against JAX's, pixel for pixel, on 240 seeded people with v in {0, 0.5,
    1, 2} and zero-length limbs;
(e) ``write_png`` read back through cv2 and through the port's reader;
(f) ``test()`` with ``write_image``: both files per image, equal to the
    JAX evaluator's decoded files.
"""

import dataclasses
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.engine.evaluator import Evaluator as JEvaluator
from multiposenet_tpu.eval import render as jrender
from multiposenet_tpu.ops.anchors import anchors_for_shape
from multiposenet_tpu.ops.heatmap import make_heatmaps_np

from multiposenet_tpu_torch.data import image_io
from multiposenet_tpu_torch.engine.evaluator import Evaluator
from multiposenet_tpu_torch.eval import render
from torch_port_helpers import (
    ForwardStub,
    jax_config,
    perturbed_init,
    port_config,
    port_model,
)

SIZE = 64
H, W = 60, 80


def _canvas(rng):
    return rng.randint(0, 256, (H, W, 3), np.uint8)


def _color(rng):
    return tuple(int(c) for c in rng.randint(0, 256, 3))


def _pts(rng, lo, hi, n=2):
    return tuple(int(v) for v in rng.randint(lo, hi, n))


@pytest.mark.parametrize("primitive", ["circle", "rectangle", "fill_convex_poly",
                                       "fill_convex_poly_shift16", "ellipse"])
def test_primitives_equal_cv2(primitive):
    rng = np.random.RandomState(len(primitive))
    for _ in range(400):
        img = _canvas(rng)
        got, want = img.copy(), img.copy()
        col = _color(rng)
        if primitive == "circle":
            c, r = _pts(rng, -10, 90), int(rng.randint(0, 12))
            cv2.circle(want, c, r, col, thickness=-1)
            render.circle(got, c, r, col)
        elif primitive == "rectangle":
            p1, p2 = _pts(rng, -20, 100), _pts(rng, -20, 100)
            p2 = [p2, p1, (p1[0], p2[1]), (p2[0], p1[1])][rng.randint(4)]
            cv2.rectangle(want, p1, p2, col, thickness=2)
            render.rectangle(got, p1, p2, col, 2)
        elif primitive.startswith("fill_convex_poly"):
            shift = 16 if primitive.endswith("16") else 0
            n = int(rng.randint(1, 7))
            ctr, rad = rng.uniform(-20, 100, 2), rng.uniform(0, 40)
            ang = np.sort(rng.rand(n)) * 2 * np.pi
            pts = (np.stack([ctr[0] + rad * np.cos(ang), ctr[1] + rad * np.sin(ang)], 1)
                   * (1 << shift)).astype(np.int32)
            cv2.fillConvexPoly(want, pts, col, cv2.LINE_8, shift)
            render.fill_convex_poly(got, pts, col, shift)
        else:
            c, axes = _pts(rng, -20, 100), (int(rng.randint(0, 60)), int(rng.randint(0, 4)))
            angle, a0, a1 = (int(v) for v in rng.randint(-400, 400, 3))
            delta = int(rng.choice([1, 5, 30]))
            poly = render.ellipse2poly(c, axes, angle, a0, a1, delta)
            np.testing.assert_array_equal(
                poly, np.asarray(cv2.ellipse2Poly(c, axes, angle, a0, a1, delta)).reshape(-1, 2))
            full = render.ellipse2poly(c, axes, angle, 0, 360, 1)
            cv2.fillConvexPoly(want, cv2.ellipse2Poly(c, axes, angle, 0, 360, 1), col)
            render.fill_convex_poly(got, full, col)
        np.testing.assert_array_equal(got, want)


def test_sine_table_equals_cv2():
    """ellipse2Poly at radii up to 1e9 reads the float sine table out."""
    for r in (2 ** 20, 2 ** 24, 10 ** 9):
        np.testing.assert_array_equal(
            render.ellipse2poly((0, 0), (r, r), 0, 0, 360, 1),
            np.asarray(cv2.ellipse2Poly((0, 0), (r, r), 0, 0, 360, 1)).reshape(-1, 2))


def _people(rng, n, h, w):
    out = []
    for i in range(n):
        cx, cy = rng.uniform(-40, w + 40), rng.uniform(-40, h + 40)
        kp = np.zeros((17, 3))
        kp[:, 0] = cx + rng.normal(0, 25, 17)
        kp[:, 1] = cy + rng.normal(0, 30, 17)
        kp[:, 2] = rng.choice([0, 0.5, 1, 2], 17)
        if i % 7 == 0:
            kp[3, :2] = kp[0, :2]                    # zero-length limbs
        out.append({"keypoints": kp.reshape(-1).tolist(),
                    "bbox": [cx - 20, cy - 30, rng.uniform(0, 60), rng.uniform(0, 80)]})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_plot_results_equals_jax(seed):
    """120 people per seed, drawn 6 to a canvas: boxes, dots (int(v) != 0)
    and limbs (v != 0), overlapping, partly and wholly off the canvas."""
    rng = np.random.RandomState(seed)
    people = _people(rng, 120, 120, 160)
    img = rng.randint(0, 256, (120, 160, 3), np.uint8)
    for k in range(0, len(people), 6):
        want = jrender.plot_results(img.copy(), people[k:k + 6])
        got = render.plot_results(img.copy(), people[k:k + 6])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3])
def test_write_png_reads_back(channels, tmp_path):
    rng = np.random.RandomState(channels)
    shape = (37, 53, 3) if channels == 3 else (37, 53)
    img = rng.randint(0, 256, shape, np.uint8)
    for filters in ((1,), (0,), (4, 3, 2, 1, 0)):
        path = str(tmp_path / "x.png")
        image_io.write_png(path, img, filters)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(image_io.read_image(path, channels // 3), img)
    with pytest.raises(ValueError, match="uint8"):
        image_io.write_png(path, img.astype(np.float32))


def _demo_heads():
    """(heatmaps, cls, reg) of one 64 px image: two people's gaussian
    joints and a scoring anchor on each."""
    rng = np.random.RandomState(5)
    joints = np.zeros((2, 18, 3), np.float32)
    anchors = np.asarray(anchors_for_shape((SIZE, SIZE), jax_config(SIZE).anchors))
    cls = np.full((1, anchors.shape[0], 1), 0.02, np.float32)
    for p, (cx, cy) in enumerate(((18, 22), (44, 40))):
        joints[p, :, 0] = cx + rng.uniform(-8, 8, 18)
        joints[p, :, 1] = cy + rng.uniform(-10, 10, 18)
        target = np.array([cx - 10, cy - 12, cx + 10, cy + 12])
        cls[0, np.abs(anchors - target).sum(1).argmin(), 0] = 0.9 - 0.1 * p
    hm = make_heatmaps_np(joints, SIZE // 4, SIZE // 4, stride=4, sigma=3.0)
    reg = (rng.randn(1, anchors.shape[0], 4) * 0.1).astype(np.float32)
    return hm[None], cls, reg


def test_test_writes_the_images_of_jax(tmp_path):
    """``test()`` with write_image in both packages on two images of other
    sizes than the model's: per image ``<stem>_1heatmap.png`` (the joints'
    maximum, INTER_LINEAR to the image's size, times 256) and
    ``<stem>_2canvas.png``, equal to JAX's decoded files."""
    jm, v = perturbed_init("resnet50", SIZE, seed=3)
    heads = _demo_heads()
    jcfg, cfg = jax_config(SIZE), port_config(SIZE)
    jcfg = dataclasses.replace(jcfg, eval=dataclasses.replace(
        jcfg.eval, write_image=True))
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, write_image=True))
    jev = JEvaluator(jcfg, ForwardStub(jm),
                     {"v": v, "heads": tuple(jnp.asarray(h) for h in heads)})
    ev = Evaluator(cfg, model=port_model(v, cfg), device="cpu")
    ev.pipeline((SIZE, SIZE)).forward = lambda images: tuple(
        torch.from_numpy(h) for h in heads)

    data = tmp_path / "in"
    data.mkdir()
    rng = np.random.RandomState(8)
    for name, hw in (("a.png", (64, 48)), ("b.png", (90, 120))):
        cv2.imwrite(str(data / name), rng.randint(0, 256, hw + (3,), np.uint8))
    jrows = jev.test(str(data), str(tmp_path / "jax"))
    rows = ev.test(str(data), str(tmp_path / "port"))
    assert len(rows) == len(jrows) == 4
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "a_1heatmap.png", "a_2canvas.png", "b_1heatmap.png", "b_2canvas.png"]
    for name in os.listdir(tmp_path / "jax"):
        want = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
        got = image_io.read_image(str(tmp_path / "port" / name),
                                  0 if "heatmap" in name else 1)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if "heatmap" in name:
            assert want.max() > 50                    # the joints show


def test_new_modules_import_nothing_of_jax_or_cv2():
    """The renderer, the grouped eval, the host chain's helpers and the PNG
    writer import neither JAX, the JAX package nor cv2."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import sys
        import multiposenet_tpu_torch.eval.render
        import multiposenet_tpu_torch.engine.grouped_eval
        import multiposenet_tpu_torch.eval.multiscale
        import multiposenet_tpu_torch.eval.grouping
        import multiposenet_tpu_torch.data.image_io
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "multiposenet_tpu", "cv2"))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
