"""multiposenet_tpu_torch's evaluator host chains and variant paths against
the JAX package on the CPU:

(a) the host helpers of eval/multiscale.py against JAX's, and the cv2-free
    resizes against cv2 itself: uint8 outputs exact; the heatmaps, which
    cv2 resizes on its own (non-IPP) float path, exact too, held within
    1e-6; joint lists with equal ids and coordinates, scores within 1e-6;
(b) eval/grouping.group_peaks against JAX's on the same PRN outputs;
(c) ``coco_eval`` of both packages under each switch (host-resize,
    host-peaks, host-image-resize, detect-all-scales, host-grouping,
    grouped dispatch with a partial group and an escalated image), the
    forward stubbed by ``GTForward``: equal OKS stats, equal person rows
    (boxes within 1e-5), grouped rows equal to the port's ungrouped rows;
    the grouped pyramid and fold + peaks equal the per-image ones.
"""

import dataclasses
import json
import logging

import cv2
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import Config as JConfig
from multiposenet_tpu.config import DataConfig as JDataConfig
from multiposenet_tpu.config import ModelConfig as JModelConfig
from multiposenet_tpu.engine.evaluator import Evaluator as JEvaluator
from multiposenet_tpu.eval import grouping as jgrouping
from multiposenet_tpu.eval import multiscale as jms

from multiposenet_tpu_torch.config import Config, ModelConfig
from multiposenet_tpu_torch.data import imgproc
from multiposenet_tpu_torch.engine import grouped_eval
from multiposenet_tpu_torch.engine.evaluator import Evaluator, fold_heat
from multiposenet_tpu_torch.eval import grouping, multiscale as ms
from multiposenet_tpu_torch.ops.peaks import find_peaks_refined_batched
from multiposenet_tpu_torch.ops.pyramid import (
    build_pyramid,
    build_pyramid_group,
    group_pyramid_taps,
    pyramid_taps,
)
from multiposenet_tpu_torch.ops.resize import heatmap_resize_mats
from torch_port_helpers import (
    GTForward,
    perturbed_init,
    port_config,
    port_model,
    synthetic_coco,
)

SIZE = 64
FLOAT_TOL = 1e-6


def _bumps(rng, h, w, c, n=6):
    """(h, w, c) float32 sums of gaussian bumps: peaks, plateaus and
    near-ties for the peak finder."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((h, w, c), np.float32)
    for ch in range(c):
        for _ in range(n):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            s = rng.uniform(1.5, 6)
            out[:, :, ch] += (rng.uniform(0.2, 1)
                              * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
    return out.astype(np.float32)


# ------------------------------------------------------------------ (a) resizes

@pytest.mark.parametrize("hw,dsize", [((160, 224), (337, 241)), ((237, 189), (102, 128)),
                                      ((480, 640), (480, 360)), ((480, 640), (320, 240)),
                                      ((37, 53), (7, 11))])
def test_resize_linear_equals_cv2(hw, dsize):
    """uint8 gray and BGR through OpenCV's fixed-point path, and one-channel
    float32 through IPP's, bit for bit; at an exact halving cv2 turns the
    resize into INTER_AREA, which the same arithmetic gives."""
    rng = np.random.RandomState(hw[0] + dsize[0])
    for img in (rng.randint(0, 256, hw + (3,), np.uint8),
                rng.randint(0, 256, hw, np.uint8)):
        np.testing.assert_array_equal(imgproc.resize_linear(img, dsize),
                                      cv2.resize(img, dsize))
    f = rng.rand(*hw).astype(np.float32)
    np.testing.assert_array_equal(imgproc.resize_linear(f, dsize), cv2.resize(f, dsize))


@pytest.mark.parametrize("channels", [18, 7, 1, 3])
def test_resize_cubic_dsize_equals_cv2(channels):
    """The dsize form (factors dsize / size) and x4 of float32 maps: cv2's
    own float path (18 and 7 channels) exact; the IPP path (1 and 3
    channels) within 1e-6 of values in [0, 1]."""
    rng = np.random.RandomState(channels)
    src = rng.rand(30, 40, channels).astype(np.float32)
    if channels == 1:
        src = src[:, :, 0]
    for kw, want in (({"dsize": (157, 117)}, cv2.resize(src, (157, 117), interpolation=cv2.INTER_CUBIC)),
                     ({"dsize": (29, 33)}, cv2.resize(src, (29, 33), interpolation=cv2.INTER_CUBIC)),
                     ({"fx": 4.0}, cv2.resize(src, None, fx=4, fy=4, interpolation=cv2.INTER_CUBIC))):
        got = imgproc.resize_cubic(src, **kw)
        assert got.shape == want.shape
        if channels in (1, 3):
            np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ (a) helpers

@pytest.mark.parametrize("hw,dest,pad_val,bucket", [((160, 224), 64.0, 128, 64),
                                                    ((237, 189), 191.5, 128, 64),
                                                    ((100, 80), 40.0, 0, 0)])
def test_crop_with_factor_equals_jax(hw, dest, pad_val, bucket):
    rng = np.random.RandomState(hw[1])
    img = rng.randint(0, 256, hw + (3,), np.uint8)
    for src in (img, img[:, ::-1]):
        got = ms.crop_with_factor(src, dest, factor=32, pad_val=pad_val, bucket=bucket)
        want = jms.crop_with_factor(src, dest, factor=32, pad_val=pad_val, bucket=bucket)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_host_heatmap_chain_equals_jax():
    """resize_heatmap_to_original (x4 cubic, unpad, cubic to the original)
    and average_flip_heat on 18-joint maps."""
    rng = np.random.RandomState(3)
    for cropped, real, orig in (((128, 192), (114, 160), (160, 224, 3)),
                                ((64, 96), (57, 80), (237, 333, 3))):
        hms = [rng.rand(cropped[0] // 4, cropped[1] // 4, 18).astype(np.float32)
               for _ in range(2)]
        got = [ms.resize_heatmap_to_original(h, cropped, real, orig) for h in hms]
        want = [jms.resize_heatmap_to_original(h, cropped, real, orig) for h in hms]
        for g, w in zip(got, want):
            assert g.shape == w.shape == orig[:2] + (18,) and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_TOL)
        np.testing.assert_allclose(ms.average_flip_heat(*got),
                                   jms.average_flip_heat(*want), rtol=0, atol=FLOAT_TOL)


@pytest.mark.parametrize("factor", [1.0, 4.0])
def test_peak_finder_helpers_equal_jax(factor):
    """local_max_cross, _peak_sites, _refine_peak_batch, find_peaks_np and
    joint_list_from_heatmaps on bump maps with plateaus; at x4 the windows
    of one size ride one cubic resize as channels."""
    rng = np.random.RandomState(int(factor))
    heat = _bumps(rng, 45, 60, 18)
    heat[10:13, 20:23, 4] = heat[10:13, 20:23, 4].max()       # a plateau
    np.testing.assert_array_equal(ms.local_max_cross(heat), jms.local_max_cross(heat))
    for a, b in zip(ms._peak_sites(heat, 0.05), jms._peak_sites(heat, 0.05)):
        np.testing.assert_array_equal(a, b)
    patches = heat[None, 5:10, 5:10, :].transpose(3, 1, 2, 0)[:, :, :, 0]
    for a, b in zip(ms._refine_peak_batch(patches, factor),
                    jms._refine_peak_batch(patches, factor)):
        np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_TOL)
    got = ms.find_peaks_np(heat, 0.05, factor)
    want = jms.find_peaks_np(heat, 0.05, factor)
    assert sum(len(p) for p in want) > 50
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:, [0, 1, 3]], w[:, [0, 1, 3]])
        np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=0, atol=FLOAT_TOL)
    got = ms.joint_list_from_heatmaps(heat, int(45 * factor), 1.5, 0.05)
    want = jms.joint_list_from_heatmaps(heat, int(45 * factor), 1.5, 0.05)
    np.testing.assert_array_equal(got[:, [0, 1, 3, 4]], want[:, [0, 1, 3, 4]])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=FLOAT_TOL)


# ------------------------------------------------------------------ (b) grouping

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_peaks_equals_jax(seed):
    """The host assignment on the same PRN outputs: colliding cells (the
    last peak wins), competing people, and a joint type with no peak in any
    box (the v=0 fallback from the PRN argmax)."""
    rng = np.random.RandomState(seed)
    nb, p, gh, gw = 5, 6, 56, 36
    table = rng.rand(nb, 17, p).astype(np.float32)
    inside = rng.rand(nb, 17, p) < 0.6
    inside[:, 3] = False                                  # the fallback
    cx = rng.randint(0, 4, (nb, 17, p)).astype(np.int32)  # collisions
    cy = rng.randint(0, 4, (nb, 17, p)).astype(np.int32)
    prn_out = rng.rand(nb, gh, gw, 17).astype(np.float32)
    peak_xy = rng.uniform(0, 200, (17, p, 2)).astype(np.float32)
    peak_valid = rng.rand(17, p) < 0.8
    boxes = np.concatenate([rng.uniform(0, 100, (nb, 2)),
                            rng.uniform(10, 80, (nb, 2))], 1).astype(np.float32)
    args = (table, inside, cx, cy, prn_out, peak_xy, peak_valid, boxes)
    got = grouping.group_peaks(*args, file_name="a.png", image_id=seed)
    want = jgrouping.group_peaks(*args, file_name="a.png", image_id=seed)
    assert len(got) == len(want) == nb
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert (g["image_id"], g["file_name"], g["score"]) == (
            w["image_id"], w["file_name"], w["score"])
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], rtol=0, atol=FLOAT_TOL)
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=FLOAT_TOL)
    assert any(k[2::3].count(0) for k in (r["keypoints"] for r in got))
    assert grouping.group_peaks(table[:0], inside[:0], cx[:0], cy[:0], prn_out[:0],
                                peak_xy, peak_valid, boxes[:0]) == []


# ------------------------------------------------------------------ (c) the grouped pieces

def test_group_pyramid_and_fold_equal_per_image():
    """Three images of one signature and different sizes: the grouped
    pyramid rows and the grouped fold + peaks equal the per-image ones bit
    for bit, with the flip and without."""
    rng = np.random.RandomState(5)
    sizes, bucket, scales = [(150, 200), (147, 196), (160, 190)], 64, (0.5, 1.0, 1.5)
    dests = [[m * h for m in ms.get_multipliers(h, 128, scales)] for h, _ in sizes]
    imgs = [rng.randint(0, 256, hw + (3,), np.uint8) for hw in sizes]
    hp, wp = 192, 256
    for flip in (True, False):
        nb = 2 if flip else 1
        taps = group_pyramid_taps(sizes, dests, bucket, flip, "cpu")
        srcs = np.zeros((3, hp, wp, 3), np.uint8)
        for g, im in enumerate(imgs):
            srcs[g, :im.shape[0], :im.shape[1]] = im[:, :, ::-1]
        batches = build_pyramid_group(torch.from_numpy(srcs), taps)
        hms, mats, singles = [], [], [[] for _ in sizes]
        for s, t in enumerate(taps):
            dh, dw = t.padded_hw
            hms.append(torch.from_numpy(_bumps(rng, dh // 4, 3 * nb * dw // 4, 18, 3)
                                        .reshape(dh // 4, 3 * nb, dw // 4, 18)
                                        .transpose(1, 0, 2, 3).copy()))
            per = [heatmap_resize_mats(dh // 4, dw // 4, *ms.crop_shape_only(
                hw, dests[g][s], factor=32, bucket=bucket)[2], *hw, hp, wp)
                for g, hw in enumerate(sizes)]
            mats.append(tuple(torch.from_numpy(np.stack([m[i] for m in per]))
                              for i in (0, 1)))
            for g in range(3):
                singles[g].append(tuple(torch.from_numpy(np.array(m)) for m in per[g]))
        got = grouped_eval.fold_peaks_group(hms, mats, torch.tensor(sizes), flip,
                                            1 / 3, port_config(SIZE).peaks)
        for g, im in enumerate(imgs):
            want_b = build_pyramid(torch.from_numpy(im[:, :, ::-1].copy()),
                                   pyramid_taps(*sizes[g], dests[g], bucket, flip, "cpu"))
            for b, wb in zip(batches, want_b):
                assert torch.equal(b[g * nb:(g + 1) * nb], wb)
            heat = fold_heat([hm[g * nb:(g + 1) * nb] for hm in hms], singles[g],
                             *sizes[g], flip, 1 / 3)
            want = find_peaks_refined_batched(heat[None], thre1=1e-6, max_peaks=8,
                                              upsamp_factor=1)
            for a, b in zip(got, want):
                assert torch.equal(a[g], b[0])
            assert want.valid.any()


# ------------------------------------------------------------------ (c) coco_eval

@pytest.fixture(scope="module")
def weights():
    jm, v = perturbed_init("resnet50", SIZE, seed=3)
    return jm, v, port_model(v, port_config(SIZE))


def _configs(scale_search, flip=True, **over):
    """JAX and port multi-scale eval configurations, with the fields of the
    sections in ``over`` replaced in both."""
    jcfg = JConfig(model=JModelConfig(backbone="resnet50"),
                   data=JDataConfig(inp_size=128))
    out = []
    for c in (jcfg, Config(model=ModelConfig(backbone="resnet50"))):
        c = dataclasses.replace(c, eval=dataclasses.replace(
            c.eval, inp_size=128, scale_search=scale_search, flip=flip))
        for section, fields in over.items():
            c = dataclasses.replace(c, **{section: dataclasses.replace(
                getattr(c, section), **fields)})
        out.append(c)
    return out


def _run(ev, gt, root, scale_search, flip, port, tag):
    stub = GTForward(gt, 128, scale_search, flip=flip)
    ev.pipeline = stub.port_pipeline if port else stub.jax_pipeline
    path = str(root / f"{tag}.json")
    metrics = ev.coco_eval(ann_file=str(root / "gt.json"), img_dir=str(root),
                           result_file=path)
    with open(path) as f:
        return metrics, json.load(f), stub


def _by_image(rows):
    """Rows grouped by image in image order, each image's rows in order."""
    return sorted(rows, key=lambda r: r["image_id"])


def _assert_rows_equal(got, want, box_tol=1e-5):
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["keypoints"] == w["keypoints"]
        assert g["score"] == w["score"]
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=box_tol)


def _assert_metrics_equal(got, want):
    assert got.keys() == want.keys() and len(got) == 10
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


PEOPLE = [[(45, 60), (150, 70)], [(60, 100)], [(170, 110)]]

# switch -> (eval / prn fields, forwards per image per package)
SWITCHES = {
    "host_resize": (dict(eval=dict(device_resize=False)), 2),
    "host_peaks": (dict(eval=dict(device_peaks=False)), 2),
    "host_image_resize": (dict(eval=dict(device_image_resize=False)), 2),
    "detect_all_scales": (dict(eval=dict(detect_scale1_only=False)), 2),
    "host_grouping": (dict(prn=dict(device_grouping=False)), 2),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_coco_eval_switch_equals_jax(switch, tmp_path, weights):
    """Each switch in both packages on the same stubbed forward: the
    pyramid or host crops, the fold or host chain, device or host peaks,
    scale-1.0 boxes, PRN and device or host grouping, OKS evaluation."""
    jm, v, tm = weights
    synthetic_coco(str(tmp_path), PEOPLE)
    gt = json.loads((tmp_path / "gt.json").read_text())
    over, forwards = SWITCHES[switch]
    eval_over = over.get("eval", {})
    jcfg, cfg = _configs((0.5, 1.0), **{k: v_ for k, v_ in over.items()})
    jmetrics, jrows, jstub = _run(JEvaluator(jcfg, jm, v), gt, tmp_path, (0.5, 1.0),
                                  True, False, "jax")
    ev = Evaluator(cfg, model=tm, device="cpu")
    metrics, rows, stub = _run(ev, gt, tmp_path, (0.5, 1.0), True, True, "port")
    _assert_rows_equal(rows, jrows)
    _assert_metrics_equal(metrics, jmetrics)
    assert metrics["AP"] > 0.8, metrics
    assert len(rows) == 4 and ev.escalated == []
    assert stub.calls == jstub.calls == {i: forwards for i in (1, 2, 3)}
    # the default path's rows: every switch gives the same people here
    if eval_over or switch == "host_grouping":
        dcfg = _configs((0.5, 1.0))[1]
        _, drows, _ = _run(Evaluator(dcfg, model=tm, device="cpu"), gt, tmp_path,
                           (0.5, 1.0), True, True, "default")
        _assert_rows_equal(rows, drows)


def test_grouped_coco_eval_equals_jax_and_ungrouped(tmp_path, weights):
    """group_size 3 over 4 images of one size: a full group, then a partial
    group of one filled with replicas; image 2 is a crowd of three whose
    joints fill both peak slots, so it is dispatched again alone at 8 peaks.
    The rows equal JAX's grouped rows and the port's own ungrouped rows."""
    jm, v, tm = weights
    people = [[(45, 60)], [(45, 60), (150, 70), (100, 125)], [(60, 100)], [(170, 110)]]
    synthetic_coco(str(tmp_path), people)
    gt = json.loads((tmp_path / "gt.json").read_text())
    over = dict(peaks=dict(max_peaks_per_joint=2, escalate_max_peaks=8),
                prn=dict(max_people=1, escalate_max_people=4))
    jcfg, cfg = _configs((0.5, 1.0), eval=dict(group_size=3), **over)
    jmetrics, jrows, jstub = _run(JEvaluator(jcfg, jm, v), gt, tmp_path, (0.5, 1.0),
                                  True, False, "jax")
    ev = Evaluator(cfg, model=tm, device="cpu")
    metrics, rows, stub = _run(ev, gt, tmp_path, (0.5, 1.0), True, True, "port")
    _assert_rows_equal(rows, jrows)
    _assert_metrics_equal(metrics, jmetrics)
    assert ev.escalated == [2]
    # 2 scales per group forward, images 1-3 ride group 1, image 4 group 2;
    # image 2 again alone
    assert stub.calls == jstub.calls == {1: 2, 2: 4, 3: 2, 4: 2}

    ucfg = _configs((0.5, 1.0), **over)[1]
    uev = Evaluator(ucfg, model=tm, device="cpu")
    umetrics, urows, _ = _run(uev, gt, tmp_path, (0.5, 1.0), True, True, "ungrouped")
    assert uev.escalated == [2]
    assert rows == _by_image(urows)
    assert metrics == umetrics
    assert metrics["AP"] > 0.8, metrics


def test_group_size_needs_the_device_path(weights):
    """With a host switch on, group_size is ignored with a warning."""
    tm = weights[2]
    cfg = _configs((0.5, 1.0), eval=dict(group_size=4, device_peaks=False))[1]
    # a handler of its own: another test may have stopped this logger's
    # records from reaching the root
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    grouped_eval.logger.addHandler(handler)
    try:
        assert not grouped_eval.use_groups(Evaluator(cfg, model=tm, device="cpu"))
    finally:
        grouped_eval.logger.removeHandler(handler)
    assert any("group_size=4 ignored" in r.getMessage() for r in records)
    cfg = _configs((0.5, 1.0), eval=dict(group_size=4))[1]
    ev = Evaluator(cfg, model=tm, device="cpu")
    assert grouped_eval.use_groups(ev)
    sig = grouped_eval.group_signature(ev, 150, 200, 64)
    assert sig == grouped_eval.group_signature(ev, 147, 196, 64) != \
        grouped_eval.group_signature(ev, 150, 260, 64)
