"""multiposenet_tpu_torch multi-scale eval pieces against the JAX package on
the CPU: the resize operators, the scale arithmetic, the COCO index and OKS
evaluator, the joint-list helpers, the device image pyramid and the fused
resize + sum + fold + peaks."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiposenet_tpu.config import Config as JConfig
from multiposenet_tpu.data.coco_json import COCOIndex as JCOCOIndex
from multiposenet_tpu.engine import evaluator as jeval
from multiposenet_tpu.eval import grouping as jgrouping
from multiposenet_tpu.eval import multiscale as jms
from multiposenet_tpu.eval.cocoeval import KeypointEval as JKeypointEval
from multiposenet_tpu.ops import resize as jresize

from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.data.coco_json import COCOIndex
from multiposenet_tpu_torch.engine import evaluator as teval
from multiposenet_tpu_torch.eval import grouping as tgrouping
from multiposenet_tpu_torch.eval import multiscale as tms
from multiposenet_tpu_torch.eval.cocoeval import KeypointEval
from multiposenet_tpu_torch.ops import resize as tresize
from multiposenet_tpu_torch.ops.pyramid import build_pyramid, pyramid_taps


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize("n_in,n_out", [(5, 20), (17, 68), (30, 13),
                                        (120, 160), (96, 427), (160, 159)])
def test_resize_operators_bit_equal_jax(n_in, n_out):
    np.testing.assert_array_equal(tresize.cubic_resize_matrix(n_in, n_out),
                                  jresize.cubic_resize_matrix(n_in, n_out))
    for got, want in zip(tresize.linear_resize_coeffs(n_in, n_out),
                         jresize.linear_resize_coeffs(n_in, n_out)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", [(8, 8, 30, 30, 60, 60, 64, 64),
                                 (16, 24, 60, 90, 160, 224, 192, 256),
                                 (40, 56, 150, 210, 237, 189, 256, 192),
                                 (24, 16, 96, 64, 480, 320, 0, 0)])
def test_heatmap_resize_mats_bit_equal_jax(key):
    for got, want in zip(tresize.heatmap_resize_mats(*key),
                         jresize.heatmap_resize_mats(*key)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_scale_arithmetic_equal_jax():
    rng = np.random.RandomState(5)
    assert tms.SWAP_HEAT_18 == jms.SWAP_HEAT_18
    for _ in range(60):
        h, w = rng.randint(40, 900), rng.randint(40, 900)
        inp = int(rng.choice([64, 128, 480]))
        mult = tms.get_multipliers(h, inp, (0.5, 1.0, 1.5, 2.0, 2.5))
        assert mult == jms.get_multipliers(h, inp, (0.5, 1.0, 1.5, 2.0, 2.5))
        bucket = int(rng.choice([0, 64, 128]))
        for m in mult:
            assert (tms.crop_shape_only((h, w), m * h, bucket=bucket)
                    == jms.crop_shape_only((h, w), m * h, bucket=bucket))


# ---------------------------------------------------------------- COCO

def _synthetic_gt_and_results(seed: int = 0):
    rng = np.random.RandomState(seed)
    images, anns, results = [], [], []
    aid = 1
    for img_id in range(1, 7):
        images.append({"id": img_id, "height": 300, "width": 400,
                       "file_name": f"{img_id}.jpg"})
        for _ in range(rng.randint(1, 4)):
            cx, cy = rng.uniform(60, 340), rng.uniform(60, 240)
            kps = np.zeros((17, 3))
            kps[:, 0] = cx + rng.uniform(-40, 40, 17)
            kps[:, 1] = cy + rng.uniform(-50, 50, 17)
            kps[:, 2] = np.where(rng.rand(17) < 0.8, 2, 0)
            vis = kps[kps[:, 2] > 0]
            x0, y0 = vis[:, :2].min(0) - 5
            x1, y1 = vis[:, :2].max(0) + 5
            bbox = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
            anns.append({"id": aid, "image_id": img_id, "category_id": 1,
                         "iscrowd": int(rng.rand() < 0.1),
                         "num_keypoints": int((kps[:, 2] > 0).sum()),
                         "area": bbox[2] * bbox[3], "bbox": bbox,
                         "keypoints": kps.reshape(-1).tolist()})
            aid += 1
            # a detection per person, perturbed, plus some false positives
            for noise in ((rng.uniform(1, 12),) + ((60.0,) if rng.rand() < 0.4
                                                   else ())):
                d = kps.copy()
                d[:, :2] += rng.randn(17, 2) * noise
                d[:, 2] = 1
                results.append({"image_id": img_id, "category_id": 1,
                                "bbox": bbox, "score": float(rng.rand()),
                                "keypoints": d.reshape(-1).tolist()})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": 1, "name": "person"}]}
    return gt, results


def test_coco_index_and_keypoint_eval_equal_jax():
    gt, results = _synthetic_gt_and_results()
    stats = []
    for index, keval in ((COCOIndex, KeypointEval), (JCOCOIndex, JKeypointEval)):
        g = index(dataset=gt)
        ids = g.get_img_ids(cat_ids=[1])
        ev = keval(g, g.load_res([dict(r) for r in results]), img_ids=ids)
        stats.append((ids, ev.evaluate(), ev.summarize()))
    (ids, got, text), (jids, want, jtext) = stats
    assert ids == jids and len(got) == 10
    assert got == want
    assert text == jtext
    assert 0.1 < got["AP"] < 0.99


def test_joint_list_helpers_equal_jax():
    rng = np.random.RandomState(2)
    for t in range(18):
        assert tgrouping.drop_neck_reindex(t) == jgrouping.drop_neck_reindex(t)
    kp = rng.rand(51).tolist()
    assert tgrouping.to_coco_order(kp) == jgrouping.to_coco_order(kp)
    assert tgrouping.COCO_ORDER == jgrouping.COCO_ORDER

    coords = rng.randint(0, 300, (18, 6, 2)).astype(np.int32)
    scores = rng.rand(18, 6).astype(np.float32)
    valid = rng.rand(18, 6) < 0.5
    valid[3] = True                     # a saturated joint
    for scale in (1.0, 2.5):
        got = teval.peak_arrays_to_joint_list(coords, scores, valid, scale)
        assert got == jeval.peak_arrays_to_joint_list(coords, scores, valid,
                                                      scale)
    jl = np.asarray(got)
    assert teval.drop_neck(jl) == jeval.drop_neck(jl)
    assert teval.drop_neck(np.asarray([])) == []
    joints = teval.drop_neck(jl)
    for cap in (2, 6):
        for a, b in zip(teval._joints_to_peak_arrays(joints, cap),
                        jeval._joints_to_peak_arrays(joints, cap)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- pyramid

def _lerp_np(src, rows, cols):
    """The pyramid's lerp in numpy, every product and sum rounded to
    float32 on its own."""
    f = src.astype(np.float32)
    i0, i1, w0 = (np.asarray(a) for a in rows)
    g = f[i0] * w0[:, None, None] + f[i1] * (np.float32(1) - w0)[:, None, None]
    i0, i1, w0 = (np.asarray(a) for a in cols)
    o = g[:, i0] * w0[None, :, None] + g[:, i1] * (np.float32(1) - w0)[None, :, None]
    return np.clip(np.floor(o + np.float32(0.5)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw", [(160, 224), (237, 189)])
def test_pyramid_equals_jax(hw):
    """The port's device pyramid against JAX ``Evaluator._pyramid_fn`` (the
    tests/test_eval.py set-up), flip rows included, 128 in the padding.

    The port rounds every product and sum of the lerp to float32 on its
    own, as a numpy evaluation does, and equals that exactly.  XLA's CPU
    backend contracts ``a * w0 + b * (1 - w0)`` into a fused multiply-add,
    so where the lerp lands within an ulp of x.5 the two round to
    neighbouring uint8 values: at most 1 step, on 1 pixel in 10^6 here."""
    h, w = hw
    jev = jeval.Evaluator(JConfig())
    img = np.random.RandomState(11).randint(0, 256, (h, w, 3), np.uint8)
    bucket = 64
    dests = [m * h for m in jms.get_multipliers(h, 128, (0.5, 1.0, 1.7))]
    ipack, wpack, dims, metas = jev._pyramid_host_args(h, w, dests, bucket,
                                                       True)
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    src = np.zeros((hp, wp, 3), np.uint8)
    src[:h, :w] = img[:, :, ::-1]
    want = jev._pyramid_fn(tuple(m[0] for m in metas), True)(
        jnp.asarray(src), ipack, wpack, dims)

    taps = pyramid_taps(h, w, dests, bucket, True, torch.device("cpu"))
    got = build_pyramid(torch.from_numpy(img[:, :, ::-1].copy()), taps)
    assert len(got) == len(want) == 3
    n_diff = n_px = 0
    for t, m, g, wnt in zip(taps, metas, got, want):
        assert (t.padded_hw, t.real_hw, t.im_scale) == m
        assert g.shape == (2, *t.padded_hw, 3) and g.dtype == torch.uint8
        g, wnt = g.numpy(), np.asarray(wnt)
        rh, rw = t.real_hw
        for row, cols in enumerate((t.cols, t.cols_flip)):
            np.testing.assert_array_equal(
                g[row, :rh, :rw], _lerp_np(img[:, :, ::-1], t.rows, cols))
        assert (g[:, rh:] == 128).all() and (g[:, :, rw:] == 128).all()
        d = np.abs(g.astype(int) - wnt.astype(int))
        assert d.max() <= 1
        n_diff += int((d > 0).sum())
        n_px += d.size
    assert n_diff <= n_px * 1e-5, (n_diff, n_px)


# ---------------------------------------------------------------- fold

def _bump_maps(rng, nb: int, sh: int, sw: int, people: int = 3):
    """(nb, sh, sw, 18) stride-4 maps of gaussian bumps (sigma 1.5, cut to
    exactly 0 past 3 sigma), one bump per joint per person, away from the
    top-left corner."""
    yy, xx = np.mgrid[0:sh, 0:sw].astype(np.float64)
    out = np.zeros((nb, sh, sw, 18), np.float64)
    for b in range(nb):
        for _ in range(people):
            cy, cx = rng.uniform(0.35, 0.85) * sh, rng.uniform(0.3, 0.85) * sw
            for j in range(18):
                y = cy + rng.uniform(-0.12, 0.12) * sh
                x = cx + rng.uniform(-0.12, 0.12) * sw
                d2 = (yy - y) ** 2 + (xx - x) ** 2
                g = rng.uniform(0.4, 1.0) * np.exp(-d2 / (2 * 1.5 ** 2))
                out[b, :, :, j] = np.maximum(out[b, :, :, j],
                                             np.where(d2 < 20.25, g, 0.0))
    return out.astype(np.float32)


def _fold_case(hw, scale_search, with_flip, dtype, seed):
    h, w = hw
    rng = np.random.RandomState(seed)
    bucket = 64
    hp, wp = -(-h // bucket) * bucket, -(-w // bucket) * bucket
    nb = 2 if with_flip else 1
    hms, mats = [], []
    for m in jms.get_multipliers(h, 96, scale_search):
        (dh, dw), _, (rh, rw) = jms.crop_shape_only((h, w), m * h,
                                                    bucket=bucket)
        hm = torch.from_numpy(_bump_maps(rng, nb, dh // 4, dw // 4)).to(dtype)
        hms.append(hm)
        mats.append(jresize.heatmap_resize_mats(dh // 4, dw // 4, rh, rw, h, w,
                                                hp, wp))
    return hms, mats, 1.0 / len(scale_search)


FOLD_CASES = [((150, 200), (0.5, 1.0), False, torch.float32),
              ((150, 200), (0.5, 1.0, 1.5), True, torch.float32),
              ((201, 130), (0.5, 1.0, 1.5), True, torch.bfloat16),
              ((201, 130), (1.0, 1.5), False, torch.bfloat16)]


@pytest.mark.parametrize("hw,scale_search,with_flip,dtype", FOLD_CASES)
def test_fold_peaks_equal_jax(hw, scale_search, with_flip, dtype):
    """The fused resize + sum + fold + peaks against JAX
    ``accum_fold_peaks_fn``; the folded map against JAX's device accumulate
    and fold (the same sum in the same order)."""
    h, w = hw
    hms, mats, inv_n = _fold_case(hw, scale_search, with_flip, dtype, seed=h)
    jcfg = JConfig()
    jcfg = dataclasses.replace(jcfg, peaks=dataclasses.replace(
        jcfg.peaks, max_peaks_per_joint=8))
    cfg = Config()
    cfg = dataclasses.replace(cfg, peaks=dataclasses.replace(
        cfg.peaks, max_peaks_per_joint=8))
    jev = jeval.Evaluator(jcfg)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jhms = tuple(jnp.asarray(hm.float().numpy()).astype(jdt) for hm in hms)
    jmats = tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in mats)
    want = jev.accum_fold_peaks_fn()(jhms, jmats, jnp.int32(h), jnp.int32(w),
                                     with_flip, jnp.float32(inv_n))

    tmats = [(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)))
             for a, b in mats]
    got = teval.fold_peaks(hms, tmats, h, w, with_flip, inv_n, cfg.peaks)
    valid = got.valid.numpy()
    assert valid.any(axis=1).all() and not valid.all()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)

    nb = 2 if with_flip else 1
    avg = jnp.zeros((nb, mats[0][0].shape[0], mats[0][1].shape[1], 18),
                    jnp.float32)
    for hm, (rh, rwt) in zip(jhms, jmats):
        avg = jev.accum_fn()(avg, hm, rh, rwt)
    jheat = np.asarray(jev.fold_fn()(avg, jnp.int32(h), jnp.int32(w),
                                     with_flip, jnp.float32(inv_n)))
    heat = teval.fold_heat(hms, tmats, h, w, with_flip, inv_n).numpy()
    assert heat.shape == jheat.shape
    np.testing.assert_allclose(heat[:h, :w], jheat[:h, :w], rtol=0, atol=1e-6)
    assert not heat[h:].any() and not heat[:, w:].any()


@pytest.mark.parametrize("max_peaks", [8, 64])
def test_full_resolution_peaks_tie_order_equals_jax(max_peaks):
    """The peak finder at upsample factor 1 on one image (the fold's call)
    against JAX ``find_peaks_refined``, whose two-phase top-k reproduces
    ``lax.top_k``: integer heat full of equal peaks and plateaus, so the
    tie order and the -1 fill slots decide the output."""
    from multiposenet_tpu.ops.peaks import find_peaks_refined
    from multiposenet_tpu_torch.ops.peaks import find_peaks_refined_batched

    heat = np.random.RandomState(max_peaks).randint(0, 4, (60, 80, 18)).astype(
        np.float32)
    heat[:, :, 3] = 0.0                      # a joint without peaks
    want = find_peaks_refined(jnp.asarray(heat), 0.5, max_peaks,
                              upsamp_factor=1)
    got = find_peaks_refined_batched(torch.from_numpy(heat)[None], 0.5,
                                     max_peaks, upsamp_factor=1)
    for name in ("coords", "scores", "valid"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)), name)
    valid = got.valid[0].numpy()
    assert not valid[3].any() and valid[0].all()
