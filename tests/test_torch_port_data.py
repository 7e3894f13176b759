"""multiposenet_tpu_torch's COCO data path against the JAX package's on the
CPU: RLE and polygon masks (data/rle.py), each augmentation step under the
same generator seed (data/augment.py), and ``KeypointDataset`` /
``DetectionDataset`` items (data/datasets.py) from the same trees.

Limits: geometry (sizes, joints, centres, crop offsets), RLE, polygon
masks, records and boxes exact, with boxes allowed 1 px; uint8 images and
masks within 1 level on at most 1% of the pixels; the stride-4 float mask
within 1/255."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

from multiposenet_tpu.config import DataConfig as JDataConfig
from multiposenet_tpu.data import augment as jaug
from multiposenet_tpu.data import datasets as jds
from multiposenet_tpu.data import rle as jrle
from multiposenet_tpu.data.coco_json import COCOIndex as JCOCOIndex

import chip_smoke
from multiposenet_tpu_torch.config import DataConfig
from multiposenet_tpu_torch.data import augment, datasets, imgproc, rle
from multiposenet_tpu_torch.data.coco_json import COCOIndex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _within_one_level(got, want, what, limit=1):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= limit, (what, float(diff.max()))
    assert float((diff > 0).mean()) <= 0.01, (what, float((diff > 0).mean()))


# ---------------------------------------------------------------- RLE

@pytest.mark.parametrize("kind", ["compressed", "counts_list", "polygons", "anns"])
def test_rle_and_polygons_match_jax(kind):
    rng = np.random.RandomState(len(kind))
    for trial in range(10):
        h, w = rng.randint(5, 70, 2)
        mask = (rng.rand(h, w) < rng.uniform(0.05, 0.9)).astype(np.uint8)
        if kind == "compressed":
            enc = rle.encode_rle(mask)
            assert enc == jrle.encode_rle(mask)
            np.testing.assert_array_equal(rle.decode_rle(enc), mask)
            np.testing.assert_array_equal(rle.decode_rle(enc), jrle.decode_rle(enc))
            assert rle.mask_area(enc) == jrle.mask_area(enc) == int(mask.sum())
        elif kind == "counts_list":
            counts = rle._decode_counts(jrle.encode_rle(mask)["counts"])
            seg = {"size": [int(h), int(w)], "counts": counts}
            np.testing.assert_array_equal(rle.decode_rle(seg), jrle.decode_rle(seg))
        elif kind == "polygons":
            polys = [rng.uniform(-3, [w + 3, h + 3], (rng.randint(3, 9), 2)).ravel().tolist()
                     for _ in range(rng.randint(1, 4))] + [[1.0, 2.0, 3.0, 4.0]]
            np.testing.assert_array_equal(rle.polys_to_mask(polys, h, w),
                                          jrle.polys_to_mask(polys, h, w))
        else:
            for segm in ([rng.uniform(0, [w, h], (6, 2)).ravel().tolist()],
                         jrle.encode_rle(mask),
                         {"size": [int(h), int(w)],
                          "counts": rle._decode_counts(jrle.encode_rle(mask)["counts"])}):
                ann = {"segmentation": segm}
                np.testing.assert_array_equal(rle.ann_to_mask(ann, h, w),
                                              jrle.ann_to_mask(ann, h, w))


# ---------------------------------------------------------------- augmentation

def _sample(seed, h=97, w=131):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img[h // 4: h // 2] = 90
    mask = np.full((h, w), 255, np.uint8)
    mask[h // 3: h // 2, w // 5: w // 2] = 0
    joints = np.concatenate([rng.uniform(0, [w, h], (3, 18, 2)),
                             rng.randint(0, 3, (3, 18, 1))], axis=2).astype(np.float32)
    objpos = np.array([w * 0.45, h * 0.55])
    return dict(img=img, mask_miss=mask, joints=joints, objpos=objpos,
                scale_provided=float(rng.uniform(0.5, 1.6)))


def _cfgs(**kw):
    return JDataConfig(inp_size=64, **kw), DataConfig(inp_size=64, **kw)


STEPS = ("aug_scale", "aug_rotate", "aug_croppad", "aug_flip")


@pytest.mark.parametrize("seed", range(4))
def test_keypoint_augmentation_steps_match_jax(seed):
    """Each step from the same input and the same generator state: joints,
    centre and sizes exact, pixels within a level; then the port's one-pass
    ``augment_keypoint_sample`` equals its own step chain exactly."""
    jcfg, cfg = _cfgs(flip_prob=0.5)
    state = _sample(seed)
    gen = np.random.default_rng(seed)
    for name in STEPS:
        js = jaug.KeypointSample(**copy.deepcopy(state))
        ts = augment.KeypointSample(**copy.deepcopy(state))
        g_j, g_t = copy.deepcopy(gen), copy.deepcopy(gen)
        js = getattr(jaug, name)(js, jcfg, g_j)
        ts = getattr(augment, name)(ts, cfg, g_t)
        assert g_j.random() == g_t.random(), name        # same draws
        np.testing.assert_array_equal(ts.objpos, js.objpos)
        np.testing.assert_array_equal(ts.joints, js.joints)
        _within_one_level(ts.img, js.img, name)
        _within_one_level(ts.mask_miss, js.mask_miss, name)
        gen = g_j
        state = dict(img=js.img, mask_miss=js.mask_miss, joints=js.joints,
                     objpos=js.objpos, scale_provided=js.scale_provided)

    chain = augment.KeypointSample(**_sample(seed))
    g = np.random.default_rng(seed)
    for name in STEPS:
        chain = getattr(augment, name)(chain, cfg, g)
    fused = augment.augment_keypoint_sample(
        augment.KeypointSample(**_sample(seed)), cfg, np.random.default_rng(seed))
    for k in ("img", "mask_miss", "joints", "objpos"):
        np.testing.assert_array_equal(getattr(fused, k), getattr(chain, k), err_msg=k)


def _bbox_sample(seed, mod):
    base = _sample(seed)
    h, w = base["img"].shape[:2]
    rng = np.random.RandomState(seed + 100)
    masks = []
    for _ in range(3):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = rng.randint(0, h - 10), rng.randint(0, w - 10)
        m[y0: y0 + rng.randint(3, 30), x0: x0 + rng.randint(3, 40)] = 1
        masks.append(m)
    return mod.BBoxSample(img=base["img"], masks=masks, classes=[0, -1, 0],
                          objpos=base["objpos"], scale_provided=base["scale_provided"])


def _bbox_full_steps(s, cfg, rng):
    """The JAX package's augment_bbox_sample with the port's operators on
    whole images: what the one-pass windowed path must equal exactly."""
    scale = augment._scale_factor(s, cfg, rng)
    s.img = imgproc.resize_cubic(s.img, scale)
    s.masks = [imgproc.resize_area_u8(m, scale) for m in s.masks]
    s.objpos = s.objpos * scale
    degree = augment._rotation_degree(cfg, rng)
    s.img, _ = augment._rotate_bound(s.img, degree, (128, 128, 128))
    s.masks = [augment._rotate_bound(m, degree, 0)[0] for m in s.masks]
    crop = cfg.inp_size
    _, y0, x0 = augment._crop_origin(s.objpos, cfg, rng)
    s.img = augment._crop_array(s.img, 128, y0, x0, crop, crop)
    s.masks = [augment._window(lambda r0, r1, c0, c1, m=m: m[r0:r1, c0:c1],
                               m.shape, m.dtype, 0, y0, x0, crop + 1, crop + 1, crop)
               for m in s.masks]
    if rng.random() <= cfg.flip_prob:
        s.img = s.img[:, ::-1].copy()
        s.masks = [m[:, ::-1].copy() for m in s.masks]
    return s


@pytest.mark.parametrize("seed", range(4))
def test_bbox_augmentation_matches_jax(seed):
    jcfg, cfg = _cfgs(flip_prob=0.5)
    js = jaug.augment_bbox_sample(_bbox_sample(seed, jaug), jcfg,
                                  np.random.default_rng(seed))
    ts = augment.augment_bbox_sample(_bbox_sample(seed, augment), cfg,
                                     np.random.default_rng(seed))
    _within_one_level(ts.img, js.img, "bbox image")
    assert len(ts.masks) == len(js.masks)
    for tm, jm in zip(ts.masks, js.masks):
        assert tm.shape == jm.shape
    jb = jaug.boxes_from_masks(js.masks, js.classes)
    tb = augment.boxes_from_masks(ts.masks, ts.classes)
    assert np.abs(tb - jb).max() <= 1, (tb, jb)
    full = _bbox_full_steps(_bbox_sample(seed, augment), cfg, np.random.default_rng(seed))
    np.testing.assert_array_equal(ts.img, full.img)
    for tm, fm in zip(ts.masks, full.masks):
        np.testing.assert_array_equal(tm, fm)


def test_records_neck_boxes_match_jax():
    rng = np.random.RandomState(0)
    j17 = np.concatenate([rng.uniform(0, 100, (4, 17, 2)),
                          rng.randint(0, 3, (4, 17, 1))], axis=2)
    np.testing.assert_array_equal(datasets.add_neck(j17), jds.add_neck(j17))
    assert datasets.OUR_ORDER_18 == jds.OUR_ORDER_18
    assert augment.FLIP_ORDER_18 == jaug.FLIP_ORDER_18
    records = [{"isValidation": float(v)} for v in rng.randint(0, 2, 20)]
    for training in (True, False):
        assert (datasets.split_keypoint_records(records, training)
                == jds.split_keypoint_records(records, training))
    masks = [(rng.rand(20, 30) < p).astype(np.uint8) for p in (0.0, 0.05, 0.5)]
    classes = [0, 0, -1]
    boxes = augment.boxes_from_masks(masks, classes)
    np.testing.assert_array_equal(boxes, jaug.boxes_from_masks(masks, classes))
    for n in (0, 1, 5):
        np.testing.assert_array_equal(augment.pad_boxes(boxes, n),
                                      jaug.pad_boxes(boxes, n))


# ---------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A JPEG tree from tools/make_synth_pose_dataset.py, and a PNG tree with
    RLE, polygon and crowd segmentations from chip_smoke's writer."""
    jpeg = str(tmp_path_factory.mktemp("jpeg"))
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_pose_dataset.py"),
                    "--root", jpeg, "--n-train", "4", "--n-val", "2",
                    "--width", "160", "--height", "120"],
                   check=True, capture_output=True)
    png = str(tmp_path_factory.mktemp("png"))
    chip_smoke.write_synthetic_coco(png, 4, 2, sizes=((96, 128), (128, 96)),
                                    tall=(40.0, 80.0))
    return {"jpeg": jpeg, "png": png}


def _compare_items(j, t, what):
    assert sorted(j) == sorted(t), what
    for k in j:
        assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, (what, k)
    if "joints" in j:
        np.testing.assert_array_equal(t["joints"], j["joints"], err_msg=what)
        _within_one_level(t["mask"], j["mask"], what, limit=1 / 255 + 1e-7)
    if "boxes" in j:
        assert np.abs(t["boxes"] - j["boxes"]).max() <= 1, what
    _within_one_level(t["image"], j["image"], what)


@pytest.mark.parametrize("tree", ["jpeg", "png"])
@pytest.mark.parametrize("augment_on", [True, False])
def test_datasets_match_jax(trees, tree, augment_on):
    root = trees[tree]
    records = datasets.load_coco_json_index(os.path.join(root, "COCO.json"))
    assert records == jds.load_coco_json_index(os.path.join(root, "COCO.json"))
    idx = datasets.split_keypoint_records(records, True)
    jcfg, cfg = _cfgs()
    kp = [m.KeypointDataset(records, idx, os.path.join(root, "images"), root, c,
                            augment=augment_on)
          for m, c in ((jds, jcfg), (datasets, cfg))]
    ann = os.path.join(root, "annotations", "person_keypoints_train2017.json")
    jcoco, coco = JCOCOIndex(ann), COCOIndex(ann)
    ids = set(coco.get_img_ids())
    didx = [i for i, r in enumerate(records) if int(r["image_id"]) in ids]
    det = [jds.DetectionDataset(records, didx, jcoco, os.path.join(root, "train2017"),
                                jcfg, augment=augment_on),
           datasets.DetectionDataset(records, didx, coco,
                                     os.path.join(root, "train2017"), cfg,
                                     augment=augment_on)]
    equal_boxes = 0
    for pair, name in ((kp, "keypoint"), (det, "detection")):
        assert len(pair[0]) == len(pair[1]) > 0
        for i in range(min(len(pair[0]), 6)):
            j = pair[0].__getitem__(i, np.random.default_rng(i))
            t = pair[1].__getitem__(i, np.random.default_rng(i))
            _compare_items(j, t, f"{tree} {name} {i}")
            if name == "detection":
                equal_boxes += np.array_equal(j["boxes"], t["boxes"])
    assert equal_boxes >= min(len(det[0]), 6) - 1
