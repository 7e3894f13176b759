"""multiposenet_tpu_torch/tools/ against the JAX package's tools/ on the CPU:

(a) eval/render.py's anti-aliased primitives (``line_aa``, ``thick_line_aa``,
    ``circle_aa``, ``fill_convex_poly(aa=True)``) against cv2's LINE_AA,
    fuzzed with endpoints, radii, widths and colours, off the canvas too:
    equal pixel for pixel;
(b) the synthetic tree (make_synth_pose_dataset) against the JAX tool's at
    the JAX tests' sizes and at a crowd seed: COCO.json and the COCO jsons
    equal but for the file extension; the PNG canvases against the JAX
    tool's ``background`` + ``draw_person`` on the same draws, within the
    pinned bound of the background's float32 cubic upscale; the tree read
    by the port's keypoint, detection and PRN datasets and the eval layout;
(c) make_coco_json against JAX ``process_split``: records equal, masks
    decoding to the same pixels;
(d) convert_torchvision_resnet on a random state_dict with torchvision's
    ResNet-50 keys and shapes against JAX ``convert`` through
    ``weights.state_dict_from_flax``, and the checkpoint it writes loaded by
    ``restore_model_state_partial``;
(e) check_ap_floor on the port's own log lines, and ap_ablation's
    assertions;
(f) synth_e2e_gate at a toy size on the CPU: every stage, each best
    checkpoint, the metrics file; no GPU and no ``--device cpu`` refused; a
    failing stage ends the gate;
(g) what the gate trains with: the Loader's worker processes and
    per-batch seeds, and best copies as hard links that replace each other.
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from multiposenet_tpu.data.coco_json import COCOIndex as JCOCOIndex

from multiposenet_tpu_torch.config import Config, DataConfig
from multiposenet_tpu_torch.data.coco_json import COCOIndex
from multiposenet_tpu_torch.data.datasets import (
    DetectionDataset, KeypointDataset, PRNDataset, load_coco_json_index,
    split_keypoint_records)
from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
from multiposenet_tpu_torch.eval import render
from multiposenet_tpu_torch.models.fpn import ResNetFPN
from multiposenet_tpu_torch.ops.heatmap import make_heatmaps_np
from multiposenet_tpu_torch.tools import (
    ap_ablation, check_ap_floor, convert_torchvision_resnet, make_coco_json,
    make_synth_pose_dataset, synth_e2e_gate)
from multiposenet_tpu_torch.weights import state_dict_from_flax
from torch_port_helpers import model_files  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import convert_torchvision_resnet as jconvert  # noqa: E402
import make_coco_json as jmake_coco_json  # noqa: E402
import make_synth_pose_dataset as jsynth  # noqa: E402

sys.path.pop(0)

# the background's float32 INTER_CUBIC upscale is cv2's IPP path, which
# data/imgproc.resize_cubic models within 1e-6: after the noise and the
# uint8 cast, 8.7e-6 of background values sit one level off (200 seeded
# 320x240 backgrounds); every drawn pixel is cv2's own
BG_MAX_SHARE = 1e-4


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("primitive", ["line", "line_fixed", "thick_line",
                                       "circle", "fill_convex_poly"])
def test_anti_aliased_primitives_equal_cv2(primitive):
    rng = np.random.default_rng(["line", "line_fixed", "thick_line", "circle",
                                 "fill_convex_poly"].index(primitive))
    h, w = 48, 64
    for _ in range(150):
        canvas = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want, got = canvas.copy(), canvas.copy()
        col = tuple(int(v) for v in rng.integers(0, 256, 3))
        p1 = (int(rng.integers(-16, w + 16)), int(rng.integers(-16, h + 16)))
        p2 = (int(rng.integers(-16, w + 16)), int(rng.integers(-16, h + 16)))
        if rng.random() < 0.2:                 # short and zero-length lines
            p2 = (p1[0] + int(rng.integers(-2, 3)), p1[1] + int(rng.integers(-2, 3)))
        if primitive == "line":
            cv2.line(want, p1, p2, col, 1, cv2.LINE_AA)
            render.thick_line_aa(got, p1, p2, col, 1)
        elif primitive == "line_fixed":        # 16.16 endpoints
            q1 = tuple(int(v) for v in rng.integers(-16 << 16, (w + 16) << 16, 2))
            q2 = tuple(int(v) for v in rng.integers(-16 << 16, (h + 16) << 16, 2))
            cv2.line(want, q1, q2, col, 1, cv2.LINE_AA, 16)
            render.line_aa(got, q1, q2, col)
        elif primitive == "thick_line":
            t = int(rng.integers(2, 10))
            cv2.line(want, p1, p2, col, t, cv2.LINE_AA)
            render.thick_line_aa(got, p1, p2, col, t)
        elif primitive == "circle":
            r = int(rng.integers(0, 24))
            cv2.circle(want, p1, r, col, -1, cv2.LINE_AA)
            render.circle_aa(got, p1, r, col)
        else:
            n = int(rng.integers(3, 8))
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            c = rng.uniform([-8, -8], [w + 8, h + 8])
            rad = rng.uniform(2, 30)
            pts = ((c + rad * np.stack([np.cos(ang), np.sin(ang)], 1)) * 65536
                   ).astype(np.int64).astype(np.int32)
            cv2.fillConvexPoly(want, pts, col, cv2.LINE_AA, 16)
            render.fill_convex_poly(got, pts, col, 16, aa=True)
        np.testing.assert_array_equal(got, want, err_msg=f"{primitive} {p1} {p2}")


# ---------------------------------------------------------------- (b)

TREES = {
    # the JAX tests' tree (tests/test_synth_dataset.py) and a crowd seed
    "plain": dict(n_train=4, n_val=2, width=320, height=256, seed=3,
                  crowd_frac=0.25),
    "crowd": dict(n_train=4, n_val=2, width=320, height=240, seed=1,
                  crowd_frac=1.0),
}


def _jax_tree(root, spec):
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synth_pose_dataset.py"),
         "--root", root, "--n-train", str(spec["n_train"]),
         "--n-val", str(spec["n_val"]), "--width", str(spec["width"]),
         "--height", str(spec["height"]), "--seed", str(spec["seed"]),
         "--crowd-frac", str(spec["crowd_frac"])],
        check=True, capture_output=True,
        env={**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")})


@pytest.fixture(scope="module", params=sorted(TREES))
def trees(request, tmp_path_factory):
    spec = TREES[request.param]
    port = str(tmp_path_factory.mktemp(f"port_{request.param}"))
    jax_root = str(tmp_path_factory.mktemp(f"jax_{request.param}"))
    make_synth_pose_dataset.generate(port, workers=1, **spec)
    _jax_tree(jax_root, spec)
    return port, jax_root, spec


def _stem(name: str) -> str:
    return os.path.splitext(name)[0]


def test_synthetic_tree_annotations_equal_jax(trees):
    port, jax_root, _ = trees
    with open(os.path.join(port, "COCO.json")) as f:
        got = json.load(f)["root"]
    with open(os.path.join(jax_root, "COCO.json")) as f:
        want = json.load(f)["root"]
    assert all(r["img_paths"].endswith(".png") for r in got)
    for r in got + want:
        r["img_paths"] = _stem(r["img_paths"])
    assert got == want
    for split in ("train2017", "val2017"):
        docs = []
        for root in (port, jax_root):
            with open(os.path.join(root, "annotations",
                                   f"person_keypoints_{split}.json")) as f:
                doc = json.load(f)
            for im in doc["images"]:
                im["file_name"] = _stem(im["file_name"])
            docs.append(doc)
        assert docs[0] == docs[1], split
    for root, ext in ((port, ".png"), (jax_root, ".jpg")):
        names = sorted(os.listdir(os.path.join(root, "images", "val2017")))
        assert names and all(n.endswith(ext) for n in names)


def _jax_canvases(spec):
    """The JAX tool's pre-encode canvases: its ``main`` loop (:164-190)
    with its own ``background``, ``sample_person`` and ``draw_person``."""
    rng = np.random.default_rng(spec["seed"])
    w, h = spec["width"], spec["height"]
    out = []
    for i in range(spec["n_train"] + spec["n_val"]):
        img = jsynth.background(rng, w, h)
        people = []
        if rng.random() < spec["crowd_frac"]:
            n_want, h_range = int(rng.integers(6, 11)), (55.0, 140.0)
        else:
            n_want, h_range = int(rng.integers(1, 4)), None
        for _ in range(n_want):
            p = jsynth.sample_person(rng, w, h, h_range=h_range)
            if p is not None:
                people.append(p)
        retry = np.random.default_rng(spec["seed"] + i)
        while not people:
            p = jsynth.sample_person(retry, w, h, h_range=h_range)
            if p is not None:
                people.append(p)
        for kp, body in people:
            jsynth.draw_person(img, kp, body, rng)
        out.append(img)
    return out


def test_synthetic_canvases_equal_jax_draws(trees):
    port, _, spec = trees
    off = total = 0
    for i, want in enumerate(_jax_canvases(spec)):
        tag = "val" if i >= spec["n_train"] else "train"
        got = cv2.imread(os.path.join(port, "images",
                                      f"COCO_{tag}2014_{i:012d}.png"))
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1, i
        off += int((d > 0).sum())
        total += d.size
    assert off <= BG_MAX_SHARE * total, (off, total)


def test_background_upscale_share():
    off = total = 0
    for seed in range(20):
        got = make_synth_pose_dataset.background(np.random.default_rng(seed), 320, 240)
        want = jsynth.background(np.random.default_rng(seed), 320, 240)
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1
        off += int((d > 0).sum())
        total += d.size
    assert off <= BG_MAX_SHARE * total, (off, total)


def _data_cfg(root, size=256):
    return DataConfig(coco_root=root, json_path=os.path.join(root, "COCO.json"),
                      mask_dir=root, inp_size=size, num_workers=0)


def test_synthetic_tree_feeds_the_port_datasets(trees):
    """The tree through the port's three datasets and the eval layout, as
    tests/test_synth_dataset.py reads the JAX tree."""
    root, _, spec = trees
    cfg = _data_cfg(root)
    records = load_coco_json_index(cfg.json_path)
    for rec in records:
        assert (np.asarray(rec["joint_self"])[:, 2] <= 1.0).sum() >= 8
    idx = split_keypoint_records(records, True)
    ds = KeypointDataset(records, idx, os.path.join(root, "images"),
                         cfg.mask_dir, cfg, augment=False)
    s = ds[0]
    assert (s["joints"][..., 2] <= 1.0).sum() >= 5
    heat = make_heatmaps_np(s["joints"], 64, 64, stride=4, sigma=7.0)
    assert float(heat.max()) > 0.9
    assert float(s["mask"].min()) > 0.99

    ann = os.path.join(root, "annotations", "person_keypoints_train2017.json")
    coco = COCOIndex(ann)
    ids = set(coco.get_img_ids())
    det = DetectionDataset(records, [i for i, r in enumerate(records)
                                     if int(r["image_id"]) in ids], coco,
                           os.path.join(root, "train2017"), cfg, augment=False)
    boxes = det[0]["boxes"]
    real = boxes[boxes[:, 4] == 0]
    assert len(real) >= 1
    assert ((real[:, 2] > real[:, 0]) & (real[:, 3] > real[:, 1])).all()

    prn = PRNDataset(coco, Config())
    s = prn[0]
    assert s["label_marks"].max() == 1.0
    assert s["weights_marks"].sum() >= s["label_marks"].sum()

    val = COCOIndex(os.path.join(root, "annotations",
                                 "person_keypoints_val2017.json"))
    assert len(val.get_img_ids()) == spec["n_val"]
    for info in val.load_imgs(val.get_img_ids()):
        assert os.path.exists(os.path.join(root, "images", "val2017",
                                           info["file_name"]))
    per_img = [len(val.img_to_anns[i]) for i in val.get_img_ids()]
    if spec["crowd_frac"] == 1.0:
        assert max(per_img) >= 6


# ---------------------------------------------------------------- (c)

def _index_dataset():
    """tests/test_make_coco_json.py's fixture plus a crowd RLE region and a
    keypointless polygon person."""
    def person(aid, nk, bbox, v=2, **kw):
        kps = []
        for j in range(17):
            kps += [bbox[0] + 5 + j, bbox[1] + 5 + j, v] if j < nk else [0, 0, 0]
        seg = [[bbox[0], bbox[1], bbox[0] + bbox[2], bbox[1],
                bbox[0] + bbox[2], bbox[1] + bbox[3], bbox[0], bbox[1] + bbox[3]]]
        return {"id": aid, "image_id": 7, "category_id": 1, "iscrowd": 0,
                "num_keypoints": nk, "area": bbox[2] * bbox[3], "bbox": bbox,
                "keypoints": kps, "segmentation": seg, **kw}

    rle = np.zeros((120, 160), np.uint8)
    rle[60:90, 100:150] = 1
    counts, prev, run = [], 0, 0
    for v in rle.T.reshape(-1):       # column-major runs, starting with 0s
        if v != prev:
            counts.append(run)
            prev, run = v, 0
        run += 1
    counts.append(run)
    return {
        "images": [{"id": 7, "height": 120, "width": 160,
                    "file_name": "COCO_val2014_000000000007.jpg"}],
        "categories": [{"id": 1, "name": "person"}],
        "annotations": [
            person(1, 12, [10, 10, 40, 60]),
            person(2, 8, [90, 20, 40, 60], v=1),
            person(3, 0, [10, 80, 30, 30]),
            person(4, 3, [60, 5, 20, 20]),
            person(5, 0, [100, 60, 50, 30], iscrowd=1,
                   segmentation={"size": [120, 160], "counts": counts}),
        ],
    }


def test_make_coco_json_equals_jax(tmp_path):
    records, want = [], []
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    got_dir.mkdir()
    want_dir.mkdir()
    ds = _index_dataset()
    make_coco_json.process_split(COCOIndex(dataset=json.loads(json.dumps(ds))),
                                 "COCO_val", {7}, records, str(got_dir), 0,
                                 img_prefix="val2014")
    jmake_coco_json.process_split(JCOCOIndex(dataset=json.loads(json.dumps(ds))),
                                  "COCO_val", {7}, want, str(want_dir), 0,
                                  img_prefix="val2014")
    assert len(records) == 2
    assert records == want
    name = "val2014_mask_miss_000000000007.png"
    got = cv2.imread(str(got_dir / name), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, cv2.imread(str(want_dir / name),
                                                  cv2.IMREAD_UNCHANGED))
    assert got[95, 25] == 0 and got[70, 120] == 0 and got[40, 30] == 255
    kp = np.asarray(records[1]["joint_self"])
    assert (kp[:8, 2] == 0).all() and (kp[8:, 2] == 2).all()


def test_make_coco_json_main(tmp_path):
    root = tmp_path / "coco"
    (root / "annotations").mkdir(parents=True)
    ds = _index_dataset()
    for split in ("val2014", "train2014"):
        (root / "annotations" / f"person_keypoints_{split}.json").write_text(
            json.dumps(ds))
    out = tmp_path / "COCO.json"
    assert make_coco_json.main(["--coco-root", str(root), "--out-json", str(out),
                                "--mask-dir", str(tmp_path / "mask2014")]) == 4
    recs = json.loads(out.read_text())["root"]
    assert [r["isValidation"] for r in recs] == [1.0, 1.0, 0.0, 0.0]
    assert recs[0]["img_paths"] == os.path.join("val2014", "COCO_val2014_000000000007.jpg")
    assert recs[2]["annolist_index"] == 10 ** 6


# ---------------------------------------------------------------- (d)

def torchvision_resnet_state(blocks, seed=0):
    """A random state_dict with torchvision ResNet's keys and shapes
    (torchvision/models/resnet.py: Bottleneck, expansion 4)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(k, o, i, s):
        sd[f"{k}.weight"] = torch.randn(o, i, s, s, generator=g)

    def bn(k, c):
        sd[f"{k}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{k}.bias"] = torch.randn(c, generator=g)
        sd[f"{k}.running_mean"] = torch.randn(c, generator=g)
        sd[f"{k}.running_var"] = torch.rand(c, generator=g) + 0.1
        sd[f"{k}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    inplanes = 64
    for li, (planes, n) in enumerate(zip((64, 128, 256, 512), blocks), 1):
        for b in range(n):
            k = f"layer{li}.{b}"
            conv(f"{k}.conv1", planes, inplanes, 1)
            bn(f"{k}.bn1", planes)
            conv(f"{k}.conv2", planes, planes, 3)
            bn(f"{k}.bn2", planes)
            conv(f"{k}.conv3", planes * 4, planes, 1)
            bn(f"{k}.bn3", planes * 4)
            if b == 0:
                conv(f"{k}.downsample.0", planes * 4, inplanes, 1)
                bn(f"{k}.downsample.1", planes * 4)
            inplanes = planes * 4
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


def test_convert_torchvision_resnet_equals_jax(model_files):
    sd = torchvision_resnet_state((3, 4, 6, 3))
    got, skipped = convert_torchvision_resnet.convert(sd)
    assert convert_torchvision_resnet.backbone_of(sd) == "resnet50"
    assert sorted(skipped) == sorted(k for k in sd if k.startswith("fc.")
                                     or k.endswith("num_batches_tracked"))
    params, stats, jskipped = jconvert.convert({k: v.numpy() for k, v in sd.items()})
    assert sorted(jskipped) == ["fc.bias", "fc.weight"]
    want = {k: v for k, v in state_dict_from_flax(
        {"params": params, "batch_stats": stats}).items()
        if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # every trunk entry of the port's FPN is filled (its FPN layers are not
    # in an ImageNet ResNet)
    trunk = {"fpn." + k for k in ResNetFPN((3, 4, 6, 3)).state_dict()
             if k.split(".")[0] in ("conv1", "bn1", "layer1", "layer2",
                                    "layer3", "layer4")
             and not k.endswith("num_batches_tracked")}
    assert set(got) == trunk

    pth = model_files / "resnet50.pth"
    torch.save(sd, pth)
    path = convert_torchvision_resnet.main([str(pth), str(model_files / "init")])
    template = {"fpn." + k: v for k, v in ResNetFPN((3, 4, 6, 3)).state_dict().items()}
    loaded, stats = ckpt_lib.restore_model_state_partial(path, template)
    assert stats["loaded"] == len(got) and stats["shape_skipped"] == 0
    assert torch.equal(loaded["fpn.layer3.5.bn3.running_var"],
                       sd["layer3.5.bn3.running_var"])

    bad = dict(sd)
    bad["layer4.0.conv9.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="conv9"):
        convert_torchvision_resnet.convert(bad)
    bad = dict(sd)
    bad["layer1.0.conv1.weight"] = torch.zeros(64, 64, 3, 3)
    with pytest.raises(ValueError, match="shape"):
        convert_torchvision_resnet.convert(bad)


# ---------------------------------------------------------------- (e)

def _port_warnings():
    """The port's own truncation warnings, as its logger formats them."""
    from multiposenet_tpu_torch.engine import evaluator
    from multiposenet_tpu_torch.utils.logging import logger

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(self.format(record))

    h = Keep()
    h.setFormatter(logger.handlers[0].formatter)
    logger.addHandler(h)
    try:
        rows = [[float(i), 1.0, 1.0, i, 0] for i in range(5)]
        evaluator._joints_to_peak_arrays(rows, 3, context="img.png")
        valid = np.ones((17, 3), bool)
        evaluator.peak_arrays_to_joint_list(np.zeros((17, 3, 2)),
                                            np.ones((17, 3)), valid)
    finally:
        logger.removeHandler(h)
    return lines


def test_check_ap_floor_on_port_logs(tmp_path):
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps({"AP": 0.630}))
    bad.write_text(json.dumps({"AP": 0.630 * 0.9}))
    assert check_ap_floor.check(str(good), 0.58)
    assert not check_ap_floor.check(str(bad), 0.58)
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    assert not check_ap_floor.check(str(empty), 0.0)

    clean = tmp_path / "clean.log"
    clean.write_text(
        "2026-10-17 09:13:20,486 INFO multiposenet_tpu_torch: 000000000130.png: "
        "peak capacity 8 saturated — re-dispatching at the escalated tier 128\n"
        "2026-10-17 09:14:15,143 INFO multiposenet_tpu_torch: 000000000130.png: "
        "crowd overflow (9 peaks/joint, 7 boxes) — escalating PRN capacity to "
        "(128 peaks, 256 people)\n"
        "2026-10-17 09:14:15,200 WARNING multiposenet_tpu_torch: group_size=4 "
        "ignored: grouped dispatch needs the whole device path\n"
        "2026-10-17 09:14:16,000 WARNING somelib: 3 items dropped\n")
    assert check_ap_floor.check_no_truncation(str(clean))
    warned = _port_warnings()
    assert len(warned) == 2
    for bad_line in warned + [
        # engine/evaluator.py's PRN person-capacity overflow
        "2026-10-17 09:14:17,000 WARNING multiposenet_tpu_torch: img.png: 12 "
        "person boxes exceed the PRN person capacity 8; the 4 lowest-ranked "
        "are dropped — raise cfg.prn.max_people / escalate_max_people"]:
        log = tmp_path / "bad.log"
        log.write_text(clean.read_text() + bad_line + "\n")
        assert not check_ap_floor.check_no_truncation(str(log)), bad_line
    good = tmp_path / "m.json"
    good.write_text(json.dumps({"AP": 0.643}))
    assert check_ap_floor.main([str(good), "0.60", str(clean)]) == 0
    assert check_ap_floor.main([str(good), "0.65", str(clean)]) == 1
    assert check_ap_floor.main([str(good), "0.60", str(log)]) == 1


def test_ap_ablation_assertions(tmp_path, monkeypatch):
    base = {"AP": 0.643, "AP50": 0.783, "AR": 0.7}

    def fake(by_name):
        def run_eval(args, name, flags, out_dir):
            return dict(by_name.get(name, base))
        return run_eval

    argv = ["--coco-root", "r", "--ckpt", "c", "--out-dir", str(tmp_path),
            "--assert-tol", "0.02"]
    monkeypatch.setattr(ap_ablation, "run_eval", fake({}))
    assert ap_ablation.main(argv) == 0
    table = (tmp_path / "ablation_table.md").read_text()
    assert "| xla_nms | - |" in table and "K1 serves every path" in table
    for by_name, rc in (({"bf16": {**base, "AP": 0.613}}, 1),
                        ({"fold_bn": {**base, "AP": 0.630}}, 0),
                        ({"host_grouping": {**base, "AR": 0.7 + 1e-6}}, 1),
                        ({"no_refine": {**base, "AP": 0.5}}, 0)):
        monkeypatch.setattr(ap_ablation, "run_eval", fake(by_name))
        assert ap_ablation.main(argv) == rc, by_name
    monkeypatch.setattr(ap_ablation, "run_eval", fake({}))
    assert ap_ablation.main(argv + ["--only", "bf16"]) == 0
    assert set(json.loads((tmp_path / "ablation.json").read_text())) == {
        "default", "bf16"}


# ---------------------------------------------------------------- (g)

LOADER_CHECK = """
from multiposenet_tpu_torch.data.loader import Loader
from torch_port_loader_items import Items


def epochs(**kw):
    loader = Loader(Items(), batch_size=4, seed=3, **kw)
    return [[b["x"].tolist() + b["r"].tolist() for b in loader] for _ in range(3)]


assert epochs(num_workers=1, processes=True) == epochs(num_workers=1)
want = epochs(num_workers=1, seed_per_batch=True)
assert epochs(num_workers=3, seed_per_batch=True) == want
assert epochs(num_workers=3, processes=True, seed_per_batch=True) == want
try:
    list(Loader(Items(fail=True), batch_size=4, num_workers=2, processes=True,
                shuffle=False))
except RuntimeError as e:
    assert "sample 17 is unreadable" in str(e), e
else:
    raise AssertionError("the worker's exception did not reach the consumer")
print("ok")
"""


def test_loader_worker_processes_and_batch_seeds():
    """Worker processes give the thread workers' batches (one worker: the
    same draws) over epochs that they build ahead; with seed_per_batch the
    batches are the same whatever the number and kind of workers; a
    sample's exception reaches the consumer.  In a process of its own: the
    workers are forked, and this one runs JAX's threads."""
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", LOADER_CHECK], capture_output=True,
                       text=True, timeout=120, cwd=here,
                       env={**os.environ, "PYTHONPATH": os.pathsep.join(
                           [REPO, here, os.environ.get("PYTHONPATH", "")])})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_best_copies_are_links_and_replace_each_other(model_files):
    """copy_best hard-links the checkpoint's files, and a stage keeps only
    its newest best copy."""
    from multiposenet_tpu_torch.config import keypoint_train_config
    from multiposenet_tpu_torch.engine.trainer import Trainer

    ckpt = model_files / "ckpt_3"
    ckpt.mkdir()
    (ckpt / ckpt_lib.STATE_FILE).write_bytes(b"state")
    best = ckpt_lib.copy_best(str(ckpt), 0.5)
    assert os.path.samefile(os.path.join(best, ckpt_lib.STATE_FILE),
                            ckpt / ckpt_lib.STATE_FILE)

    cfg = keypoint_train_config()
    cfg = dataclasses.replace(   # a narrow PRN keeps the checkpoints small
        cfg, model=dataclasses.replace(cfg.model, backbone="resnet50",
                                       prn_node_count=64),
        train=dataclasses.replace(cfg.train, max_epoch=3, save_dir=str(model_files),
                                  exp_name="kp", print_freq=10 ** 6))
    tr = Trainer(cfg, train_data=[], val_data=[], device="cpu")
    losses = iter([0.3, 0.2, 0.1])
    tr.validate = lambda n: next(losses)
    tr.train()
    names = sorted(os.listdir(model_files / "kp"))
    assert [n for n in names if n.endswith(".best")] == ["ckpt_3_0.10000.best"]
    assert {"ckpt_1", "ckpt_2", "ckpt_3"} <= set(names)


# ---------------------------------------------------------------- (f)

TOY = ["--device", "cpu", "--n-train", "6", "--n-val", "2", "--width", "128",
       "--height", "96", "--kp-inp-size", "64", "--det-inp-size", "96",
       "--eval-inp-size", "64", "--batch-size", "2", "--max-epoch", "1",
       "--num-workers", "2", "--floor", "0.0", "--no-ablation"]


def test_synth_gate_runs_every_stage_on_the_cpu(model_files, capsys, monkeypatch):
    """The toy model detects nobody after one epoch, so its metrics file is
    ``{}`` and the floor check fails even at 0.0 (a metrics file without an
    AP never passes); every stage before it ran and chose its best.  Its
    CLI processes run on two threads each, beside the other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    _toy_gate(model_files, model_files / "models", capsys)


def _toy_gate(tmp_path, save, capsys):
    rc = synth_e2e_gate.main(TOY + ["--root", str(tmp_path / "coco"),
                                    "--save-dir", str(save)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.exists(tmp_path / "coco" / synth_e2e_gate.MARKER)
    for exp in ("kp", "det", "prn"):
        best = synth_e2e_gate.best_checkpoint(str(save), exp)
        assert os.path.exists(os.path.join(best, ckpt_lib.STATE_FILE))
    assert out["best_checkpoint"] == synth_e2e_gate.best_checkpoint(str(save), "prn")
    assert set(out["wall_s"]) == {"dataset", "keypoint", "detection", "prn",
                                  "coco_eval"}
    assert out["eval_images"] == 2 and out["nms_suppress_launches"] == 0
    with open(save / "gate_metrics.json") as f:
        metrics = json.load(f)
    assert rc == (0 if "AP" in metrics else 1)
    assert out["passed"] == (rc == 0)
    assert check_ap_floor.truncation_lines(str(save / "coco_eval.log")) == []


def test_synth_gate_refuses_without_a_gpu_and_stops_at_a_failing_stage(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(synth_e2e_gate.GateError, match="no CUDA device"):
            synth_e2e_gate.run_gate(synth_e2e_gate.parse_args(
                ["--root", str(tmp_path / "c"), "--save-dir", str(tmp_path / "m")]))
    # an unknown backbone: the keypoint stage's command line fails
    rc = synth_e2e_gate.main(TOY + ["--root", str(tmp_path / "coco"),
                                    "--save-dir", str(tmp_path / "m2"),
                                    "--backbone", "resnet18"])
    assert rc == 1
    assert not os.path.exists(tmp_path / "m2" / "det")
