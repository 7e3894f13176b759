"""multiposenet_tpu_torch Evaluator against the JAX Evaluator on the CPU:
the multi-scale COCO eval with the forward stubbed by GT-derived maps (the
tests/test_integration.py set-up), crowd escalation, the real forward of
one random model carried across, the single-scale demo path, and the
refusal to run on the CPU unasked."""

import dataclasses
import json
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiposenet_tpu.config import Config as JConfig
from multiposenet_tpu.config import DataConfig as JDataConfig
from multiposenet_tpu.config import ModelConfig as JModelConfig
from multiposenet_tpu.engine.evaluator import Evaluator as JEvaluator
from multiposenet_tpu.eval.multiscale import get_multipliers
from multiposenet_tpu.ops.anchors import anchors_for_shape
from multiposenet_tpu.ops.heatmap import make_heatmaps_np

from multiposenet_tpu_torch.config import Config, ModelConfig
from multiposenet_tpu_torch.engine import evaluator as teval
from multiposenet_tpu_torch.engine.evaluator import Evaluator
from torch_port_helpers import (
    HEAD_STD,
    ForwardStub,
    GTForward,
    jax_config,
    perturbed_init,
    port_config,
    port_model,
    synthetic_coco,
)

SIZE = 64


@pytest.fixture(scope="module")
def weights():
    jm, v = perturbed_init("resnet50", SIZE, seed=3, head_std=HEAD_STD)
    return jm, v, port_model(v, port_config(SIZE))


def _configs(inp, scale_search, **over):
    """JAX and port configurations of a multi-scale eval, with the
    ``peaks`` / ``prn`` fields in ``over`` replaced in both."""
    jcfg = JConfig(model=JModelConfig(backbone="resnet50"),
                   data=JDataConfig(inp_size=inp))
    cfg = Config(model=ModelConfig(backbone="resnet50"))
    out = []
    for c in (jcfg, cfg):
        c = dataclasses.replace(c, eval=dataclasses.replace(
            c.eval, inp_size=inp, scale_search=scale_search, flip=True))
        for section, fields in over.items():
            c = dataclasses.replace(c, **{section: dataclasses.replace(
                getattr(c, section), **fields)})
        out.append(c)
    return out


def _stubbed_coco_eval(tmp_path, weights, people, scale_search, **over):
    """coco_eval of both packages, forward stubbed by GTForward.  Returns
    (JAX metrics, results, stub), (port metrics, results, stub, evaluator)."""
    jm, v, tm = weights
    ann_file, gt = synthetic_coco(str(tmp_path), people)
    jcfg, cfg = _configs(128, scale_search, **over)
    runs = []
    jev = JEvaluator(jcfg, jm, v)
    jstub = GTForward(gt, 128, scale_search)
    jev.pipeline = jstub.jax_pipeline
    jfile = str(tmp_path / "jax.json")
    jmetrics = jev.coco_eval(ann_file=ann_file, img_dir=str(tmp_path),
                             result_file=jfile)
    with open(jfile) as f:
        runs.append((jmetrics, json.load(f), jstub))

    ev = Evaluator(cfg, model=tm, device="cpu")
    stub = GTForward(gt, 128, scale_search)
    ev.pipeline = stub.port_pipeline
    tfile = str(tmp_path / "port.json")
    metrics = ev.coco_eval(ann_file=ann_file, img_dir=str(tmp_path),
                           result_file=tfile)
    with open(tfile) as f:
        runs.append((metrics, json.load(f), stub, ev))
    return runs


def _assert_results_equal(got, want):
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["keypoints"] == w["keypoints"]
        assert g["score"] == w["score"]
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-5)


def _assert_metrics_equal(got, want):
    assert got.keys() == want.keys() and len(got) == 10
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_coco_eval_stubbed_forward_equals_jax(tmp_path, weights):
    """(a) Everything after the forward is real in both packages: pyramid,
    the fused resize + sum + flip fold + peaks, scale-1.0 boxes, PRN and
    grouping, COCO order, OKS evaluation."""
    (jmetrics, jres, jstub), (metrics, res, stub, ev) = _stubbed_coco_eval(
        tmp_path, weights, [[(45, 60), (150, 70)], [(60, 100)], [(170, 110)]],
        (0.5, 1.0, 1.5))
    _assert_results_equal(res, jres)
    _assert_metrics_equal(metrics, jmetrics)
    assert metrics["AP"] > 0.8, metrics
    assert len(res) == 4
    # one forward per scale and image: nothing escalated
    assert stub.calls == jstub.calls == {1: 3, 2: 3, 3: 3}
    assert ev.escalated == []


def test_crowd_escalation_equals_jax(tmp_path, weights):
    """(b) Three people in image 1 fill both peak slots of every joint: the
    image is dispatched again at 8 peaks, and its 3 boxes group at the
    escalated (8 peaks, 4 people) PRN tier; image 2 stays at the base."""
    (jmetrics, jres, jstub), (metrics, res, stub, ev) = _stubbed_coco_eval(
        tmp_path, weights, [[(45, 60), (150, 70), (100, 125)], [(60, 100)]],
        (0.5, 1.0),
        peaks=dict(max_peaks_per_joint=2, escalate_max_peaks=8),
        prn=dict(max_people=1, escalate_max_people=4))
    _assert_results_equal(res, jres)
    _assert_metrics_equal(metrics, jmetrics)
    assert stub.calls == jstub.calls == {1: 4, 2: 2}
    assert ev.escalated == [1]
    assert sum(r["image_id"] == 1 for r in res) == 3
    assert metrics["AP"] > 0.8, metrics


def _recording(pipeline, port: bool):
    """Wrap ``Evaluator.pipeline`` so that every call's batch and output are
    kept in ``record``."""
    record = []

    def make(hw, with_peaks=True, with_detections=True):
        run = pipeline(hw, with_peaks, with_detections)
        if port:
            def call(batch):
                out = run(batch)
                record.append((batch.numpy(), out))
                return out
        else:
            def call(params, batch):
                out = run(params, batch)
                record.append((np.asarray(batch), out))
                return out
        return call
    return make, record


def test_real_forward_equals_jax(weights):
    """(c) One random resnet50 in both packages, 2 scales with flip at
    inp_size 64: equal pyramid batches, per-scale heatmaps within the
    model tests' tolerance, the same scale-1.0 boxes."""
    jm, v, tm = weights
    jcfg = dataclasses.replace(jax_config(SIZE), eval=dataclasses.replace(
        jax_config(SIZE).eval, scale_search=(0.5, 1.0), flip=True))
    cfg = dataclasses.replace(port_config(SIZE), eval=dataclasses.replace(
        port_config(SIZE).eval, scale_search=(0.5, 1.0), flip=True))
    img = np.random.RandomState(4).randint(0, 256, (80, 100, 3), np.uint8)
    mult = get_multipliers(80, SIZE, (0.5, 1.0))

    jev = JEvaluator(jcfg, jm, v)
    jev.pipeline, jrec = _recording(jev.pipeline, port=False)
    _, jboxes, _, _ = jev._get_outputs_device(mult, img, bucket=64,
                                              with_flip=True)
    ev = Evaluator(cfg, model=tm, device="cpu")
    ev.pipeline, rec = _recording(ev.pipeline, port=True)
    boxes, _ = ev._get_outputs_device(mult, img, bucket=64, with_flip=True)

    assert [b.shape for b, _ in rec] == [(2, 64, 64, 3), (2, 64, 128, 3)]
    for (batch, out), (jbatch, jout) in zip(rec, jrec):
        np.testing.assert_array_equal(batch, jbatch)
        want = np.asarray(jout.heatmaps)
        err = np.abs(out.heatmaps.numpy() - want).max()
        # f32 conv summation order differs between the backends (model tests)
        assert err <= 2e-5 * np.abs(want).max()
    assert rec[0][1].detections is None and rec[1][1].detections is not None
    assert len(boxes) == len(jboxes[1]) > 0
    # box coordinates carry the regression's error through exp()
    np.testing.assert_allclose(boxes, jboxes[1], rtol=2e-5, atol=1e-4)


def _demo_heads(seed: int = 5):
    """(heatmaps, cls, reg) of one 64 px image: gaussian joints of two
    people, and one scoring anchor on each.  (With many overlapping boxes
    the random PRN scores a peak nearly alike in several boxes, and the
    assignment then hangs on float rounding.)"""
    rng = np.random.RandomState(seed)
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


def test_run_image_equals_jax(tmp_path, weights):
    """(d) The demo path with the forward stubbed in both packages: the
    same people from the same heads; a non-square image reaches the model
    within one uint8 step of cv2.resize."""
    import cv2

    jm, v, tm = weights
    heads = _demo_heads()
    jev = JEvaluator(jax_config(SIZE), ForwardStub(jm),
                     {"v": v, "heads": tuple(jnp.asarray(h) for h in heads)})
    ev = Evaluator(port_config(SIZE), model=tm, device="cpu")
    seen = []

    def forward(images):
        seen.append(images.numpy())
        return tuple(torch.from_numpy(h) for h in heads)
    ev.pipeline((SIZE, SIZE)).forward = forward

    img = np.random.RandomState(6).randint(0, 256, (SIZE, 48, 3), np.uint8)
    want, jhm = jev.run_image(img, "a.png", 7)
    got, hm = ev.run_image(img, "a.png", 7)
    np.testing.assert_array_equal(hm, np.asarray(jhm))
    # the square pad of a 64 x 48 image is the model's size: no resize
    sq = np.zeros((SIZE, SIZE, 3), np.uint8)
    sq[:, :48] = img
    np.testing.assert_array_equal(seen[-1][0], sq[:, :, ::-1])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["file_name"] == "a.png"
        assert g["image_id"] == 7
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], rtol=0,
                                   atol=1e-5)
        assert g["score"] == w["score"]
        # decode_boxes' exp differs by an ulp between XLA and PyTorch
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=1e-6, atol=1e-5)
    assert any(p["score"] > 0 for p in got)

    small = np.random.RandomState(7).randint(0, 256, (50, 40, 3), np.uint8)
    ev.run_image(small)
    sq = np.zeros((50, 50, 3), np.uint8)
    sq[:, :40] = small
    want_px = cv2.resize(sq, (SIZE, SIZE))[:, :, ::-1]
    assert np.abs(seen[-1][0].astype(int) - want_px.astype(int)).max() <= 1

    # test(): every readable file of a directory in name order, and the json
    cv2.imwrite(str(tmp_path / "b.png"), img)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    (tmp_path / "notes.txt").write_text("not an image")
    ev.cfg = dataclasses.replace(ev.cfg, eval=dataclasses.replace(
        ev.cfg.eval, write_json=True))
    rows = ev.test(str(tmp_path), str(tmp_path / "out"))
    assert [r["file_name"] for r in rows] == ["a.png"] * len(got) + ["b.png"] * len(got)
    with open(tmp_path / "out" / "multipose_results.json") as f:
        assert json.load(f) == rows


def test_evaluator_runs_on_the_gpu_unless_asked(weights):
    """(e) Without a GPU the evaluator raises unless given device='cpu';
    without weights it refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    tm = weights[2]
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(port_config(SIZE), model=tm)
    with pytest.raises(ValueError, match="state_dict"):
        Evaluator(port_config(SIZE), device="cpu")
    assert Evaluator(port_config(SIZE), model=tm, device="cpu").device.type == "cpu"


def test_reading_images_without_cv2_names_load_image(monkeypatch, tmp_path):
    """Without cv2 the evaluator's reader still reads PNG files
    (data/image_io); any other format raises, naming the file and
    ``load_image``."""
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0not a decodable jpeg")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="x.jpg.*load_image"):
        teval.read_image_bgr(str(tmp_path), "x.jpg")
    assert teval.read_image_bgr(str(tmp_path), "missing.png") is None


def test_eval_modules_import_nothing_of_jax():
    code = textwrap.dedent("""
        import sys
        import multiposenet_tpu_torch.engine.evaluator
        import multiposenet_tpu_torch.data.coco_json
        import multiposenet_tpu_torch.eval.cocoeval
        import multiposenet_tpu_torch.eval.multiscale
        import multiposenet_tpu_torch.ops.pyramid, multiposenet_tpu_torch.ops.resize
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "multiposenet_tpu" or m.startswith("multiposenet_tpu.")
                     or m == "cv2")
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
