"""multiposenet_tpu_torch serving front: BatchPredictor from pixels against
the JAX BatchPredictor, the cv2-free letterbox, and the package's isolation
from JAX.  CPU, float32."""

import subprocess
import sys
import textwrap
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiposenet_tpu.engine.inference import preprocess_on_device as j_preprocess
from multiposenet_tpu.engine.predictor import BatchPredictor as JBatchPredictor
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch.engine.predictor import BatchPredictor
from multiposenet_tpu_torch.ops import cuda_nms
from multiposenet_tpu_torch.weights import state_dict_from_flax
from torch_port_helpers import (
    HEAD_STD,
    LOWERED,
    jax_config,
    perturbed_init,
    port_config,
)

SIZE = 64


@pytest.fixture(scope="module")
def served():
    jm, v = perturbed_init("resnet50", SIZE, seed=2, head_std=HEAD_STD)
    # square images at the model's size: the letterbox resizes nothing, so
    # both predictors see the same pixels; 6 images at batch 4 leave a
    # ragged tail
    bgr = [(np.random.RandomState(20 + i).rand(SIZE, SIZE, 3) * 255)
           .astype(np.uint8) for i in range(6)]
    want = JBatchPredictor(jax_config(SIZE), jm, v, batch_size=4).predict(bgr)
    tpred = BatchPredictor(port_config(SIZE), state_dict_from_flax(v),
                           batch_size=4, device="cpu")
    return jm, v, bgr, want, tpred


def test_predict_from_pixels_equals_jax(served):
    jm, v, bgr, want, tpred = served
    got = tpred.predict(bgr)
    assert len(got) == len(want) == 6
    assert sum(bool(people) for people in got) >= 2
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            # box coordinates carry the model's regression error (f32 conv
            # summation order, ~3e-6 relative) through exp(): 2e-5 relative
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=2e-5, atol=1e-5)
            assert g["score"] == w["score"]
            np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=1e-5)

    # the threshold decisions clear the model's error by a wide margin, so
    # the equality above cannot hinge on f32 conv summation order
    rgb = np.stack([im[:, :, ::-1] for im in bgr])
    jh, jc, _ = jax.device_get(jax.jit(
        lambda v, x: jm.apply(v, j_preprocess(x), method=JPoseNet.full_forward)
    )(v, jnp.asarray(rgb)))
    th, tc, _ = tpred._pipeline.forward(torch.from_numpy(rgb.copy()))
    d_cls = float(np.abs(tc.numpy() - jc).max())
    d_hm = float(np.abs(th.numpy() - jh).max())
    assert d_cls < 1e-5 and d_hm < 1e-9
    for thresh in (LOWERED["score_thresh"], LOWERED["test_score_thresh"]):
        assert np.abs(jc - thresh).min() > 10 * max(d_cls, 1e-9)
    # thre1 decides only at local maxima (4-connected cross, -inf border)
    pad = np.pad(jh, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-np.inf)
    cross = np.maximum.reduce([pad[:, :-2, 1:-1], pad[:, 2:, 1:-1],
                               pad[:, 1:-1, :-2], pad[:, 1:-1, 2:]])
    local_max = jh[jh >= cross]
    assert np.abs(local_max - LOWERED["thre1"]).min() > 10 * max(d_hm, 1e-12)
    # the top-k order of the detection scores is decided with margin too
    top = -np.sort(-jc[..., 0], axis=1)[:, :LOWERED["max_detections"] + 1]
    assert (-np.diff(top, axis=1)).min() > 10 * max(d_cls, 1e-9)


def test_predict_stream_equals_predict(served):
    _, _, bgr, want, tpred = served
    streamed = list(tpred.predict_stream(iter(bgr)))
    assert len(streamed) == len(bgr)
    for s_img, w_img in zip(streamed, want):
        assert [p["score"] for p in s_img] == [p["score"] for p in w_img]


@pytest.mark.parametrize("hw", [(50, 100), (120, 70), (64, 30), (200, 199),
                                (33, 17)])
def test_pack_letterbox_matches_cv2(served, hw):
    """Port letterbox against the JAX predictor's cv2.resize(INTER_LINEAR):
    within one uint8 step (cv2 rounds fixed-point weights), and exact when
    the padded square is already the model's size."""
    tpred = served[4]
    img = (np.random.RandomState(sum(hw)).rand(*hw, 3) * 255).astype(np.uint8)
    want, wscale = JBatchPredictor._pack(types.SimpleNamespace(inp=SIZE), img)
    got, scale = tpred._pack(img)
    assert scale == wscale
    assert got.dtype == torch.uint8 and got.shape == (SIZE, SIZE, 3)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    if max(hw) == SIZE:
        assert diff.max() == 0
    else:
        assert diff.max() <= 1


def test_port_imports_nothing_of_jax():
    code = textwrap.dedent("""
        import sys
        import multiposenet_tpu_torch
        import multiposenet_tpu_torch.config, multiposenet_tpu_torch.weights
        import multiposenet_tpu_torch._build
        import multiposenet_tpu_torch.models.fpn, multiposenet_tpu_torch.models.subnets
        import multiposenet_tpu_torch.models.posenet
        import multiposenet_tpu_torch.ops.anchors, multiposenet_tpu_torch.ops.boxes
        import multiposenet_tpu_torch.ops.nms, multiposenet_tpu_torch.ops.cuda_nms
        import multiposenet_tpu_torch.ops.peaks, multiposenet_tpu_torch.ops.gaussian
        import multiposenet_tpu_torch.ops.grouping
        import multiposenet_tpu_torch.eval.grouping
        import multiposenet_tpu_torch.engine.inference
        import multiposenet_tpu_torch.engine.predictor
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "multiposenet_tpu" or m.startswith("multiposenet_tpu."))
        assert not bad, bad
        assert "cv2" not in sys.modules
        print("ok", len([m for m in sys.modules
                         if m.startswith("multiposenet_tpu_torch")]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")
    assert int(out.stdout.split()[1]) >= 16


def test_entry_points_refuse_to_fall_back_to_cpu(served):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, v, _, _, tpred = served
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchPredictor(port_config(SIZE), state_dict_from_flax(v))
    from multiposenet_tpu_torch.engine.inference import make_e2e_pose_pipeline
    with pytest.raises(RuntimeError, match="CUDA"):
        make_e2e_pose_pipeline(tpred.model, port_config(SIZE), (SIZE, SIZE))
    # the kernel wrapper takes CUDA tensors only: no silent CPU twin
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nms.nms_suppress_cuda(torch.zeros(1, 4, 4), torch.ones(1, 4, dtype=torch.bool), 0.5)
