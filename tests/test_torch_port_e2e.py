"""multiposenet_tpu_torch e2e pose pipeline, post-model, against the JAX e2e
pipeline on the CPU in float32.

The JAX model's (heatmaps, cls, reg) for a batch of images go into both the
JAX e2e post-processing and the port's ``E2EPosePipeline.postprocess``; the
grouped outputs must agree slot for slot.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiposenet_tpu.engine.inference import (
    format_pose_batch as j_format_pose_batch,
    make_e2e_pose_pipeline as j_make_e2e,
    preprocess_on_device as j_preprocess,
)
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch.engine.inference import (
    format_pose_batch,
    make_e2e_pose_pipeline,
    preprocess_on_device,
)
from torch_port_helpers import (
    HEAD_STD,
    ForwardStub,
    jax_config,
    perturbed_init,
    port_config,
    port_model,
)

SIZE = 64
SCALES = np.array([1.5, 1.0, 2.0, 1.25], np.float32)   # exact in f32


@pytest.fixture(scope="module")
def slice_run():
    jm, v = perturbed_init("resnet50", SIZE, seed=1, head_std=HEAD_STD)
    imgs = (np.random.RandomState(7).rand(4, SIZE, SIZE, 3) * 255).astype(np.uint8)
    fwd = jax.jit(lambda v, x: jm.apply(v, j_preprocess(x),
                                        method=JPoseNet.full_forward))
    heads = jax.device_get(fwd(v, jnp.asarray(imgs)))
    jrun = j_make_e2e(ForwardStub(jm), jax_config(SIZE), (SIZE, SIZE))
    jout, jassign = jax.device_get(
        jrun({"v": v, "heads": heads}, jnp.asarray(imgs), jnp.asarray(SCALES)))

    tpipe = make_e2e_pose_pipeline(port_model(v, port_config(SIZE)),
                                   port_config(SIZE), (SIZE, SIZE), device="cpu")
    tout, tassign = tpipe.postprocess(
        *(torch.from_numpy(np.array(h)) for h in heads), torch.from_numpy(SCALES))
    return jout, jassign, tout, tassign, imgs, heads


_EXACT = ("chosen", "active_any", "active", "peak_xy", "peak_valid",
          "box_valid")


def _assert_boxes_close(got, want, err_msg=""):
    # decode_boxes' exp differs by an ulp between XLA and PyTorch, so box
    # coordinates (and coords derived from them) agree to ~1e-6 relative
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=err_msg)


@pytest.mark.parametrize("field", _EXACT + ("boxes_xywh", "fallback_xy"))
def test_pose_assignments_equal_jax(slice_run, field):
    _, jassign, _, tassign = slice_run[:4]
    got = getattr(tassign, field).numpy()
    want = np.asarray(getattr(jassign, field))
    assert got.shape == want.shape
    if field in _EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        _assert_boxes_close(got, want)


def test_detections_and_peaks_equal_jax(slice_run):
    jout, _, tout, _ = slice_run[:4]
    for name in ("keep", "indices", "scores"):
        np.testing.assert_array_equal(
            getattr(tout.detections, name).numpy(),
            np.asarray(getattr(jout.detections, name)), err_msg=name)
    _assert_boxes_close(tout.detections.boxes.numpy(),
                        np.asarray(jout.detections.boxes), "boxes")
    np.testing.assert_array_equal(tout.peaks.coords.numpy(),
                                  np.asarray(jout.peaks.coords))
    np.testing.assert_array_equal(tout.peaks.valid.numpy(),
                                  np.asarray(jout.peaks.valid))
    # every image has more than K candidates above score_thresh, so each of
    # the K slots is valid and a slot not kept was suppressed by the greedy
    # scan: the scan both kept and suppressed boxes here
    cls = np.asarray(slice_run[5][1])[..., 0]
    assert ((cls > 0.05).sum(axis=1) > 32).all()
    keep = tout.detections.keep.numpy()
    assert keep.any() and (~keep).any()


def test_person_lists_equal_jax(slice_run):
    _, jassign, _, tassign = slice_run[:4]
    want = j_format_pose_batch(jassign)
    got = format_pose_batch(tassign)
    assert len(got) == len(want) == 4
    assert sum(bool(people) for people in got) >= 2
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            _assert_boxes_close(g["bbox"], w["bbox"])
            assert g["score"] == w["score"]
            np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=1e-5)
    assert any(p["score"] > 0 for img in got for p in img)


def test_preprocess_equals_jax(slice_run):
    imgs = slice_run[4]
    np.testing.assert_array_equal(
        preprocess_on_device(torch.from_numpy(imgs)).numpy(),
        np.asarray(j_preprocess(jnp.asarray(imgs))))
