"""multiposenet_tpu_torch ops against the JAX package, on the CPU.

Anchors, box decode/clip, NMS (the CUDA kernel's plain twin against the
Pallas kernel in interpret mode and against JAX nms), heatmap peaks, the
PRN stage and the device grouping.  Inputs are made with numpy from a seed
and handed to both sides.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiposenet_tpu.config import AnchorConfig as JAnchorConfig
from multiposenet_tpu.config import Config as JConfig
from multiposenet_tpu.config import ModelConfig as JModelConfig
from multiposenet_tpu.engine.inference import make_prn_pipeline as j_prn_pipeline
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet
from multiposenet_tpu.ops import boxes as jboxes
from multiposenet_tpu.ops.anchors import anchors_for_shape as j_anchors
from multiposenet_tpu.ops.gaussian import blur_matrix as j_blur_matrix
from multiposenet_tpu.ops.grouping import assign_peaks as j_assign_peaks
from multiposenet_tpu.ops.nms import batched_topk_nms as j_batched_topk_nms
from multiposenet_tpu.ops.pallas_nms import pallas_nms_suppress
from multiposenet_tpu.ops.peaks import (
    _upsample_matrix as j_upsample_matrix,
    find_peaks_refined_batched as j_find_peaks,
)

from multiposenet_tpu_torch.config import Config, ModelConfig
from multiposenet_tpu_torch.engine.inference import make_prn_pipeline
from multiposenet_tpu_torch.models.posenet import PoseNet
from multiposenet_tpu_torch.ops import boxes as tboxes
from multiposenet_tpu_torch.ops.anchors import anchors_for_shape
from multiposenet_tpu_torch.ops.gaussian import blur_matrix
from multiposenet_tpu_torch.ops.grouping import assign_peaks
from multiposenet_tpu_torch.ops.nms import (
    batched_topk_nms,
    nms_fixed,
    nms_suppress,
    nms_suppress_plain,
)
from multiposenet_tpu_torch.ops.peaks import (
    _upsample_matrix,
    find_peaks_refined_batched,
)
from multiposenet_tpu_torch.weights import state_dict_from_flax


def T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- anchors/boxes

@pytest.mark.parametrize("hw", [(64, 64), (100, 100), (480, 480), (96, 160)])
def test_anchors_equal_jax_exactly(hw):
    got = anchors_for_shape(hw)
    want = j_anchors(hw, JAnchorConfig())
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if hw == (480, 480):
        assert got.shape == (43245, 4)


def test_exp_log_take_float32_through_float64():
    """``exp_log.exp``/``log`` of a float32 tensor are the float64
    functions rounded to float32, bit for bit, with their gradient; float64
    goes straight to ``torch.exp``/``torch.log``."""
    from multiposenet_tpu_torch.ops import exp_log

    x = torch.linspace(-20.0, 20.0, 100_001)
    assert torch.equal(exp_log.exp(x), torch.exp(x.double()).float())
    pos = x.abs() + 1e-3
    assert torch.equal(exp_log.log(pos), torch.log(pos.double()).float())
    assert exp_log.exp(x).dtype == exp_log.log(pos).dtype == torch.float32
    xd = x.double()
    assert torch.equal(exp_log.exp(xd), torch.exp(xd))
    g = pos[:5].clone().requires_grad_(True)
    exp_log.log(g).sum().backward()
    torch.testing.assert_close(g.grad, 1.0 / pos[:5], rtol=1.2e-7, atol=0.0)


def test_decode_and_clip_boxes_match_jax():
    rng = np.random.RandomState(0)
    anchors = anchors_for_shape((100, 100))
    # deltas large enough that boxes cross the image edge (x2 < x1 after clip)
    deltas = (rng.randn(3, anchors.shape[0], 4) * 3.0).astype(np.float32)
    jdec = jboxes.decode_boxes(jnp.asarray(anchors)[None], jnp.asarray(deltas))
    tdec = tboxes.decode_boxes(T(anchors)[None], T(deltas))
    # XLA's and PyTorch's exp may differ by an ulp, and x1 = ctr - w/2
    # cancels: bound the error by 1e-6 of each box's coordinate scale
    err = np.abs(tdec.numpy() - _np(jdec))
    scale = np.abs(_np(jdec)).max(axis=-1, keepdims=True)
    assert (err <= 1e-6 * np.maximum(scale, 1.0)).all(), err.max()
    jclip = jboxes.clip_boxes(jdec, 100, 100)
    tclip = tboxes.clip_boxes(T(_np(jdec)), 100, 100)
    np.testing.assert_array_equal(tclip.numpy(), _np(jclip))
    assert (tclip[..., 2] < tclip[..., 0]).any()     # degenerate boxes occur


# ---------------------------------------------------------------------- NMS

def _fuzz_boxes(rng, n, lo=20, hi=300):
    ctr = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(10, 100, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


# box a in word 0, b in word 1, c in the last 32-box word: IoU(a, b) and
# IoU(b, c) are 280 / 520 > 0.5, IoU(a, c) is 160 / 640.  Far from the fuzz.
_CHAIN = np.array([[1000, 1000, 1019, 1019], [1006, 1000, 1025, 1019],
                   [1012, 1000, 1031, 1019]], np.float32)


def _chain_slots(k):
    # at K = 40 there are two words only: c (slot 38) shares b's word 1
    return 3, 35, k - 2


def _suppress_case(kind, rng, k=40):
    boxes = _fuzz_boxes(rng, k, 20, 120)
    valid = rng.rand(k) < 0.85
    if kind.startswith("chain_across_words"):
        # a suppresses b; b is dead, so c survives.  In the twin a is invalid:
        # b lives and suppresses c.
        slots = list(_chain_slots(k))
        boxes[slots] = _CHAIN
        valid[slots] = [kind == "chain_across_words", True, True]
    if kind == "duplicates":
        boxes[1::3] = boxes[0::3][: len(boxes[1::3])]
    elif kind == "exact_threshold":
        # IoU (+1px) exactly 0.5: 10x10 and 10x5 boxes sharing a corner
        for i in range(0, k - 1, 2):
            x, y = rng.randint(0, 200, 2).astype(np.float32)
            boxes[i] = [x, y, x + 9, y + 9]
            boxes[i + 1] = [x, y, x + 9, y + 4]
    elif kind == "degenerate":
        # x2 < x1 or zero +1px area (clip_boxes leaves such boxes)
        boxes[::4, 2] = boxes[::4, 0] - rng.uniform(0, 5, len(boxes[::4]))
        boxes[1::4, 2:] = boxes[1::4, :2] - 1.0
    elif kind == "all_invalid":
        valid[:] = False
    return boxes, valid


_SUPPRESS_KINDS = ["fuzz", "duplicates", "exact_threshold", "degenerate",
                   "all_invalid", "chain_across_words",
                   "chain_across_words_a_invalid"]


# K = 100 is the serving K; 200 spans 7 words of 32 (Pallas pads it to 256).
# The K = 40 cases keep their plain kind as id, and their seed.
@pytest.mark.parametrize("kind,k", [
    pytest.param(kind, k, id=kind if k == 40 else f"{kind}-k{k}")
    for k in (40, 100, 200) for kind in _SUPPRESS_KINDS])
def test_nms_suppress_plain_equals_pallas_kernel(kind, k):
    rng = np.random.RandomState(sum(map(ord, kind)) + (k if k != 40 else 0))
    boxes, valid = _suppress_case(kind, rng, k)
    want = _np(pallas_nms_suppress(jnp.asarray(boxes), jnp.asarray(valid),
                                   0.5, interpret=True))
    got = nms_suppress_plain(T(boxes)[None], T(valid)[None], 0.5)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU dispatch of the wrapper is the plain twin
    np.testing.assert_array_equal(
        nms_suppress(T(boxes)[None], T(valid)[None], 0.5)[0].numpy(), want)
    if kind == "exact_threshold":
        assert got[1::2].sum() > 0   # IoU == thresh does not suppress
    if kind.startswith("chain_across_words"):
        a, b, c = _chain_slots(k)
        alive = kind == "chain_across_words"
        assert [bool(want[a]), bool(want[b]), bool(want[c])] == [
            alive, not alive, alive]


def _nms_case(kind, rng):
    n = 80
    boxes = _fuzz_boxes(rng, n)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    max_out, score_thresh = 32, 0.05
    if kind == "below_threshold":
        scores *= 0.001
    elif kind == "padding":
        boxes, scores = boxes[:10], scores[:10]
    elif kind == "tied_scores":
        scores = (np.round(scores * 4) / 4).astype(np.float32)
        boxes[5:15] = boxes[0]
    elif kind == "degenerate":
        boxes[::3, 2] = boxes[::3, 0] - 3.0
    return boxes, scores, max_out, score_thresh


@pytest.mark.parametrize("kind", ["fuzz", "below_threshold", "padding",
                                  "tied_scores", "degenerate"])
def test_batched_topk_nms_equals_jax(kind):
    rng = np.random.RandomState(sum(map(ord, kind)) + 1)
    cases = [_nms_case(kind, rng) for _ in range(3)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    max_out, score_thresh = cases[0][2:]
    want = j_batched_topk_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                              max_out, score_thresh)
    got = batched_topk_nms(T(boxes), T(scores), 0.5, max_out, score_thresh)
    for name in ("keep", "indices", "scores", "boxes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(want, name)), err_msg=name)
    assert got.keep.shape == (3, max_out)
    assert got.indices.dtype == torch.int32
    if kind == "below_threshold":
        assert not got.keep.any()
    one = nms_fixed(T(boxes[0]), T(scores[0]), 0.5, max_out, score_thresh)
    np.testing.assert_array_equal(one.keep.numpy(), got.keep[0].numpy())


# -------------------------------------------------------------------- peaks

def _plateau_heatmaps(rng, b=3, h=16, w=20, j=18):
    # quantised values: plateaus, equal maxima and equal scores across cells
    hm = np.round(rng.rand(b, h, w, j) * 4) / 4 * 0.6
    hm[0, 3:6, 4:7, 2] = 0.9                      # a 3x3 plateau
    hm[1, :, :, 5] = 0.05                         # a joint without peaks
    return hm.astype(np.float32)


@pytest.mark.parametrize("refine", [True, False])
def test_find_peaks_equals_jax(refine):
    hm = _plateau_heatmaps(np.random.RandomState(11 + refine))
    kw = dict(thre1=0.1, max_peaks=8, upsamp_factor=4, win_size=2,
              refine=refine)
    want = j_find_peaks(jnp.asarray(hm), **kw)
    got = find_peaks_refined_batched(T(hm), **kw)
    np.testing.assert_array_equal(got.coords.numpy(), _np(want.coords))
    np.testing.assert_array_equal(got.valid.numpy(), _np(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), _np(want.scores), atol=1e-6)
    assert got.valid.any() and not got.valid.all()


def test_constant_matrices_equal_jax():
    np.testing.assert_array_equal(_upsample_matrix(5, 4), j_upsample_matrix(5, 4))
    for n in (56, 36):
        np.testing.assert_array_equal(blur_matrix(n, 1.0, "nearest"),
                                      j_blur_matrix(n, 1.0, "nearest"))


# ---------------------------------------------------------- PRN and grouping

J, P, B = 17, 8, 6


@pytest.fixture(scope="module")
def prn_models():
    """JAX PoseNet with only its PRN initialised, and the port's PRN loaded
    with the same weights."""
    jcfg = JConfig(model=JModelConfig(backbone="resnet50"))
    jm = JPoseNet(jcfg.model)
    grid = jnp.zeros((1, 56, 36, 17))
    params = jax.device_get(
        jm.init(jax.random.PRNGKey(1), grid, method=JPoseNet.prn_forward))
    sd = state_dict_from_flax({"params": params["params"], "batch_stats": {}})
    tm = PoseNet(ModelConfig(backbone="resnet50"))
    tm.prn.load_state_dict({k[len("prn."):]: v for k, v in sd.items()},
                           strict=True)
    return jm, params, tm


def _prn_inputs(rng, crowded: bool):
    peak_xy = rng.uniform(0, 96, (J, P, 2)).astype(np.float32)
    if crowded:
        # clusters of near-identical peaks land in one PRN cell
        peak_xy[:, 1::2] = peak_xy[:, 0::2] + rng.uniform(0, 0.3, (J, P // 2, 2))
    peak_valid = rng.rand(J, P) < 0.7
    peak_score = np.where(peak_valid, 1.0, -1.0).astype(np.float32)
    boxes = np.zeros((B, 4), np.float32)
    boxes[:, :2] = rng.uniform(0, 50, (B, 2))
    boxes[:, 2:] = rng.uniform(16, 60, (B, 2))
    box_valid = np.arange(B) < B - 1
    boxes[~box_valid] = 0.0                         # padding slot, as the e2e
    return peak_xy, peak_score, peak_valid, boxes, box_valid


@pytest.mark.parametrize("crowded", [False, True])
def test_prn_stage_and_grouping_equal_jax(prn_models, crowded):
    jm, params, tm = prn_models
    cfg = Config(model=ModelConfig(backbone="resnet50"))
    jrun = j_prn_pipeline(jm, JConfig(model=JModelConfig(backbone="resnet50")))
    trun = make_prn_pipeline(tm, cfg)
    rng = np.random.RandomState(5 + crowded)
    images = [_prn_inputs(rng, crowded) for _ in range(2)]

    want = [jax.device_get(jrun(params, *map(jnp.asarray, a))) for a in images]
    got = trun(*(T(np.stack([a[i] for a in images])) for i in range(5)))
    table, inside, prn_out, x0, y0 = (t.numpy() for t in got)
    for n, (wt, wi, wp, wx, wy) in enumerate(want):
        np.testing.assert_array_equal(inside[n], wi)
        np.testing.assert_array_equal(x0[n], wx)
        np.testing.assert_array_equal(y0[n], wy)
        # the PRN MLP sums 34,272-long f32 dot products in another order
        # than XLA, and the softmax normaliser passes its relative error on
        # to every entry: within 5e-5 relative (values are <= 1, so also
        # well inside 1e-5 absolute)
        np.testing.assert_allclose(prn_out[n], wp, rtol=5e-5, atol=1e-9)
        np.testing.assert_allclose(table[n], wt, rtol=5e-5, atol=1e-9)
    assert inside.any()

    # grouping on identical inputs: every slot decision equals JAX
    for n, (wt, wi, wp, wx, wy) in enumerate(want):
        boxes = images[n][3]
        ja = j_assign_peaks(*map(jnp.asarray, (wt, wi, wx, wy, wp, boxes)))
        ta = assign_peaks(*map(T, (wt, wi, wx, wy, wp, boxes)))
        np.testing.assert_array_equal(ta.chosen.numpy(), _np(ja.chosen))
        np.testing.assert_array_equal(ta.active.numpy(), _np(ja.active))
        np.testing.assert_array_equal(ta.active_any.numpy(), _np(ja.active_any))
        np.testing.assert_allclose(ta.fallback_xy.numpy(), _np(ja.fallback_xy),
                                   rtol=1e-6)
        # and the port's own table yields the same choices
        tb = assign_peaks(*(T(a) for a in (table[n], inside[n], x0[n], y0[n],
                                           prn_out[n], boxes)))
        np.testing.assert_array_equal(tb.chosen.numpy(), _np(ja.chosen))
        assert (tb.chosen.numpy() >= 0).any()


def test_assign_peaks_batched_equals_per_image():
    rng = np.random.RandomState(3)
    n = 3
    table = np.round(rng.rand(n, B, J, P) * 4).astype(np.float32) / 4
    inside = rng.rand(n, B, J, P) < 0.5
    cx = rng.randint(0, 3, (n, B, J, P)).astype(np.int32)
    cy = rng.randint(0, 3, (n, B, J, P)).astype(np.int32)
    prn = rng.rand(n, B, 56, 36, J).astype(np.float32)
    boxes = rng.uniform(10, 50, (n, B, 4)).astype(np.float32)
    batched = assign_peaks(*map(T, (table, inside, cx, cy, prn, boxes)))
    for i in range(n):
        ja = j_assign_peaks(*map(jnp.asarray, (table[i], inside[i], cx[i],
                                               cy[i], prn[i], boxes[i])))
        for name in ("chosen", "active", "active_any"):
            np.testing.assert_array_equal(getattr(batched, name)[i].numpy(),
                                          _np(getattr(ja, name)), err_msg=name)
