"""multiposenet_tpu_torch training ops against the JAX package's, on the CPU:
heatmap targets, the gaussian blur, box encoding and IoU, the three losses
(values and input gradients: autograd against ``jax.grad``), the inf-norm
gradient clip, and the PRN dataset."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.ops import boxes as jboxes
from multiposenet_tpu.ops import gaussian as jgaussian
from multiposenet_tpu.ops import heatmap as jheatmap
from multiposenet_tpu.ops import losses as jlosses
from multiposenet_tpu.ops.anchors import anchors_for_shape as j_anchors_for_shape

from multiposenet_tpu_torch.ops import boxes, gaussian, heatmap, losses
from multiposenet_tpu_torch.ops.anchors import anchors_for_shape


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- heatmaps

def edge_joints(rng, b=3, p=4, j=18, size=64):
    """Joints inside, on and beyond the image edges, v in {0, 1, 2}, and a
    padded (v = 2) person slot."""
    joints = np.zeros((b, p, j, 3), np.float32)
    joints[..., :2] = rng.uniform(-10, size + 10, (b, p, j, 2))
    joints[..., 2] = rng.randint(0, 3, (b, p, j))
    joints[:, 0, 0, :2] = [0.0, 0.0]
    joints[:, 0, 1, :2] = [size - 1, size - 1]
    joints[:, 0, :2, 2] = 1.0
    joints[:, -1] = (1.0, 1.0, 2.0)        # a padded person
    return joints


def test_make_heatmaps_equals_jax():
    """Batched targets equal JAX's vmapped ones within 2 ulps of 1.0
    (XLA's and PyTorch's exp differ by an ulp; measured 6e-8), and the
    ln(100) cut-off leaves the same pixels at exactly zero."""
    rng = np.random.RandomState(0)
    joints = edge_joints(rng)
    gh, gw = 16, 20
    want = np.asarray(jax.vmap(
        lambda jt: jheatmap.make_heatmaps(jt, gh, gw, 4, 7.0))(jnp.asarray(joints)))
    got = heatmap.make_heatmaps(_t(joints), gh, gw, 4, 7.0).numpy()
    assert got.shape == (3, gh, gw, 18)
    assert np.abs(got - want).max() <= 2.4e-7
    np.testing.assert_array_equal(got == 0, want == 0)
    assert 0 < (want == 0).mean() < 1          # the cut-off is reached
    assert (want == 1).any()                   # overlapping people clip at 1
    for i in range(3):
        np.testing.assert_array_equal(
            heatmap.make_heatmaps_np(joints[i], gh, gw, 4, 7.0),
            jheatmap.make_heatmaps_np(joints[i], gh, gw, 4, 7.0))


# ---------------------------------------------------------------- blur

@pytest.mark.parametrize("sigma,mode", [(1.0, "nearest"), (2.0, "constant"),
                                        (1.5, "nearest")])
def test_gaussian_blur_equals_jax(sigma, mode):
    """Per-axis edge or zero padding then a depthwise 1-D convolution:
    within 3.6e-7 (3 ulps of 1.0) of JAX's on one-hot marks and on noise in
    [0, 1) (measured 3e-8 and 1.8e-7: the two sum the taps in other
    orders), and as close to the dense blur operators' result."""
    rng = np.random.RandomState(1)
    marks = (rng.rand(2, 56, 36, 17) > 0.98).astype(np.float32)
    marks[0, 0, 0] = marks[0, -1, -1] = 1.0          # marks on the corners
    noise = rng.rand(3, 2, 11, 9, 5).astype(np.float32)
    for x in (marks, noise):
        want = np.asarray(jgaussian.gaussian_blur(jnp.asarray(x), sigma, mode))
        got = gaussian.gaussian_blur(_t(x), sigma, mode).numpy()
        assert got.shape == x.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= 3.6e-7
    h, w = marks.shape[1:3]
    by = _t(np.array(gaussian.blur_matrix(h, sigma, mode)))
    bx = _t(np.array(gaussian.blur_matrix(w, sigma, mode)))
    dense = torch.einsum("xw,bywj->byxj", bx,
                         torch.einsum("yh,bhxj->byxj", by, _t(marks)))
    got = gaussian.gaussian_blur(_t(marks), sigma, mode)
    assert float((dense - got).abs().max()) <= 3.6e-7


# ---------------------------------------------------------------- boxes

def test_encode_boxes_and_box_iou_equal_jax():
    rng = np.random.RandomState(2)
    anchors = np.array(anchors_for_shape((64, 64)))
    np.testing.assert_array_equal(anchors, np.asarray(j_anchors_for_shape((64, 64))))
    xy = rng.uniform(-8, 60, (5, 2)).astype(np.float32)
    wh = rng.uniform(0.2, 40, (5, 2)).astype(np.float32)     # some under 1 px
    gt = np.concatenate([xy, xy + wh], 1)
    a = anchors[rng.randint(0, len(anchors), 5)]
    np.testing.assert_allclose(boxes.encode_boxes(_t(a), _t(gt)).numpy(),
                               np.asarray(jboxes.encode_boxes(a, gt)),
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(jboxes.box_iou(anchors, gt))
    got = boxes.box_iou(_t(anchors), _t(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (want > 0.3).any() and (want == 0).any()
    batched = boxes.box_iou(_t(anchors), _t(np.stack([gt, gt[::-1]]))).numpy()
    np.testing.assert_array_equal(batched[0], got)
    np.testing.assert_array_equal(batched[1], got[:, ::-1])


# ---------------------------------------------------------------- losses

def _grads_close(got, want, rtol):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got.numpy() - want).max() <= rtol * scale


def test_keypoint_loss_and_grads_equal_jax():
    rng = np.random.RandomState(3)
    saved = [rng.randn(2, 12, 10, 19 if i < 4 else 18).astype(np.float32) * 0.1
             for i in range(5)]
    heat = rng.rand(2, 12, 10, 18).astype(np.float32)
    mask = (rng.rand(2, 12, 10, 18) > 0.3).astype(np.float32)

    def jf(s):
        return jlosses.keypoint_loss(s, jnp.asarray(heat), jnp.asarray(mask), 18)
    (jl, jlogs), jg = jax.value_and_grad(jf, has_aux=True)(
        [jnp.asarray(s) for s in saved])
    ts = [_t(s).requires_grad_() for s in saved]
    tl, tlogs = losses.keypoint_loss(ts, _t(heat), _t(mask), 18)
    tl.backward()
    # the means sum in other orders: measured 1.03e-6
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=1e-5)
    for t, g in zip(ts, jg):
        _grads_close(t.grad, g, 1e-6)
    assert not ts[0].grad[..., 18].any()       # the 19th channel is unused


def detection_case(rng, size=64):
    """Anchors of a 64 px image and GT for 4 images: several boxes, padded
    rows between valid ones, one box whose best anchors fall in the ignore
    band [0.4, 0.5), and an image with no GT at all."""
    anchors = np.array(anchors_for_shape((size, size)))
    ann = np.full((4, 5, 5), -1.0, np.float32)
    ann[0, 0] = [4, 6, 36, 44, 0]
    ann[0, 2] = [20, 16, 60, 62, 0]          # row 1 is padding
    inside = np.flatnonzero((anchors.min(1) >= 0) & (anchors.max(1) <= size))
    ann[1, 0, :4] = anchors[inside[len(inside) // 2]] + 0.5    # IoU near 1
    ann[1, 0, 4] = 0
    ann[2, 0] = [1, 1, 63, 63, 0]
    cls = rng.uniform(0.0, 1.0, (4, len(anchors), 1)).astype(np.float32)
    cls[0, :5] = [[0.0], [1.0], [1e-5], [0.99999], [0.5]]   # inside the clip
    reg = rng.randn(4, len(anchors), 4).astype(np.float32) * 0.3
    return anchors, ann, cls, reg


def test_focal_loss_single_semantics_equal_jax():
    """Per image: positives, negatives and the ignore band, padding never
    assigned, an image without GT giving zero, clamp(num_pos, 1)."""
    rng = np.random.RandomState(4)
    anchors, ann, cls, reg = detection_case(rng)
    got_c, got_r = losses.focal_loss_single(_t(cls), _t(reg), _t(anchors), _t(ann))
    for i in range(4):
        jc, jr = jlosses.focal_loss_single(cls[i], reg[i], anchors, ann[i])
        np.testing.assert_allclose(float(got_c[i]), float(jc), rtol=1e-5)
        np.testing.assert_allclose(float(got_r[i]), float(jr), rtol=1e-5, atol=1e-9)
    assert float(got_c[3]) == 0.0 and float(got_r[3]) == 0.0   # no GT
    iou = np.asarray(jboxes.box_iou(anchors, ann[2, :1, :4]))[:, 0]
    assert ((iou >= 0.4) & (iou < 0.5)).any()                  # ignore band
    best = np.asarray(jboxes.box_iou(anchors, ann[1, :1, :4])).max()
    assert best >= 0.5                                         # positives exist


def test_detection_loss_and_grads_equal_jax():
    rng = np.random.RandomState(5)
    anchors, ann, cls, reg = detection_case(rng)

    def jf(c, r):
        return jlosses.detection_loss(c, r, jnp.asarray(anchors), jnp.asarray(ann))
    (jl, jlogs), (gc, gr) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    tc, tr = _t(cls).requires_grad_(), _t(reg).requires_grad_()
    tl, tlogs = losses.detection_loss(tc, tr, _t(anchors), _t(ann))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=1e-5)
    _grads_close(tc.grad, gc, 1e-5)
    _grads_close(tr.grad, gr, 1e-5)
    assert not tc.grad[3].any() and not tr.grad[3].any()       # no GT, no grad


def test_prn_loss_and_grads_equal_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 56 * 36 * 17).astype(np.float32)
    out = np.asarray(jax.nn.softmax(logits, axis=1)).reshape(2, 56, 36, 17)
    label = (rng.rand(2, 56, 36, 17) * 0.05).astype(np.float32)
    (jl, _), jg = jax.value_and_grad(jlosses.prn_loss, has_aux=True)(
        jnp.asarray(out), jnp.asarray(label))
    to = _t(out).requires_grad_()
    tl, tlogs = losses.prn_loss(to, _t(label))
    tl.backward()
    # XLA's float32 reduction of the BCE differs by up to ~5e-5 (it is that
    # far off float64 on the PRN's outputs; tests/test_torch_port_train_steps)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    assert set(tlogs) == {"prn_loss"}
    _grads_close(to.grad, jg, 1e-5)


@pytest.mark.parametrize("max_norm", [1e-3, 0.5, 100.0])   # binds, binds, not
def test_inf_norm_clip_equals_jax(max_norm):
    """``clip_grad_norm_(norm_type=inf)`` scales by the JAX clip's
    coefficient min(max_norm / (max |g| + 1e-6), 1)."""
    from multiposenet_tpu.engine.train_steps import clip_by_global_inf_norm

    rng = np.random.RandomState(7)
    grads = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = clip_by_global_inf_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = _t(g).clone()
    torch.nn.utils.clip_grad_norm_(params, max_norm, norm_type=math.inf)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)
    top = max(float(np.abs(g).max()) for g in grads)
    if max_norm < top:          # binds
        assert max(float(p.grad.abs().max()) for p in params) < max_norm
    else:
        for p, g in zip(params, grads):
            np.testing.assert_array_equal(p.grad.numpy(), g)


# ---------------------------------------------------------------- PRN dataset

def test_prn_dataset_equals_jax(tmp_path):
    """Item for item on a synthetic COCO GT: marks of the own person and of
    every keypoint near the box, invisible keypoints skipped, crowds and
    people with too few keypoints left out, the most complete first."""
    from multiposenet_tpu.config import Config as JConfig
    from multiposenet_tpu.data.coco_json import COCOIndex as JCOCOIndex
    from multiposenet_tpu.data.datasets import OUR_ORDER_17 as J_ORDER
    from multiposenet_tpu.data.datasets import PRNDataset as JPRNDataset

    from multiposenet_tpu_torch.config import Config
    from multiposenet_tpu_torch.data.coco_json import COCOIndex
    from multiposenet_tpu_torch.data.datasets import OUR_ORDER_17, PRNDataset
    from torch_port_helpers import synthetic_coco

    _, gt = synthetic_coco(str(tmp_path), [[(60, 60), (75, 70), (150, 90)],
                                           [(50, 100)], [(100, 40), (112, 52)]])
    anns = gt["annotations"]
    anns[1]["keypoints"][3 * 4 + 2] = 0          # an invisible keypoint
    anns[1]["num_keypoints"] = 16
    anns[2]["num_keypoints"] = 3                 # too few: left out
    anns[4]["iscrowd"] = 1                       # a crowd: left out
    jds = JPRNDataset(JCOCOIndex(dataset=gt), JConfig())
    ds = PRNDataset(COCOIndex(dataset=gt), Config())
    assert OUR_ORDER_17 == J_ORDER
    assert len(ds) == len(jds) == 4
    n_other = 0
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        n_other += int(got["weights_marks"].sum() > got["label_marks"].sum())
    assert n_other >= 2                          # neighbours marked in weights
