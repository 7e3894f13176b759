"""The traffic generator repeats for a seed, gives every seed the same set
of sizes, and keeps to its mix's parameters."""

import collections

import numpy as np
import pytest
import torch

from mpn_bench import harness, traffic

BIG_SEED = 2 ** 31 + 12345


def spec(name):
    return harness.load_json(harness.BENCH_DIR / "traffic" / f"{name}.json")


def small_frames():
    s = spec("serve-stream")
    s.update(pool_frames=8, sizes_hw=[[6, 8], [8, 6], [8, 8], [4, 8]])
    return s


def small_batches():
    s = spec("train-det")
    s.update(pool_batches=3, batch=4, side_min=8, side_max=48)
    return s


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_frame_pool_repeats_for_a_seed(seed):
    a = traffic.frame_pool(small_frames(), seed, "cpu")
    b = traffic.frame_pool(small_frames(), seed, "cpu")
    assert len(a) == 8
    for x, y in zip(a, b):
        assert x.dtype == np.uint8 and x.shape == y.shape
        assert np.array_equal(x, y)


def test_frame_pools_share_sizes_not_order():
    sizes = lambda pool: [f.shape for f in pool]  # noqa: E731
    a, b = (sizes(traffic.frame_pool(small_frames(), s, "cpu")) for s in (1, 2))
    assert collections.Counter(a) == collections.Counter(b)
    assert collections.Counter(a) == collections.Counter(
        {(6, 8, 3): 2, (8, 6, 3): 2, (8, 8, 3): 2, (4, 8, 3): 2})
    pools = [sizes(traffic.frame_pool(small_frames(), s, "cpu")) for s in range(6)]
    assert len({tuple(p) for p in pools}) > 1


def test_frame_pool_refuses_an_uneven_share():
    s = small_frames()
    s["pool_frames"] = 7
    with pytest.raises(ValueError):
        traffic.frame_pool(s, 0, "cpu")


@pytest.mark.parametrize("seed", [3, BIG_SEED])
def test_detection_pool_repeats_for_a_seed(seed):
    a = traffic.detection_pool(small_batches(), seed, 64, "cpu")
    b = traffic.detection_pool(small_batches(), seed, 64, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x["image"], y["image"]) and torch.equal(x["boxes"], y["boxes"])
    assert a[0]["image"].shape == (4, 64, 64, 3) and a[0]["image"].dtype == torch.uint8
    assert not torch.equal(a[0]["image"], a[1]["image"])


def test_detection_boxes_must_fit_the_image():
    with pytest.raises(ValueError):
        traffic.detection_boxes(spec("train-det"), 0, 64)


def test_detection_boxes_keep_to_the_mix():
    s = spec("train-det")
    s.update(pool_batches=20, batch=25)
    boxes = traffic.detection_boxes(s, 11, 608)
    assert boxes.shape == (20, 25, s["pad_boxes"], 5)
    real = boxes[..., 4] != -1
    counts = real.sum(-1)
    assert counts.min() >= 1 and counts.max() <= s["boxes_max"]
    assert 3.0 < counts.mean() < 5.0          # geometric, mean 4, cut at 20
    b = boxes[real]
    w, h = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
    assert w.min() >= s["side_min"] - 1e-3 and w.max() <= s["side_max"] + 1e-3
    assert h.min() >= s["side_min"] - 1e-3 and h.max() <= s["side_max"] + 1e-3
    assert b[:, 0].min() >= 0 and b[:, 2].max() <= 608 + 1e-3
    assert (boxes[~real] == -1).all()
    assert np.array_equal(boxes, traffic.detection_boxes(s, 11, 608))
