"""The roofline count of K1 and the FLOP counts of the frozen reference, at
small shapes, against counts made by hand."""

import copy
import hashlib

import pytest
import torch

from mpn_bench import harness
from mpn_bench.reference import flops
from mpn_bench.reference import model as ref_model
from mpn_bench.tests import tiny


@pytest.mark.parametrize("b,k", [(1, 1), (2, 3), (64, 100)])
def test_k1_work_by_hand(b, k):
    ops, nbytes = harness.load_roofline("k1").work(b, k)
    assert ops == b * (k * (k - 1) // 2 * 15 + k * 5)
    assert nbytes == b * k * (16 + 1 + 1)


def test_k1_roofline_reader_at_its_shapes():
    """64 x 100 boxes: 4,950 pairs an image; at the data sheet's float32
    rate the operations bound a launch at 7.14e-8 s."""
    ops, nbytes = harness.load_roofline("k1").work(64, 100)
    peaks = harness.peaks_for("NVIDIA H100 80GB HBM3")
    least = max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])
    assert ops / peaks["fp32_flops"] > nbytes / peaks["hbm_bytes_per_s"]
    assert least == pytest.approx(7.14e-8, rel=1e-2)


def _by_hand(cfg, run):
    """2 x multiply-adds of every convolution and linear layer that ``run``
    calls through the reference's ``conv2d``/``linear``."""
    total = []
    conv, linear = ref_model.conv2d, ref_model.linear

    def counted_conv(x, w, b, stride=1, padding=0, quant=None):
        out = conv(x, w, b, stride, padding, quant)
        total.append(2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return out

    def counted_linear(mod, x, quant=None):
        out = linear(mod, x, quant)
        total.append(2 * out.numel() * mod.weight.shape[1])
        return out

    ref_model.conv2d, ref_model.linear = counted_conv, counted_linear
    try:
        run()
    finally:
        ref_model.conv2d, ref_model.linear = conv, linear
    return sum(total)


def test_serve_flops_by_hand():
    _, cfg, _ = tiny.cell("serve")
    s = cfg["serve"]
    m = ref_model.build(cfg, "meta").eval()
    x = torch.empty(1, s["inp_size"], s["inp_size"], 3, device="meta")
    g = torch.empty(s["max_people"], m.prn.height, m.prn.width, 17, device="meta")
    hand = _by_hand(cfg, lambda: (m.full_forward(x), m.prn.run(g)))
    assert flops.serve_flops_per_image(cfg) == hand


def test_detection_step_flops_scale_with_the_batch():
    _, cfg, _ = tiny.cell("train")
    one = flops.detection_step_flops(cfg, 1)
    assert flops.detection_step_flops(cfg, 3) == 3 * one
    m = ref_model.build(cfg, "meta")
    size = cfg["train_detection"]["inp_size"]
    fwd = _by_hand(cfg, lambda: m.detection_forward(
        torch.empty(1, size, size, 3, device="meta")))
    # the backward of the trainable part costs at most twice its forward
    assert fwd < one < 3 * fwd


def test_backbones_differ_only_in_the_trunk():
    _, cfg, _ = tiny.cell("serve")
    deeper = copy.deepcopy(cfg)
    deeper["backbone"] = "resnet101"
    assert flops.serve_flops_per_image(deeper) > flops.serve_flops_per_image(cfg)


# the frozen reference's state_dict keys, in order, and its FLOP counts, as
# they stood before the trunk moved into reference/trunks/: the seeded
# weights draw one flat normal in this key order, and mfu reads these counts
REFERENCE_PINS = {
    "mpn-r50": (402, "92b7f2836013e4fe0e20cb35e57517a9c4d7ebf2ff106b7708bb6125f5a76daf",
                7_932_235_443_200, 171_436_102_144),
    "mpn-r101": (708, "1721e001eeb54368658a0c249faf947e26b4a3df913f5701d378ffa52a601dd6",
                 9_299_696_512_000, 205_527_929_344),
}


@pytest.mark.parametrize("config", sorted(REFERENCE_PINS))
def test_the_reference_keeps_its_keys_and_counts(config):
    files = {c["name"]: c["file"] for c in harness.load_bench()["configs"]}
    cfg = harness.load_json(harness.ROOT / files[config])
    keys = list(ref_model.build(cfg, "meta").state_dict())
    n, digest, det_flops_25, serve_flops = REFERENCE_PINS[config]
    assert len(keys) == n
    assert hashlib.sha256("\n".join(keys).encode()).hexdigest() == digest
    assert flops.detection_step_flops(cfg, 25) == det_flops_25
    assert flops.serve_flops_per_image(cfg) == serve_flops
