"""The frozen trunk's epilogue (ops/trunk_epilogue.py) on the CPU: its plain
twin against the op sequence the trunk ran before (``F.batch_norm``, ``+``,
``F.relu``) bit for bit, the operator ``mpn::trunk_epilogue`` and its shape
function, how often the trunk dispatches it on each path (on the GPU each
dispatch is one launch of csrc/trunk_epilogue.cu), and ``torch.export``
through it.  The kernel itself runs on the card only (chip_smoke.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multiposenet_tpu_torch.config import Config, DataConfig, ModelConfig
from multiposenet_tpu_torch.engine import train_steps as tts
from multiposenet_tpu_torch.models import fpn
from multiposenet_tpu_torch.models.posenet import PoseNet, build_trainable_posenet
from multiposenet_tpu_torch.ops import trunk_epilogue as te

SIZE = 64
B = 2


def _bn(c: int, rng: np.random.RandomState, dtype) -> fpn.BatchNorm:
    bn = fpn.BatchNorm(c).to(dtype)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.randn(c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.05, 3.0, c)))
        bn.weight.copy_(torch.from_numpy(rng.randn(c)))
        bn.bias.copy_(torch.from_numpy(rng.randn(c)))
    return bn.requires_grad_(False)


def _layer_inputs(case: str, dtype, channels_last: bool, seed: int = 0):
    """(x, bn, residual, down) of one trunk layer's end: ``inner`` (the stem
    or a block's first two convs), ``identity`` (a block's end with the
    block's input as residual) or ``downsample`` (a block's end with the
    downsample conv's raw output and its BatchNorm)."""
    rng = np.random.RandomState(seed)
    c = 64 if case == "inner" else 256
    make = lambda: torch.from_numpy(rng.randn(3, c, 7, 9) * 3).to(dtype)  # noqa: E731
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = make().contiguous(memory_format=fmt)
    bn = _bn(c, rng, dtype)
    residual = make().contiguous(memory_format=fmt) if case == "identity" else None
    down = ((make().contiguous(memory_format=fmt), _bn(c, rng, dtype))
            if case == "downsample" else None)
    return x, bn, residual, down


def _old_sequence(x, bn, residual, down):
    """The trunk's op sequence before the epilogue (``Bottleneck.forward``,
    the stem)."""
    out = bn(x, False)
    if down is not None:
        residual = down[1](down[0], False)
    return F.relu(out if residual is None else out + residual)


def _op_args(x, bn, residual, down):
    args = [x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
            residual]
    if down is not None:
        d = down[1]
        args += [down[0], d.running_mean, d.running_var, d.weight, d.bias, d.eps]
    return args


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["inner", "identity", "downsample"])
def test_plain_twin_is_the_old_op_sequence(case, dtype, channels_last):
    x, bn, residual, down = _layer_inputs(case, dtype, channels_last)
    want = _old_sequence(x, bn, residual, down)
    args = _op_args(x, bn, residual, down)
    got = te.trunk_epilogue_plain(*args)
    assert got.dtype == dtype and torch.equal(got, want)
    # the operator on the CPU, and the trunk's helper (which calls the
    # operator in float32 and the modules in float64)
    assert torch.equal(torch.ops.mpn.trunk_epilogue(*args), want)
    assert torch.equal(fpn.trunk_epilogue(x, bn, False, residual, down), want)
    # the layout does not decide: on the GPU the kernel raises on one it
    # cannot take
    assert te.engages(x, bn, False, residual, down) == (dtype == torch.float32)


def _engagement(case: str):
    """(layer inputs for ``engages``, grad mode, whether it engages)."""
    x, bn, residual, down = _layer_inputs("downsample", torch.float32, True)
    if case == "running_stats_no_grad":
        return (x, bn, False, residual, down), True, True
    if case == "params_require_grad_under_no_grad":
        bn.requires_grad_(True)
        return (x, bn, False, residual, down), False, True
    if case == "batch_stats":
        return (x, bn, True, residual, down), False, False
    if case == "folded_bn":
        folded = (x, fpn.FoldedBN(), False, residual, (down[0], fpn.FoldedBN()))
        return folded, False, False
    if case == "down_bn_requires_grad":
        down[1].requires_grad_(True)
        return (x, bn, False, residual, down), True, False
    if case == "input_requires_grad":
        return (x.requires_grad_(True), bn, False, residual, down), True, False
    if case == "bf16_input":
        return (x.bfloat16(), bn, False, residual, down), False, False
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "running_stats_no_grad", "params_require_grad_under_no_grad",
    "batch_stats", "folded_bn", "down_bn_requires_grad",
    "input_requires_grad", "bf16_input"])
def test_engagement_rule(case):
    args, grad, want = _engagement(case)
    with torch.set_grad_enabled(grad):
        assert te.engages(*args) == want


def test_registered_op_shape_function():
    assert te.trunk_epilogue._opoverload is torch.ops.mpn.trunk_epilogue.default
    for case in ("inner", "identity", "downsample"):
        x, bn, residual, down = _layer_inputs(case, torch.float32, True, seed=3)
        torch.library.opcheck(torch.ops.mpn.trunk_epilogue.default,
                              tuple(_op_args(x, bn, residual, down)))
    meta = torch.empty(2, 8, 3, 5, device="meta").contiguous(
        memory_format=torch.channels_last)
    c = torch.empty(8, device="meta")
    y = te.trunk_epilogue(meta, c, c, c, c, 1e-5, meta)
    assert y.shape == meta.shape and y.device.type == "meta"
    assert y.stride() == meta.stride()


def _config(backbone: str, **model) -> Config:
    return Config(model=ModelConfig(backbone=backbone, **model),
                  data=DataConfig(inp_size=SIZE))


def _batch(stage: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    image = torch.from_numpy(rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8))
    if stage == "keypoint":
        joints = np.full((B, 3, 18, 3), 2.0, np.float32)
        joints[:, 0, :, :2] = rng.uniform(0, SIZE, (B, 18, 2))
        joints[:, 0, :, 2] = rng.randint(0, 2, (B, 18))
        return {"image": image, "joints": torch.from_numpy(joints),
                "mask": torch.from_numpy(rng.rand(B, SIZE // 4, SIZE // 4)
                                         .astype(np.float32))}
    boxes = np.full((B, 4, 5), -1.0, np.float32)
    boxes[0, 0] = [5, 5, 40, 50, 0]
    return {"image": image, "boxes": torch.from_numpy(boxes)}


def _train_step(backbone: str, stage: str):
    cfg = _config(backbone)
    model = build_trainable_posenet(cfg.model, torch.device("cpu"), seed=0)
    state = tts.create_train_state(cfg, stage, model=model)
    step, _ = tts.STEP_FACTORIES[stage](cfg, device="cpu")
    return lambda: step(state, _batch(stage), 1e-4)


def _forward(backbone: str, **model):
    """A detection forward of a model whose parameters all require grad,
    with autograd on (``requires_grad``) or under ``no_grad``."""
    grad = model.pop("requires_grad", False)
    net = build_trainable_posenet(ModelConfig(backbone=backbone, **model),
                                  torch.device("cpu"), seed=0)
    img = torch.rand(B, SIZE, SIZE, 3)

    def run():
        with torch.set_grad_enabled(grad):
            return net.detection_forward(img)
    return run


# path -> (how to run it once, dispatches of mpn::trunk_epilogue it makes)
DISPATCH_CASES = {
    # 1 (stem) + 16 blocks x 3 and 1 + 33 x 3: a frozen trunk, autograd on
    "resnet50_detection_step": (lambda: _train_step("resnet50", "detection"), 49),
    "resnet101_detection_step": (lambda: _train_step("resnet101", "detection"), 100),
    # BatchNorm on batch statistics
    "keypoint_step": (lambda: _train_step("resnet50", "keypoint"), 0),
    # the convs' outputs are bf16
    "bf16_autocast_forward": (lambda: _forward(
        "resnet50", compute_dtype=torch.bfloat16), 0),
    # autograd records the trunk
    "trunk_requires_grad": (lambda: _forward("resnet50", requires_grad=True), 0),
}


@pytest.mark.parametrize("path", list(DISPATCH_CASES))
def test_trunk_epilogue_dispatches(path, monkeypatch):
    make, want = DISPATCH_CASES[path]
    run = make()
    calls = []

    def launcher(*args):
        # stands in for the kernel: the count is that of the GPU's launches
        calls.append(args[0].shape)
        return te.trunk_epilogue_plain(*args)

    monkeypatch.setattr(te, "trunk_epilogue", launcher)
    run()
    assert len(calls) == want


class _Detect(torch.nn.Module):
    def __init__(self, model: PoseNet):
        super().__init__()
        self.model = model

    def forward(self, img):
        return self.model.detection_forward(img)


def test_export_traces_through_the_operator():
    net = build_trainable_posenet(ModelConfig(backbone="resnet50"),
                                  torch.device("cpu"), seed=0).requires_grad_(False)
    img = torch.rand(B, SIZE, SIZE, 3)
    program = torch.export.export(_Detect(net), (img,), strict=False)
    # the forward sits in the autocast region's own graph
    targets = [n.target for m in program.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes]
    assert targets.count(torch.ops.mpn.trunk_epilogue.default) == 49
    assert not any("batch_norm" in str(t) for t in targets)
    got = program.module()(img)
    want = net.detection_forward(img)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
