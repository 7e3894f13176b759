"""The reference finds its trunk by the configuration's ``backbone`` name
among the files of ``reference/trunks/``: a new trunk family is one new
file there, and the FPN's pyramids take their widths from it."""

import copy
import re
import textwrap

import pytest
import torch

from mpn_bench import checks, traffic, weights
from mpn_bench.reference import flops
from mpn_bench.reference import model as ref_model
from mpn_bench.tests import tiny

# two stages of plain convolutions, two outputs each, at strides 4-32 and
# with widths unlike a ResNet's
TOY_TRUNK = textwrap.dedent('''
    import torch.nn.functional as F
    from torch import nn

    from mpn_bench.reference import model as ref_model

    NAMES = ("toy-plain",)
    WIDTHS = (24, 40, 56, 72)


    def build(name):
        w2, w3, w4, w5 = WIDTHS
        modules = {
            "stage1": nn.Sequential(nn.Conv2d(3, w2, 3, stride=4, padding=1),
                                    nn.Conv2d(w2, w3, 3, stride=2, padding=1)),
            "stage2": nn.Sequential(nn.Conv2d(w3, w4, 3, stride=2, padding=1),
                                    nn.Conv2d(w4, w5, 3, stride=2, padding=1)),
        }
        return ref_model.Trunk(modules, run, WIDTHS)


    def run(fpn, x, q):
        feats = []
        for stage in (fpn.stage1, fpn.stage2):
            for conv in stage:
                x = F.relu(ref_model.conv(conv, x, q))
                feats.append(x)
        return feats
''')


@pytest.fixture
def toy_trunks(tmp_path, monkeypatch):
    (tmp_path / "toy.py").write_text(TOY_TRUNK)
    monkeypatch.setattr(ref_model, "TRUNKS_DIR", tmp_path)
    _, cfg, spec = tiny.cell("train")
    cfg = copy.deepcopy(cfg)
    cfg["backbone"] = "toy-plain"
    return cfg, spec


def test_a_new_trunk_needs_one_new_file(toy_trunks):
    cfg, spec = toy_trunks
    ref = ref_model.build(cfg, "meta")
    sd = ref.state_dict()
    assert list(sd)[:4] == ["fpn.stage1.0.weight", "fpn.stage1.0.bias",
                            "fpn.stage1.1.weight", "fpn.stage1.1.bias"]
    # each pyramid conv reads the trunk output that feeds it
    for name, cin in (("conv6", 72), ("latlayer1", 72), ("toplayer", 72),
                      ("latlayer2", 56), ("flatlayer1", 56), ("latlayer3", 40),
                      ("flatlayer2", 40), ("flatlayer3", 24)):
        assert sd[f"fpn.{name}.weight"].shape[1] == cin, name
    drawn = weights.make_state_dict(cfg, 2 ** 31 + 11, "cpu", "train_detection")
    assert list(drawn) == list(sd)
    assert all(drawn[k].shape == sd[k].shape for k in sd)
    assert flops.detection_step_flops(cfg, 3) == 3 * flops.detection_step_flops(cfg, 1) > 0
    dev = torch.device("cpu")
    batches = traffic.detection_pool(spec, 2 ** 31 + 11, cfg["train_detection"]["inp_size"],
                                     dev)[:2]
    out = checks.reference_steps(cfg, drawn, batches, dev, cfg["train_detection"]["init_lr"])
    assert len(out["losses"]) == 2 and all(map(torch.isfinite, map(torch.tensor,
                                                                    out["losses"])))
    # the trunk is frozen: only the RetinaNet pyramid and heads move
    assert not any(k.startswith("fpn.stage") for k in out["delta"])
    assert any(float(d.abs().max()) > 0 for d in out["delta"].values())


@pytest.mark.parametrize("toy", [True, False])
def test_an_unknown_backbone_names_the_ones_found(toy, request):
    if toy:
        cfg, _ = request.getfixturevalue("toy_trunks")
        found = "toy-plain"
    else:
        _, cfg, _ = tiny.cell("train")
        # every family that the trunks directory holds, whatever files a
        # later configuration adds there
        found = ", ".join(sorted(ref_model.families(ref_model.TRUNKS_DIR)))
        assert {"resnet50", "resnet101"} <= set(found.split(", "))
    with pytest.raises(ValueError, match=f"'resnet152'; found: {re.escape(found)}$"):
        ref_model.build(dict(cfg, backbone="resnet152"), "meta")
