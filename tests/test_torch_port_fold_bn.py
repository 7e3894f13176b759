"""multiposenet_tpu_torch BN folding (models/fold_bn.py and the fold_bn=True
graph) against the JAX package's: the folded state dict bit for bit, the
folded forwards within JAX's own bounds (tests/test_fold_bn.py), strict
loading, and training refused.  CPU, float32, resnet50 at 64 px."""

import dataclasses
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiposenet_tpu.config import Config as JConfig
from multiposenet_tpu.models.fold_bn import fold_bn_variables
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch.config import ModelConfig
from multiposenet_tpu_torch.models.fold_bn import fold_bn_state_dict
from multiposenet_tpu_torch.models.posenet import PoseNet, build_posenet
from multiposenet_tpu_torch.weights import state_dict_from_flax
from test_fold_bn import _randomize_bn

SIZE = 64
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    jcfg = JConfig()
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, backbone="resnet50"))
    jm = JPoseNet(jcfg.model)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                jnp.zeros((1, 56, 36, 17)), method=JPoseNet.init_all)
    v = jax.tree_util.tree_map(np.array, jax.device_get(_randomize_bn(v)))
    # the detection output convs start at zero: draw them, so that cls and
    # reg vary between anchors
    rng = np.random.RandomState(5)
    for head in ("regression_head", "classification_head"):
        k = v["params"][head]["output"]["kernel"]
        v["params"][head]["output"]["kernel"] = (
            rng.randn(*k.shape) * 0.01).astype(np.float32)
    jfm = JPoseNet(dataclasses.replace(jcfg.model, fold_bn=True))
    jfv = fold_bn_variables(v)
    sd = state_dict_from_flax(v)
    folded = fold_bn_state_dict(sd)
    cfg = ModelConfig(backbone="resnet50")
    model = build_posenet(cfg, CPU, sd)
    fmodel = build_posenet(dataclasses.replace(cfg, fold_bn=True), CPU, folded)
    return jm, v, jfm, jfv, sd, folded, model, fmodel


def images(seed: int, n: int) -> np.ndarray:
    return (np.random.RandomState(seed).rand(n, SIZE, SIZE, 3) * 255
            ).astype(np.float32)


def test_fold_equals_jax_bit_for_bit(pair):
    _, _, _, jfv, sd, folded, _, _ = pair
    want = state_dict_from_flax(jfv)
    assert set(folded) == set(want)
    for k, w in want.items():
        assert folded[k].dtype == w.dtype == torch.float32, k
        assert torch.equal(folded[k], w), k
    # every trunk BN key went, num_batches_tracked included; each trunk conv
    # gained a bias; every key outside the trunk passed through as it was
    trunk_bn = re.compile(r"^fpn\.(layer\d\.\d+\.)?(bn\d|downsample\.1)\.")
    assert not any(trunk_bn.match(k) for k in folded)
    n_bn = sum(k.endswith("running_mean") for k in sd)
    assert n_bn == 53 and sum(bool(trunk_bn.match(k)) for k in sd) == 5 * n_bn
    assert len(folded) == len(sd) - 4 * n_bn
    untouched = [k for k in sd if not k.startswith("fpn.")]
    assert untouched and all(folded[k] is sd[k] for k in untouched)


def test_folded_state_dict_loads_strictly(pair):
    _, _, _, _, sd, folded, _, _ = pair
    cfg = ModelConfig(backbone="resnet50")
    result = PoseNet(dataclasses.replace(cfg, fold_bn=True)).load_state_dict(
        folded, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # load_state_dict copies the keys that match before it raises, so each
    # mismatch is tried on a model of its own
    with pytest.raises(RuntimeError, match="Missing key"):
        PoseNet(dataclasses.replace(cfg, fold_bn=True)).load_state_dict(sd)
    with pytest.raises(RuntimeError, match="Missing key"):
        PoseNet(cfg).load_state_dict(folded)


def test_folded_full_forward_matches_jax(pair):
    _, _, jfm, jfv, _, _, model, fmodel = pair
    img = images(1, 2)
    jheat, jcls, jreg = (np.asarray(t) for t in jfm.apply(
        jfv, jnp.asarray(img), method=JPoseNet.full_forward))
    with torch.no_grad():
        heat, cls, reg = (t.numpy() for t in fmodel.full_forward(
            torch.from_numpy(img)))
        uheat, ucls, ureg = (t.numpy() for t in model.full_forward(
            torch.from_numpy(img)))
    # JAX's own bounds between its folded and unfolded forwards
    # (tests/test_fold_bn.py): float reassociation only
    assert np.ptp(jcls) > 1e-3 and np.ptp(jreg) > 1e-2
    for got in ((heat, cls, reg), (uheat, ucls, ureg)):
        np.testing.assert_allclose(got[0], jheat, rtol=0, atol=2e-4)
        np.testing.assert_allclose(got[1], jcls, rtol=0, atol=2e-4)
        np.testing.assert_allclose(got[2], jreg, rtol=0, atol=2e-3)


def test_folded_keypoint_forward_matches_jax(pair):
    _, _, jfm, jfv, _, _, _, fmodel = pair
    img = images(2, 1)
    jheat, _ = jfm.apply(jfv, jnp.asarray(img), method=JPoseNet.keypoint_forward)
    with torch.no_grad():
        heat, saved = fmodel.keypoint_forward(torch.from_numpy(img))
    assert len(saved) == 5
    np.testing.assert_allclose(heat.numpy(), np.asarray(jheat), rtol=0,
                               atol=2e-4)


def test_folded_graph_refuses_training(pair):
    fmodel = pair[-1]
    img = torch.zeros(1, SIZE, SIZE, 3)
    with pytest.raises(RuntimeError, match="inference-only"):
        fmodel.keypoint_forward(img, train=True)


def test_fold_refuses_unpaired_bn_and_biased_conv(pair):
    sd = pair[4]
    no_conv = {k: v for k, v in sd.items() if k != "fpn.layer1.0.conv2.weight"}
    with pytest.raises(ValueError, match="no paired conv 'fpn.layer1.0.conv2'"):
        fold_bn_state_dict(no_conv)
    biased = dict(sd)
    biased["fpn.layer2.0.downsample.0.bias"] = torch.zeros(512)
    with pytest.raises(ValueError, match="downsample.0' already has a bias"):
        fold_bn_state_dict(biased)
