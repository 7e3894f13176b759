"""multiposenet_tpu_torch model and weights bridge against the JAX model,
on the CPU in float32.

A JAX ``PoseNet.init_all`` tree (detection output convs and the stem's BN
statistics perturbed, so every tensor carries signal) crosses into the port
through ``weights.state_dict_from_flax``; both models then run the same
numpy inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiposenet_tpu.config import ModelConfig as JModelConfig
from multiposenet_tpu.models.fpn import upsample_nearest as j_upsample_nearest
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch.config import ModelConfig
from multiposenet_tpu_torch.models.fpn import upsample_nearest
from multiposenet_tpu_torch.models.posenet import PoseNet, build_posenet
from multiposenet_tpu_torch.weights import state_dict_from_flax

# 100 px: the FPN's c2..c5 are 25, 13, 7, 4 wide, so every top-down merge
# takes the non-integer nearest-upsample branch
SIZE = 100


def perturbed_init(backbone: str, size: int, seed: int = 0):
    """JAX init_all tree as numpy, with the zero-initialised detection
    output convs and the stem BN statistics drawn at random."""
    jm = JPoseNet(JModelConfig(backbone=backbone))
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
                jnp.zeros((1, 56, 36, 17)), method=JPoseNet.init_all)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    rng = np.random.RandomState(seed)
    for head in ("regression_head", "classification_head"):
        k = v["params"][head]["output"]["kernel"]
        v["params"][head]["output"]["kernel"] = (
            rng.randn(*k.shape) * 0.01).astype(np.float32)
    bn = v["batch_stats"]["fpn"]["bn1"]
    bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.1).astype(np.float32)
    bn["var"] = (1.0 + rng.rand(*bn["var"].shape)).astype(np.float32)
    return jm, v


@pytest.fixture(scope="module")
def models():
    jm, v = perturbed_init("resnet50", SIZE)
    tm = PoseNet(ModelConfig(backbone="resnet50"))
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, tm.requires_grad_(False)


def _assert_close(got: torch.Tensor, want, name: str):
    # f32 convolutions sum in another order on PyTorch's CPU backend than in
    # XLA: measured ~3e-6 of each tensor's largest magnitude; bound 2e-5
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0, name
    err = float(np.abs(got - want).max())
    assert err <= 2e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_flax_tree_loads_strict(backbone, models):
    if backbone == "resnet50":
        v = models[1]
    else:
        shapes = jax.eval_shape(
            lambda: JPoseNet(JModelConfig(backbone=backbone)).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                jnp.zeros((1, 56, 36, 17)), method=JPoseNet.init_all))
        v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = state_dict_from_flax(v)
    tm = PoseNet(ModelConfig(backbone=backbone))
    result = tm.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(tm.state_dict())
    n_l3 = {"resnet50": 6, "resnet101": 23}[backbone]
    assert f"fpn.layer3.{n_l3 - 1}.downsample.0.weight" not in sd
    assert f"fpn.layer3.{n_l3 - 1}.conv3.weight" in sd
    for key in ("fpn.layer3.0.downsample.0.weight", "regressionModel.conv1.weight",
                "convfin_k2.weight", "prn.dens1.weight"):
        assert key in sd


def test_full_forward_matches_jax(models):
    jm, v, tm = models
    img = np.random.RandomState(1).randn(2, SIZE, SIZE, 3).astype(np.float32)
    jh, jc, jr = jm.apply(v, jnp.asarray(img), method=JPoseNet.full_forward)
    th, tc, tr = tm.full_forward(torch.from_numpy(img))
    _assert_close(th, jh, "heatmaps")
    _assert_close(tc, jc, "cls")
    _assert_close(tr, jr, "reg")
    assert tc.shape[1] == 9 * (13 * 13 + 7 * 7 + 4 * 4 + 2 * 2 + 1)


def test_keypoint_forward_saved_for_loss_match_jax(models):
    jm, v, tm = models
    img = np.random.RandomState(2).randn(1, SIZE, SIZE, 3).astype(np.float32)
    jk, jsaved = jm.apply(v, jnp.asarray(img), False,
                          method=JPoseNet.keypoint_forward)
    tk, tsaved = tm.keypoint_forward(torch.from_numpy(img))
    _assert_close(tk, jk, "heatmaps")
    assert len(tsaved) == len(jsaved) == 5
    for i, (t, j) in enumerate(zip(tsaved, jsaved)):
        _assert_close(t, j, f"saved_for_loss[{i}]")


def test_prn_forward_matches_jax(models):
    jm, v, tm = models
    grid = np.random.RandomState(3).rand(3, 56, 36, 17).astype(np.float32)
    jp = jm.apply(v, jnp.asarray(grid), method=JPoseNet.prn_forward)
    tp = tm.prn_forward(torch.from_numpy(grid))
    _assert_close(tp, jp, "prn")
    np.testing.assert_allclose(tp.reshape(3, -1).sum(1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((3, 5), (12, 15)),
                                     ((4, 4), (7, 7)), ((7, 4), (13, 25)),
                                     ((13, 13), (25, 25)), ((2, 3), (2, 7))])
def test_upsample_nearest_equals_jax(src, dst):
    x = np.random.RandomState(4).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(j_upsample_nearest(jnp.asarray(x), dst))
    got = upsample_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_torch_native_init_distributions():
    cfg = ModelConfig(backbone="resnet50")
    m = build_posenet(cfg, torch.device("cpu"), seed=0)
    again = build_posenet(cfg, torch.device("cpu"), seed=0)
    for (k, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k                   # seeded: reproducible
    w = m.fpn.layer3[0].conv2.weight
    assert abs(float(w.std()) - 0.01) < 1e-3
    assert not m.regressionModel.output.weight.any()
    assert not m.classificationModel.output.weight.any()
    np.testing.assert_allclose(m.classificationModel.output.bias.numpy(),
                               -np.log(0.99 / 0.01), rtol=1e-6)
    d1 = m.prn.dens1.weight
    lim = 2 * np.sqrt(1.0 / d1.shape[1]) / 0.87962566103423978
    assert float(d1.abs().max()) <= lim + 1e-9
    assert not m.training
    varied = build_posenet(cfg, torch.device("cpu"), seed=0, head_output_std=0.01)
    assert float(varied.classificationModel.output.weight.std()) > 0.005
