"""Shared set-up of the multiposenet_tpu_torch parity tests: one random JAX
model whose weights the port loads, and matching configurations of both
packages at a small size."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from multiposenet_tpu.config import Config as JConfig
from multiposenet_tpu.config import DataConfig as JDataConfig
from multiposenet_tpu.config import ModelConfig as JModelConfig
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch.config import Config, ModelConfig
from multiposenet_tpu_torch.models.posenet import build_posenet
from multiposenet_tpu_torch.weights import state_dict_from_flax

# std of the detection output convs: a random trunk's detection features
# are ~1e-6, so at this std logits and box deltas are of order one, scores
# and boxes differ clearly between anchors, and ~50 of the 774 anchors of a
# 64 px image score above 0.05
HEAD_STD = 2e4

LOWERED = dict(score_thresh=0.05, test_score_thresh=0.1, max_detections=32,
               thre1=1e-6, max_peaks=8, max_people=8)


def perturbed_init(backbone: str, size: int, seed: int = 0,
                   head_std: float = 0.01):
    """JAX ``init_all`` tree as numpy, with the zero-initialised detection
    output convs drawn from N(0, head_std) and the stem BN statistics drawn
    at random, so every output carries signal."""
    jm = JPoseNet(JModelConfig(backbone=backbone))
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
                jnp.zeros((1, 56, 36, 17)), method=JPoseNet.init_all)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    rng = np.random.RandomState(seed)
    for head in ("regression_head", "classification_head"):
        k = v["params"][head]["output"]["kernel"]
        v["params"][head]["output"]["kernel"] = (
            rng.randn(*k.shape) * head_std).astype(np.float32)
    bn = v["batch_stats"]["fpn"]["bn1"]
    bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.1).astype(np.float32)
    bn["var"] = (1.0 + rng.rand(*bn["var"].shape)).astype(np.float32)
    return jm, v


def _lowered(cfg, model_cfg, size):
    lo = LOWERED
    return dataclasses.replace(
        cfg,
        model=model_cfg,
        eval=dataclasses.replace(cfg.eval, inp_size=size),
        detection=dataclasses.replace(
            cfg.detection, score_thresh=lo["score_thresh"],
            test_score_thresh=lo["test_score_thresh"],
            max_detections=lo["max_detections"]),
        # random-init heatmaps sit at ~±2e-5: threshold well below that
        peaks=dataclasses.replace(cfg.peaks, thre1=lo["thre1"],
                                  max_peaks_per_joint=lo["max_peaks"]),
        prn=dataclasses.replace(cfg.prn, max_people=lo["max_people"]),
    )


def jax_config(size: int) -> JConfig:
    cfg = _lowered(JConfig(), JModelConfig(backbone="resnet50"), size)
    return dataclasses.replace(cfg, data=JDataConfig(inp_size=size))


def port_config(size: int) -> Config:
    return _lowered(Config(), ModelConfig(backbone="resnet50"), size)


def port_model(v, cfg: Config):
    return build_posenet(cfg.model, torch.device("cpu"), state_dict_from_flax(v))


class ForwardStub:
    """Stands in for the JAX PoseNet inside a JAX pipeline: ``full_forward``
    returns given (heatmaps, cls, reg) and every other method runs the real
    model.  Lets the JAX post-processing run on exactly the tensors the
    port's post-processing is given."""

    def __init__(self, model: JPoseNet):
        self.model = model

    def apply(self, params, x, *args, method=None):
        if method is JPoseNet.full_forward:
            return params["heads"]
        return self.model.apply(params["v"], x, *args, method=method)
