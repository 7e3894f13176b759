"""PoseNet — the three-subnet model, PyTorch twin of
multiposenet_tpu/models/posenet.py.

Public methods take and return the JAX package's layouts: NHWC images,
(B, H/4, W/4, 18) heatmaps, (B, A, 1) / (B, A, 4) detection outputs and
(B, gh, gw, 17) PRN grids.  Inside, convs run NCHW (``channels_last`` memory
format makes the boundary permutes free).  With ``compute_dtype=bfloat16``
the forwards run under bf16 autocast; parameters stay float32.

The keypoint-head convs are registered directly on PoseNet, as the
reference poseNet holds them (reference posenet.py:162-187), so the
``state_dict`` keys are the reference's: ``convfin_k2.weight``,
``fpn.layer3.22.downsample.0.weight``, ``regressionModel.output.bias``,
``prn.dens1.weight``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from multiposenet_tpu_torch.config import ModelConfig
from multiposenet_tpu_torch.models.fpn import ResNetFPN
from multiposenet_tpu_torch.models.subnets import (
    ClassificationHead,
    KeypointHead,
    PRN,
    RegressionHead,
)

BLOCK_COUNTS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
# compute dtypes that run under autocast; any other runs in the parameters'
# own dtype
REDUCED_DTYPES = (torch.bfloat16, torch.float16)


def _nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class PoseNet(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.fpn = ResNetFPN(BLOCK_COUNTS[cfg.backbone], cfg.fpn_channels,
                             cfg.fold_bn)
        head = KeypointHead(cfg.num_joints, cfg.num_interm_channels,
                            cfg.keypoint_mid_channels, cfg.fpn_channels)
        # register the head's convs flat on PoseNet (reference key names);
        # the head object itself stays unregistered and shares them
        for name, mod in head.named_children():
            self.add_module(name, mod)
        self.__dict__["keypoint_head"] = head
        self.regressionModel = RegressionHead(cfg.num_anchors, cfg.fpn_channels)
        self.classificationModel = ClassificationHead(
            cfg.num_anchors, cfg.num_classes, cfg.fpn_channels)
        self.prn = PRN(cfg.prn_node_count, cfg.prn_coeff, cfg.prn_dropout)
        self.eval()

    def _autocast(self, x: torch.Tensor):
        return torch.autocast(x.device.type, dtype=self.cfg.compute_dtype,
                              enabled=self.cfg.compute_dtype in REDUCED_DTYPES)

    # ---- parameter init -------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         head_output_std: float = 0.0) -> "PoseNet":
        """Torch-native init mirroring the JAX distributions: every conv
        N(0, 0.01) with zero bias, the detection heads' output convs zero
        (classifier bias at the focal prior), BN the identity, Linear layers
        LeCun-normal truncated at two standard deviations with zero bias.

        ``head_output_std > 0`` draws the detection output convs from
        N(0, head_output_std) instead of zeros, so a random model's scores
        and boxes vary between anchors.
        """
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                nn.init.normal_(mod.weight, 0.0, 0.01, generator=generator)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
            elif isinstance(mod, nn.Linear):
                # flax lecun_normal: truncated normal, variance 1/fan_in
                std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(mod.bias)
        for out in (self.regressionModel.output, self.classificationModel.output):
            if head_output_std > 0:
                nn.init.normal_(out.weight, 0.0, head_output_std,
                                generator=generator)
            else:
                nn.init.zeros_(out.weight)
        prior = self.cfg.prior
        nn.init.constant_(self.classificationModel.output.bias,
                          -math.log((1.0 - prior) / prior))
        return self

    # ---- per-subnet forwards (NHWC in, NHWC out) -------------------------

    def _features(self, img: torch.Tensor, detection: bool = True,
                  train: bool = False):
        # the image takes the parameters' dtype (float64 in the parity
        # tests' exact-arithmetic runs); under autocast that is float32
        x = _nhwc_to_nchw(img).to(self.fpn.conv1.weight.dtype)
        return self.fpn(x, detection, train)

    def _detect(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        reg = torch.cat([self.regressionModel(f) for f in feats.detection], 1)
        cls = torch.cat([self.classificationModel(f) for f in feats.detection], 1)
        return cls, reg

    def keypoint_forward(self, img: torch.Tensor, train: bool = False
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(B,H,W,3) -> heatmaps (B,H/4,W/4,18) + 5 saved_for_loss tensors.
        The detection pyramid is not computed.  ``train=True`` runs the
        trunk's BatchNorms on batch statistics and updates their running
        statistics (the keypoint train step)."""
        with self._autocast(img):
            predict, saved = self.keypoint_head(
                self._features(img, detection=False, train=train).keypoint)
        return _nchw_to_nhwc(predict), [_nchw_to_nhwc(s) for s in saved]

    def detection_forward(self, img: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,H,W,3) -> (classification (B,A,C), regression (B,A,4)).
        BatchNorm always runs on running statistics here, in training too
        (the reference freezes BN outside the keypoint stage,
        trainer.py:172-174)."""
        with self._autocast(img):
            return self._detect(self._features(img))

    def prn_forward(self, grid: torch.Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """(B, gh, gw, 17) -> same-shaped softmax grid; ``train=True``
        applies dropout with masks drawn from ``generator`` for slice
        ``shard`` of the global batch (``subnets.dropout``)."""
        with self._autocast(grid):
            return self.prn(grid, self.cfg.compute_dtype, train, generator,
                            shard)

    def full_forward(self, img: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Shared-backbone inference: heatmaps + raw detection outputs."""
        with self._autocast(img):
            feats = self._features(img)
            predict, _ = self.keypoint_head(feats.keypoint)
            cls, reg = self._detect(feats)
        return _nchw_to_nhwc(predict), cls, reg

    def forward(self, img: torch.Tensor):
        return self.full_forward(img)


def build_trainable_posenet(cfg: ModelConfig, device: torch.device,
                            state_dict: Optional[dict] = None, seed: int = 0,
                            head_output_std: float = 0.0) -> PoseNet:
    """A PoseNet on ``device`` with every parameter requiring grad: weights
    from ``state_dict`` (loaded strictly: a folded one into the
    ``cfg.fold_bn`` graph) or drawn from ``seed``.  On a
    CUDA device the model is kept in ``channels_last`` memory format.  The
    train steps pick the stage's trainable subset
    (engine/train_steps.create_train_state)."""
    model = PoseNet(cfg)
    if state_dict is None:
        model.reset_parameters(torch.Generator().manual_seed(seed),
                               head_output_std)
    else:
        model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def build_posenet(cfg: ModelConfig, device: torch.device,
                  state_dict: Optional[dict] = None, seed: int = 0,
                  head_output_std: float = 0.0) -> PoseNet:
    """The serving model: ``build_trainable_posenet`` in eval mode with
    every parameter frozen (``requires_grad_(False)``)."""
    model = build_trainable_posenet(cfg, device, state_dict, seed,
                                    head_output_std)
    return model.eval().requires_grad_(False)
