"""Per-stage train and val steps — PyTorch twin of
multiposenet_tpu/engine/train_steps.py.

The reference runs one Python loop of zero_grad/backward/clip/step for all
three stages (reference training/trainer.py:233-283).  Here each stage has
a factory that returns ``(train_step, val_step)``:

  keypoint stage : image + padded joints + stride-4 mask; the heatmap
                   targets are built on the device inside the step
                   (ops/heatmap.py); BatchNorm runs on batch statistics
                   and updates its running ones (reference
                   trainer.py:172-174 trains BN in this stage)
  detection stage: image + padded GT boxes; BN on running statistics
  prn stage      : sparse one-hot marks -> gaussian grids on the device

Freezing is the reference's ``requires_grad`` loops (multipose_*_train.py):
a stage's frozen parameters do not require grad, so they get no gradient
and autograd records nothing that only they need (the detection stage does
not backpropagate through the ResNet trunk), and the optimizer holds only
the trainable ones, so frozen parameters carry no optimizer state — the
JAX package's ``optax.masked`` plus its frozen-leaf skip.  The learning
rate is an argument of each train step, which the host-side plateau
scheduler sets.  A step updates the state in place and returns its logs as
0-d tensors on the device, so the caller decides when to wait for them.

Several processes (parallel/distributed.py): inside a process group each
train step runs its stage's loss through ``DistributedDataParallel``, which
averages the trainable gradients over the processes during the backward.
Each process's batch is its equal share of the global batch and every loss
is a mean over equal local batches (the detection loss is normalised per
image, then averaged), so the averaged gradient is the global batch's, as
under the JAX package's batch-sharded ``jit``; the trunk BatchNorm of the
keypoint stage takes global-batch statistics (the step switches that on
with models/fpn.use_global_batch_stats when it wraps the model), and
the PRN dropout masks are drawn for the global batch (models/subnets.dropout).
The inf-norm clip runs on the averaged gradients.  A train step's logs are
this process's; a val step's are the mean over the processes, so that every
process's plateau scheduler decides alike.

Spans (utils/trace.py): each train step runs inside ``train.step``, whose
id is the state's step number, and its phases inside spans of the same
names in every stage: ``train.upload``, ``train.targets`` (the keypoint
heatmaps, the PRN's blurred grids; the detection stage has none),
``train.forward`` (the preprocessing and the stage's forward),
``train.loss``, ``train.backward`` and ``train.optimizer``.  A span times
the host's enqueue of its phase, not the device's work.  Val steps open no
span.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from multiposenet_tpu_torch.config import Config, resolve_device
from multiposenet_tpu_torch.engine.inference import (
    full_fp32_matmul,
    preprocess_on_device,
)
from multiposenet_tpu_torch.models.fpn import use_global_batch_stats
from multiposenet_tpu_torch.models.posenet import PoseNet, build_trainable_posenet
from multiposenet_tpu_torch.ops.anchors import anchors_for_shape
from multiposenet_tpu_torch.ops.gaussian import gaussian_blur
from multiposenet_tpu_torch.ops.heatmap import make_heatmaps
from multiposenet_tpu_torch.ops.losses import detection_loss, keypoint_loss, prn_loss
from multiposenet_tpu_torch.parallel import distributed as pdist
from multiposenet_tpu_torch.utils import trace

# ---------------------------------------------------------------------------
# stage-wise trainability (reference training/multipose_*_train.py:32-89)
# ---------------------------------------------------------------------------

FPN_RESNET = ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")
FPN_RETINA = ("conv6", "conv7", "latlayer1", "latlayer2", "latlayer3",
              "toplayer0", "toplayer1", "toplayer2")
FPN_KEYPOINT = ("toplayer", "flatlayer1", "flatlayer2", "flatlayer3",
                "smooth1", "smooth2", "smooth3")
# the keypoint head's convs sit flat on PoseNet (reference key names)
KEYPOINT_HEAD = ("convfin_k2", "convfin_k3", "convfin_k4", "convfin_k5",
                 "convt1", "convt2", "convt3", "convt4",
                 "convs1", "convs2", "convs3", "convs4", "conv2", "convfin")


def param_group(key: str) -> str:
    """Map a ``state_dict`` key of PoseNet to its freeze group."""
    parts = key.split(".")
    top = parts[0]
    if top == "fpn":
        sub = parts[1]
        for names, group in ((FPN_RESNET, "fpn_resnet"), (FPN_RETINA, "fpn_retina"),
                             (FPN_KEYPOINT, "fpn_keypoint")):
            if sub in names:
                return group
        raise ValueError(f"unknown fpn submodule in {key!r}")
    if top in KEYPOINT_HEAD:
        return "keypoint"
    if top in ("regressionModel", "classificationModel"):
        return "retinanet"
    if top == "prn":
        return "prn"
    raise ValueError(f"unknown top-level module in {key!r}")


TRAINABLE_GROUPS = {
    # multipose_keypoint_train.py:77-89: freeze fpn_retina + retinanet + prn
    "keypoint": {"fpn_resnet", "fpn_keypoint", "keypoint"},
    # multipose_detection_train.py:64-79: freeze the trunk + keypoint parts + prn
    "detection": {"fpn_retina", "retinanet"},
    # multipose_prn_train.py:56-59: freeze everything but prn
    "prn": {"prn"},
}


def is_trainable(key: str, subnet: str) -> bool:
    return param_group(key) in TRAINABLE_GROUPS[subnet]


# ---------------------------------------------------------------------------
# optimizer and state
# ---------------------------------------------------------------------------

def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """The JAX chain ``[inf-norm clip] -> scale_by_adam -> [+ wd * p]``,
    applied as ``p -= lr * update``: Adam (b1 0.9, b2 0.999, eps 1e-8) with
    the weight decay added after Adam's scaling, which is AdamW's rule
    (``torch.optim.Adam(weight_decay=...)`` would add it to the gradient).
    'sgd' is ``optax.trace(0.9)``: momentum 0.9, no dampening, no decay.
    The clip is not part of the optimizer: the train step clips the
    trainable gradients before ``step()``."""
    params = list(params)
    tc = cfg.train
    if tc.optimizer == "adam":
        # the fused CUDA kernel, for the float32 training default
        fused = bool(params) and params[0].is_cuda and params[0].dtype == torch.float32
        return torch.optim.AdamW(params, lr=tc.init_lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=tc.weight_decay,
                                 fused=fused or None)
    if tc.optimizer == "sgd":
        return torch.optim.SGD(params, lr=tc.init_lr, momentum=0.9)
    raise ValueError(cfg.train.optimizer)


@dataclasses.dataclass
class TrainState:
    """The model, the optimizer over the stage's trainable parameters and
    the number of steps taken.  Train steps update it in place."""
    model: PoseNet
    optimizer: torch.optim.Optimizer
    subnet: str
    step: int = 0

    def trainable_parameters(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]


def create_train_state(cfg: Config, subnet: Optional[str] = None,
                       model: Optional[PoseNet] = None, device=None
                       ) -> TrainState:
    """A train state for ``subnet`` (default ``cfg.train.subnet``): the given
    model (moved to ``device`` if one is named), or one drawn from
    ``cfg.train.seed`` on ``device``, with only the stage's groups
    requiring grad."""
    subnet = subnet or cfg.train.subnet
    if subnet not in TRAINABLE_GROUPS:
        raise ValueError(f"unknown subnet {subnet!r}")
    if model is None:
        model = build_trainable_posenet(cfg.model, resolve_device(device),
                                        seed=cfg.train.seed)
    elif device is not None:
        model = model.to(resolve_device(device))
    trainable = []
    for key, p in model.named_parameters():
        keep = is_trainable(key, subnet)
        p.requires_grad_(keep)
        if keep:
            trainable.append(p)
    return TrainState(model=model, optimizer=make_optimizer(cfg, trainable),
                      subnet=subnet)


def _apply_updates(state: TrainState, loss: torch.Tensor, lr: float,
                   max_grad_norm: Optional[float]) -> None:
    """Backward, the inf-norm clip over the trainable grads, one optimizer
    step at ``lr``.  ``clip_grad_norm_`` with ``norm_type=inf`` scales every
    grad by ``min(max_norm / (max |g| + 1e-6), 1)``, the JAX clip's
    coefficient (reference trainer.py:255-256)."""
    opt = state.optimizer
    with trace.span("train.backward"):
        opt.zero_grad(set_to_none=True)
        loss.backward()
    with trace.span("train.optimizer"):
        if max_grad_norm:
            torch.nn.utils.clip_grad_norm_(state.trainable_parameters(),
                                           max_grad_norm, norm_type=math.inf)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    state.step += 1


def _on_device(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _upload(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    """A train step's batch on ``device``, in the ``train.upload`` span."""
    with trace.span("train.upload"):
        return _on_device(batch, device)


def _phase(name: str, train: bool):
    """The span ``name`` in a train step; no span in a val step."""
    return trace.span(name) if train else contextlib.nullcontext()


def _logs(logs: Dict[str, torch.Tensor], loss: torch.Tensor
          ) -> Dict[str, torch.Tensor]:
    out = {k: v.detach() for k, v in logs.items()}
    out["loss"] = loss.detach()
    return out


def _global_mean(logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A val step's logs averaged over the process group (one all-reduce);
    as they are outside one."""
    if not pdist.is_active():
        return logs
    keys = list(logs)
    dt = torch.promote_types(logs["loss"].dtype, torch.float32)
    packed = torch.stack([logs[k].to(dt) for k in keys])
    tdist.all_reduce(packed)
    packed /= pdist.process_count()
    return dict(zip(keys, packed.unbind()))


class _StageLoss(nn.Module):
    """A stage's loss computation as a module's ``forward``.
    ``DistributedDataParallel`` hooks ``forward`` alone, and the steps call
    stage methods (``keypoint_forward``, ``prn_forward``, ...), so this is
    what it wraps."""

    def __init__(self, model: PoseNet, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *args):
        return self.loss_fn(self.model, *args)


class _TrainLoss:
    """A train step's way to its loss: ``loss_fn(model, *args)`` in one
    process; inside a process group, the same through
    ``DistributedDataParallel`` around ``_StageLoss``, built once per model.
    Every trainable parameter of each stage reaches its loss, so
    ``find_unused_parameters`` is off; frozen parameters do not require
    grad, so DDP leaves them out; the buffers are not broadcast at each
    forward, because the global BatchNorm statistics, which this switches
    on for the model's BatchNorm layers, keep them equal."""

    def __init__(self, loss_fn: Callable, device: torch.device):
        self.loss_fn = loss_fn
        self.device = device
        self._model: Optional[PoseNet] = None
        self._ddp: Optional[DistributedDataParallel] = None

    def __call__(self, model: PoseNet, *args):
        if not pdist.is_active():
            return self.loss_fn(model, *args)
        if self._model is not model:
            use_global_batch_stats(model)
            self._ddp = DistributedDataParallel(
                _StageLoss(model, self.loss_fn),
                device_ids=[self.device.index] if self.device.type == "cuda" else None,
                broadcast_buffers=False, find_unused_parameters=False)
            self._model = model
        return self._ddp(*args)


# ---------------------------------------------------------------------------
# keypoint stage
# ---------------------------------------------------------------------------

def make_keypoint_steps(cfg: Config, device=None):
    """Returns (train_step, val_step).

    batch = {
      'image':  (B, H, W, 3) uint8 RGB (augmented on the host)
      'joints': (B, maxP, 18, 3) float32, augmented joints, pad rows v=2
      'mask':   (B, H/4, W/4) float32 mask_miss in [0, 1]
    }
    ``train_step(state, batch, lr) -> (state, logs)``;
    ``val_step(state, batch) -> logs`` (BN on running statistics).
    """
    device = resolve_device(device)
    stride = cfg.data.feat_stride
    num_j = cfg.model.num_joints
    sigma = cfg.data.sigma

    def loss_from_batch(model, batch, train: bool):
        with _phase("train.targets", train):
            gh, gw = batch["image"].shape[1] // stride, batch["image"].shape[2] // stride
            heat = make_heatmaps(batch["joints"], gh, gw, stride, sigma)
            mask = batch["mask"].float()
            hmask = mask[..., None].expand(*mask.shape, num_j)
        with _phase("train.forward", train):
            imgs = preprocess_on_device(batch["image"])
            _, saved = model.keypoint_forward(imgs, train=train)
        with _phase("train.loss", train):
            return keypoint_loss(saved, heat, hmask, num_j)

    train_loss = _TrainLoss(loss_from_batch, device)

    def train_step(state: TrainState, batch, lr: float):
        with trace.span("train.step", state.step):
            loss, logs = train_loss(state.model, _upload(batch, device), True)
            _apply_updates(state, loss, lr, cfg.train.max_grad_norm)
        return state, _logs(logs, loss)

    @torch.no_grad()
    def val_step(state: TrainState, batch):
        loss, logs = loss_from_batch(state.model, _on_device(batch, device), False)
        return _global_mean(_logs(logs, loss))

    return train_step, val_step


# ---------------------------------------------------------------------------
# detection stage
# ---------------------------------------------------------------------------

def make_detection_steps(cfg: Config, device=None):
    """batch = {'image': (B, S, S, 3) uint8 with S = ``cfg.data.inp_size``,
    'boxes': (B, N, 5) float32, x1y1x2y2 + class, pad rows -1}.  Steps as
    ``make_keypoint_steps``."""
    device = resolve_device(device)
    hw = (cfg.data.inp_size, cfg.data.inp_size)
    anchors = torch.from_numpy(np.array(anchors_for_shape(hw, cfg.anchors))).to(device)
    det = cfg.detection
    loss_kw = dict(alpha=det.focal_alpha, gamma=det.focal_gamma,
                   pos_iou=det.pos_iou, neg_iou=det.neg_iou,
                   beta=det.smooth_l1_beta)

    def loss_from_batch(model, batch, train: bool):
        with _phase("train.forward", train):
            imgs = preprocess_on_device(batch["image"])
            cls, reg = model.detection_forward(imgs)
        with _phase("train.loss", train):
            return detection_loss(cls, reg, anchors, batch["boxes"].float(), **loss_kw)

    train_loss = _TrainLoss(loss_from_batch, device)

    def train_step(state: TrainState, batch, lr: float):
        with trace.span("train.step", state.step):
            loss, logs = train_loss(state.model, _upload(batch, device), True)
            _apply_updates(state, loss, lr, cfg.train.max_grad_norm)
        return state, _logs(logs, loss)

    @torch.no_grad()
    def val_step(state: TrainState, batch):
        loss, logs = loss_from_batch(state.model, _on_device(batch, device), False)
        return _global_mean(_logs(logs, loss))

    return train_step, val_step


# ---------------------------------------------------------------------------
# PRN stage
# ---------------------------------------------------------------------------

def make_prn_steps(cfg: Config, device=None):
    """batch = {'weights_marks': (B, gh, gw, 17) float32 one-hot marks of
    every person near the box, 'label_marks': (B, gh, gw, 17) float32
    one-hot marks of the box's own person}.

    The gaussian blurs that the reference runs per sample in its data
    workers (prn_data_pipeline.py:105-107: weights sigma 1 'nearest',
    labels sigma 2 'constant') run here on the device, batched, as the
    depthwise convolutions of ``ops.gaussian.gaussian_blur`` in float32
    with TF32 off.

    ``train_step(state, batch, lr, generator) -> (state, logs)``, with the
    dropout masks drawn from ``generator`` (the same seed in every process:
    each draws the global batch's masks and keeps its rows);
    ``val_step(state, batch)``.
    """
    device = resolve_device(device)

    def loss_from_batch(model, batch, train: bool, generator=None):
        with _phase("train.targets", train), full_fp32_matmul():
            grids = gaussian_blur(batch["weights_marks"], sigma=1.0, mode="nearest")
            labels = gaussian_blur(batch["label_marks"], sigma=2.0, mode="constant")
        with _phase("train.forward", train):
            shard = (pdist.process_index(), pdist.process_count())
            out = model.prn_forward(grids, train, generator, shard)
        with _phase("train.loss", train):
            return prn_loss(out, labels)

    train_loss = _TrainLoss(loss_from_batch, device)

    def train_step(state: TrainState, batch, lr: float,
                   generator: Optional[torch.Generator]):
        with trace.span("train.step", state.step):
            loss, logs = train_loss(state.model, _upload(batch, device),
                                    True, generator)
            _apply_updates(state, loss, lr, cfg.train.max_grad_norm)
        return state, _logs(logs, loss)

    @torch.no_grad()
    def val_step(state: TrainState, batch):
        loss, logs = loss_from_batch(state.model, _on_device(batch, device), False)
        return _global_mean(_logs(logs, loss))

    return train_step, val_step


STEP_FACTORIES: Dict[str, Callable] = {
    "keypoint": make_keypoint_steps,
    "detection": make_detection_steps,
    "prn": make_prn_steps,
}
